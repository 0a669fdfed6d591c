"""Port parity for ``repro_torch.core`` and ``configs.tugemm_paper``: the
thermometer codes, ``tugemm`` with its stats, ``validate_range``, the
gate-level simulator copy, the latency/tiling/PPA copies, the energy report
and the stochastic uGEMM baseline, each against the reference's
``repro.core`` on the same numpy inputs (numpy seeds stated per test).

Integer results must be exact; the float models (PPA, latency, energy) run
the same float64 arithmetic in the same order and must be equal, the energy
report's totals to 1e-12 relative. The stochastic baseline draws its bits
from ``torch.Generator`` where the reference uses ``jax.random``, so it is
held statistically: both estimators unbiased within 3 sigma, RMS errors
within 20% of each other.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.configs.tugemm_paper import HW_CONFIGS as J_HW
from repro.core import cycle_sim as jsim
from repro.core import latency as jlat
from repro.core import tiling as jtil
from repro.quant.capture import CapturedGemm as JCapturedGemm
from repro_torch import core as tcore
from repro_torch.configs.tugemm_paper import HW_CONFIGS as T_HW
from repro_torch.core import cycle_sim as tsim
from repro_torch.core import latency as tlat
from repro_torch.core import tiling as ttil
from repro_torch.quant.capture import Capture, CapturedGemm

torch.set_float32_matmul_precision("highest")


def rand_int(rng, shape, w):
    lo, hi = -(2 ** (w - 1)), 2 ** (w - 1) - 1
    a = rng.integers(lo, hi + 1, size=shape).astype(np.int32)
    a.flat[0] = lo
    return a


def test_core_exports_the_reference_names():
    assert tcore.__all__ == jcore.__all__


# ---------------------------------------------------------------- encoding
@pytest.mark.parametrize("w", [2, 3, 4, 8])
def test_thermometer_codes_match_reference(w):
    x = rand_int(np.random.default_rng(w), (5, 7), w)
    jb, jn = jcore.thermometer_encode(jnp.asarray(x), w)
    tb, tn = tcore.thermometer_encode(torch.from_numpy(x), w)
    assert tb.dtype == torch.int8 and tb.shape == (5, 7, 2 ** (w - 1))
    np.testing.assert_array_equal(np.asarray(jb), tb.numpy())
    np.testing.assert_array_equal(np.asarray(jn), tn.numpy())
    np.testing.assert_array_equal(tcore.thermometer_decode(tb, tn).numpy(), x)
    np.testing.assert_array_equal(np.asarray(jcore.thermometer_decode(jb, jn)),
                                  tcore.thermometer_decode(tb, tn).numpy())
    js = jcore.temporal_bitstream(jnp.asarray(x), w)
    ts = tcore.temporal_bitstream(torch.from_numpy(x), w)
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    np.testing.assert_array_equal(ts.to(torch.int32).sum(-1).numpy(), x)


def test_thermometer_is_contiguous_pulse():
    bits, _ = tcore.thermometer_encode(torch.arange(-8, 8, dtype=torch.int32), 4)
    assert (torch.diff(bits, dim=-1) <= 0).all()


# ------------------------------------------------------------------ tugemm
def _stats_equal(jst, tst):
    for f in ("step_cycles", "serial_cycles", "parallel_cycles", "max_abs", "act_max"):
        np.testing.assert_array_equal(np.asarray(getattr(jst, f)),
                                      getattr(tst, f).numpy(), err_msg=f)


@pytest.mark.parametrize("w", [2, 4, 8])
@pytest.mark.parametrize("shape", [(4, 4, 4), (7, 5, 3), (1, 9, 2), (16, 16, 16)])
def test_tugemm_with_c_matches_reference(w, shape):
    M, K, N = shape
    rng = np.random.default_rng(42 + w)
    A, B, C = rand_int(rng, (M, K), w), rand_int(rng, (K, N), w), rand_int(rng, (M, N), w)
    jy, jst = jcore.tugemm(jnp.asarray(A), jnp.asarray(B), jnp.asarray(C))
    ty, tst = tcore.tugemm(torch.from_numpy(A), torch.from_numpy(B), torch.from_numpy(C))
    assert ty.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(jy), ty.numpy())
    np.testing.assert_array_equal(ty.numpy(), A.astype(np.int64) @ B + C)
    _stats_equal(jst, tst)
    assert int(tst.serial_cycles) <= tcore.worst_case_cycles(w, K, "serial")


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int64])
def test_tugemm_batched_any_int_dtype_matches_reference(dtype):
    rng = np.random.default_rng(1)
    A = rand_int(rng, (3, 4, 5), 8).astype(dtype)
    B = rand_int(rng, (3, 5, 6), 8).astype(dtype)
    C = rand_int(rng, (3, 4, 6), 8).astype(dtype)
    jy, jst = jcore.tugemm(jnp.asarray(A), jnp.asarray(B), jnp.asarray(C))
    ty, tst = tcore.tugemm(torch.from_numpy(A), torch.from_numpy(B), torch.from_numpy(C))
    np.testing.assert_array_equal(np.asarray(jy), ty.numpy())
    assert tst.step_cycles.shape == (3, 5) and tst.serial_cycles.shape == (3,)
    _stats_equal(jst, tst)
    y0, s0 = tcore.tugemm(torch.from_numpy(A), torch.from_numpy(B), collect_stats=False)
    assert s0 is None
    np.testing.assert_array_equal(y0.numpy(), A.astype(np.int64) @ B)


@pytest.mark.parametrize("w", [2, 4, 8])
def test_validate_range_matches_reference(w):
    m = 2 ** (w - 1)
    for vals in ([-m, m - 1, 0], [-m - 1, 0], [m, 1], [3 % m, -1]):
        x = np.array(vals, np.int32)
        assert bool(tcore.validate_range(torch.from_numpy(x), w)) == \
            bool(jcore.validate_range(jnp.asarray(x), w)), (w, vals)


# -------------------------------------------------------------- cycle sim
@pytest.mark.parametrize("w", [2, 3, 4])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cycle_sim_copy_matches_reference(w, seed):
    rng = np.random.default_rng(seed)
    A, B, C = rand_int(rng, (4, 5), w), rand_int(rng, (5, 3), w), rand_int(rng, (4, 3), w)
    for name in ("simulate_serial", "simulate_parallel"):
        j, t = getattr(jsim, name)(A, B, C), getattr(tsim, name)(A, B, C)
        np.testing.assert_array_equal(j.Y, t.Y)
        np.testing.assert_array_equal(j.step_cycles, t.step_cycles)
        assert j.total_cycles == t.total_cycles
    _, st = tcore.tugemm(torch.from_numpy(A), torch.from_numpy(B), torch.from_numpy(C))
    np.testing.assert_array_equal(tsim.simulate_serial(A, B, C).step_cycles,
                                  st.step_cycles.numpy())


def test_cycle_sim_corners():
    r = tsim.simulate_serial(np.array([[0, 3], [0, 1]]), np.array([[2, 2], [1, 1]]))
    assert r.step_cycles[0] == 0                  # a zero A column ends at once
    r = tsim.simulate_serial(np.array([[2], [3]]), np.array([[0, 0]]))
    assert r.step_cycles[0] == 3                  # a zero B row drains max|A|


# ---------------------------------------------------------- latency, tiling
def test_latency_copy_matches_reference():
    for w in (2, 4, 8):
        for v in ("serial", "parallel"):
            assert tlat.worst_case_cycles(w, 16, v) == jlat.worst_case_cycles(w, 16, v)
    assert tlat.seconds(12345) == jlat.seconds(12345)
    with pytest.raises(ValueError):
        tlat.worst_case_cycles(8, 4, "systolic")
    vals = np.random.default_rng(5).integers(0, 129, 400)
    tp, jp = tlat.MaxValueProfile.empty(8), jlat.MaxValueProfile.empty(8)
    tp.add(vals)
    jp.add(vals)
    tp = tp.merge(tp)
    jp = jp.merge(jp)
    np.testing.assert_array_equal(tp.counts, jp.counts)
    np.testing.assert_array_equal(tp.pct(), jp.pct())
    np.testing.assert_array_equal(tp.cumulative_pct(), jp.cumulative_pct())
    assert tp.total == jp.total == 800
    assert tp.expected_max() == jp.expected_max()
    assert tp.speedup_vs_worst_case() == jp.speedup_vs_worst_case()
    for v in ("serial", "parallel"):
        assert tlat.average_case_cycles(tp, 16, v) == jlat.average_case_cycles(jp, 16, v)


@pytest.mark.parametrize("variant", ["serial", "parallel"])
@pytest.mark.parametrize("S,w,units", [(16, 8, 1), (32, 4, 4), (16, 2, 3)])
@pytest.mark.parametrize("profiled", [False, True])
def test_tiling_copy_matches_reference(variant, S, w, units, profiled):
    shapes = [("q", 64, 1024, 2048, 28), ("down", 64, 3072, 1024, 28), ("odd", 5, 33, 7, 1)]
    tt = [ttil.GemmTask(*s) for s in shapes]
    jt = [jtil.GemmTask(*s) for s in shapes]
    tprof = jprof = None
    if profiled:
        vals = np.random.default_rng(6).integers(0, 2 ** (w - 1) + 1, 50)
        tprof, jprof = tlat.MaxValueProfile.empty(w), jlat.MaxValueProfile.empty(w)
        tprof.add(vals)
        jprof.add(vals)
    tr = ttil.plan_workload(tt, ttil.TileConfig(variant, S, w, units), tprof)
    jr = jtil.plan_workload(jt, jtil.TileConfig(variant, S, w, units), jprof)
    for f in ("total_passes", "cycles", "area_mm2", "power_w", "latency_s", "energy_j"):
        assert getattr(tr, f) == getattr(jr, f), f
    assert [t.macs for t in tr.tasks] == [t.macs for t in jr.tasks]
    one = ttil.plan_gemm(tt[0], ttil.TileConfig(variant, S, w, units), tprof)
    assert one.cycles == jtil.plan_gemm(jt[0], jtil.TileConfig(variant, S, w, units),
                                        jprof).cycles


def test_hw_configs_copy_matches_reference():
    assert list(T_HW) == list(J_HW) and len(T_HW) == 12
    for name, cfg in T_HW.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(J_HW[name])


# --------------------------------------------------------------------- PPA
def test_ppa_and_ugemm_comparison_match_reference():
    for (variant, S, w), _ in jcore.TABLE1.items():
        j = jcore.evaluate_ppa(variant, w, S, S, S, 1234.0)
        t = tcore.evaluate_ppa(variant, w, S, S, S, 1234.0)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert tcore.ugemm_comparison(w, variant) == jcore.ugemm_comparison(w, variant)
    # a non-square GEMM (the S_eff generalization)
    for v in ("serial", "parallel"):
        assert dataclasses.asdict(tcore.evaluate_ppa(v, 4, 64, 1024, 3072, 9.0)) == \
            dataclasses.asdict(jcore.evaluate_ppa(v, 4, 64, 1024, 3072, 9.0))


def test_ppa_fit_error_within_10pct_on_all_table1_points():
    for (variant, S, w), (area, power) in tcore.TABLE1.items():
        m = tcore.ppa_model(variant)
        assert abs(m.area_mm2(w, S, S, S) - area) / area < 0.10, (variant, S, w)
        assert abs(m.power_w(w, S, S, S) - power) / power < 0.10, (variant, S, w)


def test_paper_quoted_ratios_vs_ugemm():
    ua, up = tcore.UGEMM_BASELINE["area_mm2"], tcore.UGEMM_BASELINE["power_w"]
    sa, sp = tcore.TABLE1[("serial", 16, 8)]
    pa, pp = tcore.TABLE1[("parallel", 16, 8)]
    assert ua / sa == pytest.approx(14.8, abs=0.1)
    assert up / sp == pytest.approx(11.1, abs=0.1)
    assert ua / pa == pytest.approx(3.7, abs=0.05)
    assert up / pp == pytest.approx(3.8, abs=0.05)


def test_clock_model_and_planner():
    s = tcore.ppa_model("serial")
    assert s.clock_hz(8) == pytest.approx(400e6)
    assert s.clock_hz(2) == pytest.approx(400e6 * 1.44)
    plan = tcore.plan_workload([tcore.GemmTask("l0", 256, 256, 256)],
                               tcore.TileConfig("serial", 16, 8, units=1))
    assert plan.total_passes == 16 ** 3
    plan4 = tcore.plan_workload([tcore.GemmTask("l0", 256, 256, 256)],
                                tcore.TileConfig("serial", 16, 8, units=4))
    assert plan4.latency_s < plan.latency_s / 3.9
    prof = tcore.MaxValueProfile.empty(8)
    prof.add(np.full(100, 41))
    avg = tcore.plan_workload([tcore.GemmTask("l0", 256, 256, 256)],
                              tcore.TileConfig("serial", 16, 8), profile=prof)
    assert avg.latency_s < plan.latency_s / 8


# ----------------------------------------------------------- energy report
def _stats_np(rng, K, bits, lead=()):
    m = 2 ** (bits - 1)
    sc = rng.integers(0, m * m + 1, (*lead, K)).astype(np.int32)
    return dict(step_cycles=sc, serial_cycles=sc.sum(-1).astype(np.int32),
                parallel_cycles=sc.max(-1), max_abs=rng.integers(0, m + 1, lead).astype(np.int32),
                act_max=rng.integers(0, m + 1, lead).astype(np.int32))


def _energy_pair(seed, layers=3):
    """The same GEMMs as a port Capture (one entry per executed GEMM) and as
    two reference trees: flat (one node per executed GEMM, labelled as the
    port labels them) and stacked (stats stacked over the layers, as the
    reference's scanned stacks give them)."""
    rng = np.random.default_rng(seed)
    gemms = [("attn.q", 64, 1024, 2048, 8), ("attn.o", 64, 2048, 1024, 8),
             ("mlp.up", 64, 1024, 3072, 2), ("mlp.down", 64, 3072, 1024, 4)]
    cap, flat, stacked = Capture(), {}, {}
    for name, M, K, N, bits in gemms:
        st = _stats_np(rng, K, bits, (layers,))
        stacked[name] = JCapturedGemm(name, M, K, N, jcore.TuGemmStats(
            **{k: jnp.asarray(v) for k, v in st.items()}), bits)
        for i in range(layers):
            one = {k: np.ascontiguousarray(v[i]) for k, v in st.items()}
            cap.entries.append(CapturedGemm(name, M, K, N, tcore.TuGemmStats(
                **{k: torch.from_numpy(v) for k, v in one.items()}), bits))
            flat[f"{name}#{i}"] = JCapturedGemm(name, M, K, N, jcore.TuGemmStats(
                **{k: jnp.asarray(v) for k, v in one.items()}), bits)
    return cap, flat, stacked


def _close(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _close(a[k], b[k])
    elif isinstance(a, float):
        assert a == pytest.approx(b, rel=1e-12, abs=0.0)
    else:
        assert a == b


@pytest.mark.parametrize("variant", ["serial", "parallel"])
@pytest.mark.parametrize("bits", [None, 8])
def test_energy_report_totals_match_reference(variant, bits):
    cap, flat, stacked = _energy_pair(3)
    comms = {"by_bits": {8: {"payload_bytes": 1000, "scale_bytes": 16, "bf16_bytes": 2000}}}
    t = tcore.energy_report(cap, bits=bits, variant=variant, comms=comms)
    j = jcore.energy_report(flat, bits=bits, variant=variant, comms=comms)
    js = jcore.energy_report(stacked, bits=bits, variant=variant, comms=comms)
    fields = ("bits", "total_cycles", "total_macs", "total_latency_s", "total_energy_j",
              "unit_power_w", "unit_latency_s", "unit_energy_j", "baseline", "by_bits",
              "interconnect", "interconnect_energy_j")
    for f in fields:
        _close(getattr(t, f), getattr(j, f))
    # the stacked tree: the same totals; its rows (and the per-bits row
    # counts) are one per stacked GEMM, the port's one per executed GEMM
    for f in fields:
        if f != "by_bits":
            _close(getattr(t, f), getattr(js, f))
    for b in t.by_bits:
        _close({k: v for k, v in t.by_bits[b].items() if k != "layers"},
               {k: v for k, v in js.by_bits[b].items() if k != "layers"})
    assert len(t.layers) == len(j.layers) == 12 and len(js.layers) == 4
    assert [le.label for le in t.layers] == [le.label for le in j.layers]
    assert all(le.instances == 1 for le in t.layers)
    assert [le.label for le in t.layers[:4]] == ["attn.q#0", "attn.q#1", "attn.q#2", "attn.o#0"]
    assert t.render() == j.render()


def test_energy_report_takes_labelled_entries_and_rejects_unknown_variant():
    cap, _, _ = _energy_pair(4, layers=1)
    listed = [(f"g{i}", e) for i, e in enumerate(cap.entries)]
    a, b = tcore.energy_report(cap), tcore.energy_report(listed)
    assert a.total_energy_j == b.total_energy_j and b.layers[0].label == "g0"
    with pytest.raises(ValueError):
        tcore.energy_report(cap, variant="systolic")


def test_spec_energy_summary_matches_reference():
    from repro.core.report import spec_energy_summary as j_spec
    from repro_torch.core.report import spec_energy_summary as t_spec

    entries = [{"generated_tokens": 5, "energy_j": 1e-6, "latency_s": 1e-3,
                "draft_energy_j": 2e-7, "drafted_tokens": 8, "accepted_draft_tokens": 6},
               {"generated_tokens": 3, "energy_j": 5e-7}]
    assert t_spec(entries) == j_spec(entries)
    assert t_spec([]) == j_spec([])


# ------------------------------------------------------ stochastic baseline
@pytest.mark.parametrize("L", [16, 256])
def test_ugemm_stochastic_is_unbiased_with_the_references_error(L):
    """20 trials of a 4-bit (8, 24) x (24, 8) GEMM in each package: the mean
    error of each is within 3 sigma of zero (sigma from the spread of the
    per-trial means, which are independent), and the two RMS errors agree
    within 20%."""
    rng = np.random.default_rng(17)
    A, B = rand_int(rng, (8, 24), 4), rand_int(rng, (24, 8), 4)
    exact = A.astype(np.int64) @ B
    trials = 20
    gen = torch.Generator().manual_seed(0)
    t_err = np.stack([tcore.ugemm_stochastic(
        torch.from_numpy(A), torch.from_numpy(B), bitwidth=4, stream_length=L,
        generator=gen).numpy() - exact for _ in range(trials)])
    keys = jax.random.split(jax.random.PRNGKey(0), trials)
    j_err = np.stack([np.asarray(jcore.ugemm_stochastic(
        jnp.asarray(A), jnp.asarray(B), bitwidth=4, stream_length=L, key=k)) - exact
        for k in keys])
    for err in (t_err, j_err):
        means = err.reshape(trials, -1).mean(axis=1)
        assert abs(means.mean()) <= 3 * means.std(ddof=1) / np.sqrt(trials)
    t_rms, j_rms = np.sqrt((t_err ** 2).mean()), np.sqrt((j_err ** 2).mean())
    assert abs(t_rms - j_rms) <= 0.2 * j_rms, (t_rms, j_rms)


def test_ugemm_stochastic_accumulates_c_and_stream_is_rate_coded():
    A = torch.full((2, 3), 7, dtype=torch.int32)
    s = tcore.stochastic_stream(A, 4, 4096, torch.Generator().manual_seed(1))
    assert s.dtype == torch.int8 and s.shape == (2, 3, 4096)
    assert abs(float(s.float().mean()) - 7 / 8) < 0.02
    C = torch.full((2, 2), 100, dtype=torch.int32)
    z = tcore.ugemm_stochastic(torch.zeros((2, 3), dtype=torch.int32),
                               torch.zeros((3, 2), dtype=torch.int32), C, bitwidth=4,
                               generator=torch.Generator().manual_seed(2))
    assert torch.equal(z, C)
