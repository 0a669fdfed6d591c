"""Cross-layer conformance on the port, mirroring ``tests/test_conformance.py``:
the implementations of the tuGEMM cycle model must agree **exactly** —
outputs AND per-step and total cycles — at every bitwidth:

1. ``core.cycle_sim.simulate_serial/parallel`` (the port's copy of the
   gate-level golden model; the reference's own simulator is held beside it);
2. ``core.tugemm`` (the analytic model);
3. ``ops.temporal_gemm`` (the thermometer decomposition, plain version);
4. ``ops.matmul_int8`` with ``ops.unary_step_stats`` (the unfused stats);
5. ``ops.matmul_fused`` with unit scales on float copies of the integer
   operands (the fused kernel's in-pass stats, plain version).

Corners pinned by the paper's §III-B: an all-zero B row, an all-zero A
column, the ±2^(w-1) worst case, and the C input. Numpy seeds are stated
per test. The last test runs the port's quickstart on the reference's
weights and tokens and holds its four steps' quantities to the reference
quickstart's, exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.core.cycle_sim import simulate_serial as j_simulate_serial
from repro_torch.configs.tugemm_paper import HW_CONFIGS
from repro_torch.core import int_range, max_magnitude, tugemm, worst_case_cycles
from repro_torch.core.cycle_sim import simulate_parallel, simulate_serial
from repro_torch.kernels import ops

torch.set_float32_matmul_precision("highest")
BITS = [2, 4, 8]
SEEDS = [0, 1, 2]


def _rand_int(rng, shape, bits):
    lo, hi = int_range(bits)
    return rng.integers(lo, hi + 1, size=shape).astype(np.int32)


def _agree(A, B, bits, C=None):
    """Assert sim == tugemm == temporal == int8+absmax == fused stats on (A, B)."""
    ser = simulate_serial(A, B, C)
    par = simulate_parallel(A, B, C)
    jser = j_simulate_serial(A, B, C)
    At, Bt = torch.from_numpy(A), torch.from_numpy(B)
    Ct = None if C is None else torch.from_numpy(C)
    y_t, st_t = tugemm(At, Bt, Ct)
    y_u = ops.temporal_gemm(At.to(torch.int8), Bt.to(torch.int8), bitwidth=bits)
    y_i, st_i = ops.matmul_int8(At.to(torch.int8), Bt.to(torch.int8), collect_stats=True)
    N = B.shape[1]
    y_f, st_f = ops.matmul_fused(At.float(), Bt.float(), sx=torch.tensor(1.0),
                                 sw=torch.ones(N), bits=bits, collect_stats=True,
                                 out_dtype=torch.float32)
    ref = A.astype(np.int64) @ B + (0 if C is None else C)
    raw = A.astype(np.int64) @ B
    np.testing.assert_array_equal(ser.Y, ref)
    np.testing.assert_array_equal(par.Y, ref)
    np.testing.assert_array_equal(jser.Y, ser.Y)
    np.testing.assert_array_equal(y_t.numpy(), ref)
    np.testing.assert_array_equal(y_u.numpy(), raw)
    np.testing.assert_array_equal(y_i.numpy(), raw)
    np.testing.assert_array_equal(y_f.numpy().astype(np.int64), raw)
    for st in (st_t, st_i, st_f):
        np.testing.assert_array_equal(ser.step_cycles, st.step_cycles.numpy())
        assert ser.total_cycles == int(st.serial_cycles)
        assert par.total_cycles == int(st.parallel_cycles)
    np.testing.assert_array_equal(jser.step_cycles, ser.step_cycles)
    assert jser.total_cycles == ser.total_cycles
    return ser


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("seed", SEEDS)
def test_implementations_agree_random(bits, seed):
    rng = np.random.default_rng(1000 * bits + seed)
    M, K, N = (3, 5, 4) if bits == 8 else (4, 6, 5)
    _agree(_rand_int(rng, (M, K), bits), _rand_int(rng, (K, N), bits), bits)


@pytest.mark.parametrize("name", [n for n, c in HW_CONFIGS.items() if c.bitwidth < 8])
def test_implementations_agree_on_design_points(name):
    """The 2- and 4-bit Table I design points at their own m x n x p (numpy
    seed 0); the 8-bit ones run on the card (``chip_smoke.py``)."""
    hw = HW_CONFIGS[name]
    rng = np.random.default_rng(0)
    _agree(_rand_int(rng, (hw.m, hw.n), hw.bitwidth),
           _rand_int(rng, (hw.n, hw.p), hw.bitwidth), hw.bitwidth)


@pytest.mark.parametrize("bits", BITS)
def test_all_zero_row_corner(bits):
    rng = np.random.default_rng(20 + bits)
    A = _rand_int(rng, (3, 4), bits)
    A[:, 1] = np.where(A[:, 1] == 0, 1, A[:, 1])
    B = _rand_int(rng, (4, 3), bits)
    B[1, :] = 0
    ser = _agree(A, B, bits)
    assert ser.step_cycles[1] == np.abs(A[:, 1].astype(np.int64)).max()


@pytest.mark.parametrize("bits", BITS)
def test_all_zero_column_corner(bits):
    rng = np.random.default_rng(30 + bits)
    A = _rand_int(rng, (3, 4), bits)
    A[:, 2] = 0
    ser = _agree(A, _rand_int(rng, (4, 3), bits), bits)
    assert ser.step_cycles[2] == 0


@pytest.mark.parametrize("bits", BITS)
def test_worst_case_corner(bits):
    m = max_magnitude(bits)
    N = 4 if bits < 8 else 2
    A = np.full((2, N), -m, dtype=np.int32)
    B = np.full((N, 3), -m, dtype=np.int32)
    B[:, 1] = m - 1 if bits > 2 else -m
    A[1, :] = m - 1 if bits > 2 else -m
    ser = _agree(A, B, bits)
    assert ser.total_cycles == worst_case_cycles(bits, N, "serial")
    assert simulate_parallel(A, B).total_cycles == worst_case_cycles(bits, N, "parallel")


@pytest.mark.parametrize("bits", BITS)
def test_accumulator_input_c(bits):
    rng = np.random.default_rng(40 + bits)
    A, B, C = (_rand_int(rng, s, bits) for s in ((3, 3), (3, 2), (3, 2)))
    ser = _agree(A, B, bits, C)
    assert ser.total_cycles == simulate_serial(A, B).total_cycles
    y_i = ops.matmul_int8(torch.from_numpy(A).to(torch.int8), torch.from_numpy(B).to(torch.int8),
                          torch.from_numpy(C))
    np.testing.assert_array_equal(y_i.numpy(), ser.Y)


# --------------------------------------------------------------- quickstart
def test_quickstart_matches_reference_quickstart():
    """The port's quickstart on the reference quickstart's weights and tokens
    (``repro.models.init`` at PRNGKey(0), tokens from PRNGKey(1), carried
    across by ``interop``): steps 1-2's cycles, step 3's PPA numbers and step
    4's record count, profile counts and serial cycles equal the reference's."""
    from repro.configs.base import RunConfig, get_config
    from repro.models import forward, init
    from repro.quant.stats import collecting
    from repro_torch.interop import params_from_reference
    from repro_torch.quickstart import main

    rng = np.random.default_rng(0)
    A, B, C = (rng.integers(-8, 8, size=(16, 16)) for _ in range(3))
    _, jst = jcore.tugemm(jnp.asarray(A), jnp.asarray(B), jnp.asarray(C))
    jser, jpar = int(jst.serial_cycles), int(jst.parallel_cycles)

    cfg = get_config("qwen3-0.6b_smoke")
    rc = RunConfig(dtype="float32", param_dtype="float32", remat="none",
                   quant_policy="*=int8:stats")
    params = init(cfg, rc, jax.random.PRNGKey(0))
    toks = jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0, cfg.vocab_size)
    with collecting(bitwidth=8) as col:
        h, _, _ = forward(cfg, rc, params, {"tokens": toks})
        jax.block_until_ready(h)

    out = main("qwen3-0.6b_smoke", "cpu",
               params=params_from_reference(jax.tree.map(np.asarray, params), device="cpu"),
               tokens=torch.from_numpy(np.array(toks)))
    assert out["step1"]["serial_cycles"] == jser and out["step1"]["parallel_cycles"] == jpar
    assert out["step2"]["sim_serial_cycles"] == jser
    for variant, cyc in (("serial", jser), ("parallel", jpar)):
        rep = jcore.evaluate_ppa(variant, 4, 16, 16, 16, float(cyc))
        assert out["step3"][variant] == {"area_mm2": rep.area_mm2, "power_w": rep.power_w,
                                         "latency_s": rep.latency_s, "energy_j": rep.energy_j}
    s4 = out["step4"]
    assert s4["gemms"] == len(col.records)
    assert s4["profile_counts"] == col.profile().counts.tolist()
    assert s4["serial_cycles"] == col.total_cycles("serial")
    assert s4["parallel_cycles"] == col.total_cycles("parallel")
    assert s4["expected_max"] == col.profile().expected_max()
    assert s4["energy_total_cycles"] == s4["serial_cycles"]
