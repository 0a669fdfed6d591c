"""Port parity for the roofline tooling (``repro_torch.roofline``).

- ``analyze`` gives the reference's three terms, ``dominant``, ``bound_s``,
  ``useful_ratio`` and ``mfu`` for the counts the reference's ``parse_hlo``
  reads from ``tests/test_roofline.py``'s synthetic module, on each of the
  reference's profiles; the profiles keep the reference's numbers.
- ``CollectiveStats`` (and the dry-run's meta group) price every collective
  kind as the reference's ``collective_stats`` does on a synthetic module.
- Every kernel wrapper on ``meta`` tensors returns empty outputs of its
  plain version's shapes and dtypes and charges one op at
  ``roofline.kernel_cost``'s count; ``impl="cuda"`` on a meta tensor still
  raises.
- ``hw_profile("auto")`` picks by the CUDA card's name; the card's bound
  formula keeps ``chip_smoke.py``'s earlier one.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from repro.roofline import analysis as j_analysis
from repro.roofline.hlo_parse import parse_hlo
from repro_torch.kernels import ops
from repro_torch.kernels.flash_paged import flash_paged_decode
from repro_torch.kernels.quantize import quantize_sym
from repro_torch.kernels.temporal_unary import temporal_unary_gemm
from repro_torch.kernels.tugemm_fused import tugemm_fused
from repro_torch.kernels.tugemm_int8 import tugemm_int8
from repro_torch.kernels.tugemm_packed import tugemm_packed
from repro_torch.kernels.unary_stats import HDR, colabsmax, rowabsmax, tugemm_stats
from repro_torch.parallel.collectives import MetaGroup
from repro_torch.roofline import kernel_cost as kc
from repro_torch.roofline.analysis import HW_PROFILES, CollectiveStats, analyze, hw_profile
from repro_torch.roofline.op_cost import OpCost, count_ops

HERE = os.path.dirname(os.path.abspath(__file__))


def _reference_synth() -> str:
    spec = importlib.util.spec_from_file_location("_ref_test_roofline",
                                                  os.path.join(HERE, "test_roofline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.SYNTH


# ---------------------------------------------------------------- analysis
@pytest.mark.parametrize("prof", ["tpu", "gpu", "cpu"])
def test_profiles_keep_reference_numbers(prof):
    j, t = j_analysis.HW_PROFILES[prof], HW_PROFILES[prof]
    assert (t.peak_flops, t.hbm_bw, t.ici_bw, t.hbm_per_chip, t.name) == (
        j.peak_flops, j.hbm_bw, j.ici_bw, j.hbm_per_chip, j.name)
    assert t.rate("int8") == t.rate("f32") == t.peak_flops


def test_h100_profile():
    h = HW_PROFILES["h100"]
    assert (h.peak_flops, h.hbm_bw, h.hbm_per_chip, h.ici_bw) == (989e12, 3.35e12, 80e9, 900e9)
    assert (h.rate("bf16"), h.rate("int8"), h.rate("f32")) == (989e12, 1979e12, 67e12)


@pytest.mark.parametrize("prof", ["tpu", "gpu", "cpu"])
@pytest.mark.parametrize("chips,model_flops", [(4, 1e9), (256, 3.7e15), (1, 0.0)])
def test_analyze_matches_reference_on_synth(prof, chips, model_flops):
    synth = _reference_synth()
    c = parse_hlo(synth)
    cost = OpCost(flops=c.flops, hbm_bytes=c.hbm_bytes,
                  comms=CollectiveStats(bytes_by_kind=dict(c.collectives)))
    assert cost.collective_bytes == c.collective_bytes
    want = j_analysis.analyze("cell", chips=chips, hlo_text=synth, model_flops=model_flops,
                              hw=j_analysis.HW_PROFILES[prof], memory_per_chip=5.0)
    got = analyze("cell", chips=chips, cost=cost, model_flops=model_flops,
                  hw=HW_PROFILES[prof], memory_per_chip=5.0)
    for f in ("hlo_flops", "hlo_bytes", "collective_bytes", "model_flops", "compute_s",
              "memory_s", "collective_s", "dominant", "bound_s", "useful_ratio", "mfu",
              "collectives", "memory_per_chip", "chips", "name"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.table_row() == want.table_row()
    assert got.hw == prof


def test_analyze_defaults_to_h100():
    r = analyze("c", chips=2, cost=OpCost(flops=989e12, hbm_bytes=3.35e12), model_flops=989e12)
    assert r.hw == "h100" and r.compute_s == r.memory_s == 1.0 and r.mfu == 0.5


# ------------------------------------------------------------- collectives
COLL_HLO = """
HloModule colls

ENTRY %main (p: f32[64,128]) -> f32[64,128] {
  %p = f32[64,128]{1,0} parameter(0)
  %q = bf16[32,256]{1,0} parameter(1)
  %ar = f32[64,128]{1,0} all-reduce(%p), replica_groups={}, to_apply=%sum
  %ag = bf16[128,256]{1,0} all-gather(%q), dimensions={0}
  %rs = f32[16,128]{1,0} reduce-scatter(%p), dimensions={0}, to_apply=%sum
  %a2a = bf16[32,256]{1,0} all-to-all(%q), dimensions={0}
  %cp = f32[64,128]{1,0} collective-permute(%p), source_target_pairs={{0,1}}
  %ars = f32[64,128]{1,0} all-reduce-start(%p), replica_groups={}, to_apply=%sum
  %ags = bf16[64,256]{1,0} all-gather-start(%q), dimensions={0}
  %ar2 = f32[64,128]{1,0} all-reduce(%ar), replica_groups={}, to_apply=%sum
  ROOT %out = f32[64,128]{1,0} add(%ar2, %cp)
}
"""
# (kind, operand bytes, result bytes) of each collective above, in order
COLL_CALLS = [
    ("all-reduce", 64 * 128 * 4, 64 * 128 * 4),
    ("all-gather", 32 * 256 * 2, 128 * 256 * 2),
    ("reduce-scatter", 64 * 128 * 4, 16 * 128 * 4),
    ("all-to-all", 32 * 256 * 2, 32 * 256 * 2),
    ("collective-permute", 64 * 128 * 4, 64 * 128 * 4),
    ("all-reduce", 64 * 128 * 4, 64 * 128 * 4),
    ("all-gather", 32 * 256 * 2, 64 * 256 * 2),
    ("all-reduce", 64 * 128 * 4, 64 * 128 * 4),
]


def test_collective_stats_match_reference():
    want = j_analysis.collective_stats(COLL_HLO)
    assert set(want.bytes_by_kind) == {k for k, _, _ in COLL_CALLS}
    got = CollectiveStats()
    for kind, operand, result in COLL_CALLS:
        got.charge(kind, operand, result)
    assert got.bytes_by_kind == want.bytes_by_kind
    assert got.count_by_kind == want.count_by_kind
    assert got.total_bytes == want.total_bytes


def test_meta_group_charges_the_reference_table():
    """The dry-run's collectives: all-reduce / all-gather / reduce-scatter on
    a meta group of 4 give meta results of the real shapes, and their
    charges equal the reference's parse of the same calls."""
    g = MetaGroup(4)
    x = torch.empty(64, 128, device="meta")
    q = torch.empty(32, 256, dtype=torch.bfloat16, device="meta")
    with count_ops() as cost:
        assert g.all_reduce(x).shape == (64, 128)
        assert g.all_gather(q, 0).shape == (128, 256)
        assert g.reduce_scatter(torch.empty(64, 128, device="meta"), 0).shape == (16, 128)
        assert [t.shape for t in g.gather_rows([q, x[:32]])] == [(128, 256), (128, 128)]
        assert [t.shape for t in g.max_many([x, x[0]])] == [(64, 128), (128,)]
    hlo = """
HloModule m

ENTRY %main (p: f32[64,128]) -> f32[64,128] {
  %p = f32[64,128]{1,0} parameter(0)
  %q = bf16[32,256]{1,0} parameter(1)
  %r = f32[32,256]{1,0} parameter(2)
  %m = f32[65,128]{1,0} parameter(3)
  %ar = f32[64,128]{1,0} all-reduce(%p), replica_groups={}, to_apply=%sum
  %ag = bf16[128,256]{1,0} all-gather(%q), dimensions={0}
  %rs = f32[16,128]{1,0} reduce-scatter(%p), dimensions={0}, to_apply=%sum
  %ag2 = f32[128,256]{1,0} all-gather(%r), dimensions={0}
  ROOT %ar2 = f32[65,128]{1,0} all-reduce(%m), replica_groups={}, to_apply=%sum
}
"""
    want = j_analysis.collective_stats(hlo)
    assert cost.collectives == want.bytes_by_kind
    assert cost.collective_counts == want.count_by_kind
    assert cost.collective_bytes == want.total_bytes
    assert [k for k, _, _ in g.calls] == ["all-reduce", "all-gather", "reduce-scatter",
                                          "all-gather", "all-reduce"]


# ------------------------------------------------------------ meta kernels
def _m(shape, dtype=torch.int8):
    return torch.empty(shape, dtype=dtype, device="meta")


def _cpu(t):
    """A CPU tensor of ``t``'s shape and dtype (small values)."""
    g = torch.Generator().manual_seed(0)
    if t.dtype.is_floating_point:
        return torch.rand(t.shape, generator=g).to(t.dtype) + 0.01
    return torch.randint(-3, 4, t.shape, generator=g).to(t.dtype)


def _signature(out):
    flat = out if isinstance(out, tuple) else (out,)
    return [(tuple(t.shape), t.dtype) for t in flat]


def _fused_case(E, M, K, N, bits, mode, stats):
    planes = {2: 4, 4: 2, 8: 1}[bits] if mode == "packed" else 1
    Kw = -(-K // planes)
    lead = (E,) if E else ()
    e = E or 1
    x = _m(lead + (M, planes * Kw), torch.bfloat16)
    w = _m(lead + (Kw, N), torch.bfloat16 if mode == "quant" else torch.int8)
    sx, sw = _m(lead + (1, 1), torch.float32), _m(lead + (1, N), torch.float32)
    bias = _m(lead + (N,), torch.bfloat16)
    outs = [_m(lead + (M, N), torch.bfloat16)]
    if stats:
        outs += [_m(lead + (planes, Kw), torch.int32), _m(lead + (Kw, planes), torch.int32)]
    want = kc.gemm_bytes_ops((x, w, sx, sw, bias), outs, M, planes * Kw, N, e)
    fn = lambda impl, *a: tugemm_fused(*a, bits=bits, w_mode=mode, collect_stats=stats,
                                       out_dtype=torch.bfloat16, impl=impl)
    return "tugemm_fused", fn, (x, w, sx, sw, bias), want


def _int8_case(E, M, K, N, stats):
    lead = (E,) if E else ()
    a, b, c = _m(lead + (M, K)), _m(lead + (K, N)), _m(lead + (M, N), torch.int32)
    outs = [_m(lead + (M, N), torch.int32)]
    if stats:
        outs += [_m(lead + (1, K), torch.int32), _m(lead + (K, 1), torch.int32)]
    fn = lambda impl, *ops_: tugemm_int8(*ops_, collect_stats=stats, impl=impl)
    return "tugemm_int8", fn, (a, b, c), kc.gemm_bytes_ops((a, b, c), outs, M, K, N, E or 1)


def _packed_case(E, M, K, N, bits):
    planes = {2: 4, 4: 2}[bits]
    lead = (E,) if E else ()
    a, pb = _m(lead + (M, K)), _m(lead + (-(-K // planes), N))
    y = _m(lead + (M, N), torch.int32)
    fn = lambda impl, *ops_: tugemm_packed(*ops_, bits=bits, impl=impl)
    return "tugemm_packed", fn, (a, pb), kc.gemm_bytes_ops((a, pb), (y,), M, K, N, E or 1)


def _kernel_cases():
    cases = {
        "fused_quant_stats": _fused_case(0, 64, 96, 40, 8, "quant", True),
        "fused_int8": _fused_case(0, 4, 96, 40, 8, "int8", False),
        "fused_packed2_stats": _fused_case(0, 16, 100, 24, 2, "packed", True),
        "fused_experts_packed4": _fused_case(3, 16, 64, 24, 4, "packed", True),
        "int8": _int8_case(0, 64, 96, 40, False),
        "int8_stats_experts": _int8_case(2, 8, 48, 16, True),
        "packed_int2": _packed_case(0, 64, 100, 40, 2),
        "packed_int4_experts": _packed_case(2, 8, 64, 16, 4),
    }
    a, b = _m((64, 96)), _m((96, 40))
    cases["colabsmax"] = ("colabsmax", lambda impl, x: colabsmax(x, impl=impl), (a,),
                          kc.absmax_bytes_ops(a, _m((96,), torch.int32)))
    cases["rowabsmax"] = ("rowabsmax", lambda impl, x: rowabsmax(x, impl=impl), (b,),
                          kc.absmax_bytes_ops(b, _m((96,), torch.int32)))
    ca, rb = _m((4, 25), torch.int32), _m((25, 4), torch.int32)
    cases["tugemm_stats"] = ("tugemm_stats", lambda impl, c, r: tugemm_stats(c, r, 100, impl=impl),
                             (ca, rb), kc.stats_bytes_ops((ca, rb), (_m((HDR + 100,), torch.int32),)))
    cae, rbe = _m((3, 1, 64), torch.int32), _m((3, 64, 1), torch.int32)
    cases["tugemm_stats_experts"] = (
        "tugemm_stats", lambda impl, c, r: tugemm_stats(c, r, 64, impl=impl), (cae, rbe),
        kc.stats_bytes_ops((cae, rbe), (_m((3, HDR + 64), torch.int32),)))
    x = _m((64, 96), torch.bfloat16)
    cases["quantize_scalar"] = ("quantize_sym", lambda impl, x: quantize_sym(
        x, 0.5, bitwidth=4, impl=impl), (x,), kc.quantize_bytes_ops(x, 0.5, _m((64, 96))))
    s = _m((96,), torch.float32)
    cases["quantize_per_col"] = ("quantize_sym", lambda impl, x, s: quantize_sym(
        x, s, bitwidth=8, impl=impl), (x, s), kc.quantize_bytes_ops(x, s, _m((64, 96))))
    cases["temporal"] = ("temporal_unary_gemm", lambda impl, a, b: temporal_unary_gemm(
        a, b, bitwidth=4, impl=impl), (a, b),
        kc.temporal_bytes_ops(a, b, _m((64, 40), torch.int32), 4))
    return cases


CASES = _kernel_cases()


@pytest.mark.parametrize("case", list(CASES))
def test_meta_kernel_charge_equals_kernel_cost(case):
    """One op at the kernel's own count; the outputs carry the plain
    version's shapes and dtypes; no launch and no plain call is counted."""
    name, fn, args, (byts, n_ops) = CASES[case]
    ops.reset_counts()
    with count_ops() as cost:
        out = fn("auto", *args)
    assert cost.ops == 1
    (label, op), c = next(iter(cost.charges.items()))
    assert op == name and c["calls"] == 1
    assert (c["bytes"], c["flops"]) == (byts, n_ops)
    assert all(t.is_meta for t in (out if isinstance(out, tuple) else (out,)))
    assert ops.kernel_counts()[name] == {"launches": 0, "plain_calls": 0}
    plain = fn("torch", *(_cpu(t) for t in args))
    assert _signature(out) == _signature(plain)
    with pytest.raises(ValueError, match="unknown impl"):
        fn("meta", *args)


@pytest.mark.parametrize("case", list(CASES))
def test_meta_impl_on_a_real_tensor_raises(case):
    """No ``impl`` value asks for the meta path: ``meta`` is refused on a
    CPU tensor (it never hands back empty outputs as a result)."""
    name, fn, args, _ = CASES[case]
    ops.reset_counts()
    with pytest.raises(ValueError, match="unknown impl"):
        fn("meta", *(_cpu(t) for t in args))
    assert ops.kernel_counts()[name] == {"launches": 0, "plain_calls": 0}


def _attn_args(kv, group, parts, hdv, bs, P, B, Sq, MB, int8):
    dt = torch.int8 if int8 else torch.bfloat16
    pools = tuple(_m((P + 1, bs, kv * f), dt) for f in parts)
    scales = tuple(_m((P + 1, bs), torch.float32) if int8 else None for _ in parts)
    alias = len(parts) == 2
    v = pools[0] if alias else _m((P + 1, bs, kv * hdv), dt)
    vs = scales[0] if alias else (_m((P + 1, bs), torch.float32) if int8 else None)
    q = _m((B, Sq, kv * group, sum(parts)), torch.bfloat16)
    return (q, pools, scales, v, vs, _m((B, MB), torch.int32), _m((B,), torch.int32),
            _m((B,), torch.int32))


@pytest.mark.parametrize("mla", [False, True])
@pytest.mark.parametrize("int8", [False, True])
def test_meta_attention_charges_every_page(mla, int8):
    """``flash_paged_decode`` on meta tensors: every page of every row's
    table, 2·(hd + hdv) operations a query row a key."""
    kv, group, parts, hdv = (1, 4, (32, 16), 32) if mla else (2, 2, (16,), 16)
    args = _attn_args(kv, group, parts, hdv, 8, 12, 3, 5, 4, int8)
    with count_ops() as cost:
        out = flash_paged_decode(*args, kv_heads=kv)
    q = args[0]
    H, hd = q.shape[2], q.shape[3]
    flops = 2 * H * 5 * 3 * 4 * 8 * (hd + hdv)
    assert cost.ops == 1 and cost.flops == flops
    assert (cost.hbm_bytes, cost.flops) == kc.attn_bytes_ops(args, kv, 8, every_page=True)
    assert out.shape == (3, 5, H, hdv) and out.dtype == q.dtype and out.is_meta


def test_every_page_equals_visible_count_on_full_rows():
    """With every key of every page visible to every query row (no causal
    cut), the data-independent count equals the data-dependent one."""
    q = torch.zeros(2, 1, 4, 16, dtype=torch.bfloat16)
    pool = torch.zeros(9, 8, 32, dtype=torch.bfloat16)
    tables = torch.arange(8, dtype=torch.int32).reshape(2, 4)
    pos = torch.tensor([31, 31], dtype=torch.int32)
    kv_len = torch.tensor([32, 32], dtype=torch.int32)
    args = (q, (pool,), (None,), pool, None, tables, pos, kv_len)
    assert kc.attn_bytes_ops(args, 2, 8) == kc.attn_bytes_ops(args, 2, 8, every_page=True)


def test_ops_entry_points_take_the_meta_path():
    """Through ``kernels/ops.py`` (``resolve_path`` gives ``meta``): a fused
    GEMM with stats is two ops (the GEMM, ``tugemm_stats``), and the
    recorded path is ``meta``."""
    ops.reset_counts()
    x, w = _m((16, 64), torch.bfloat16), _m((64, 32), torch.bfloat16)
    sx, sw = _m((), torch.float32), _m((32,), torch.float32)
    with count_ops() as cost:
        y, st = ops.matmul_fused(x, w, sx=sx, sw=sw, bits=8, collect_stats=True, name="attn.q")
    assert [op for _, op in cost.charges] == ["tugemm_fused", "tugemm_stats"]
    assert y.shape == (16, 32) and st.step_cycles.shape == (64,) and st.max_abs.shape == ()
    assert ops.path_counts() == {"attn.q": {"meta": 1}}
    assert ops.resolve_path("auto", x) == "meta"
    assert ops.resolve_path("auto", torch.zeros(1)) == "torch"


@pytest.mark.parametrize("call", [
    lambda: ops.matmul_fused(_m((4, 8), torch.bfloat16), _m((8, 4), torch.bfloat16),
                             sx=_m((), torch.float32), sw=_m((4,), torch.float32), bits=8,
                             impl="cuda"),
    lambda: ops.matmul_int8(_m((4, 8)), _m((8, 4)), impl="cuda"),
    lambda: ops.matmul_packed(_m((4, 8)), _m((2, 4)), bits=2, impl="cuda"),
    lambda: ops.quantize_sym(_m((4, 8), torch.float32), 0.5, bitwidth=8, impl="cuda"),
    lambda: ops.temporal_gemm(_m((4, 8)), _m((8, 4)), bitwidth=2, impl="cuda"),
    lambda: colabsmax(_m((4, 8)), impl="cuda"),
    lambda: flash_paged_decode(*_attn_args(2, 2, (16,), 16, 8, 4, 1, 1, 2, True), kv_heads=2,
                               impl="cuda"),
])
def test_meta_tensor_under_cuda_impl_raises(call):
    with pytest.raises((ValueError, RuntimeError), match="CUDA"):
        call()


def test_unknown_impl_raises():
    with pytest.raises(ValueError, match="unknown impl"):
        tugemm_int8(_m((4, 8)), _m((8, 4)), impl="tpu")
    x, w = torch.zeros(4, 8, dtype=torch.bfloat16), torch.zeros(8, 4, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unknown impl"):
        ops.matmul_fused(x, w, sx=torch.ones(()), sw=torch.ones(4), bits=8, impl="meta")


def test_meta_fused_gemm_differentiable_in_scales():
    """A quantized GEMM on meta tensors under autograd keeps the plain
    version's gradient structure: the scales and the bias get gradients."""
    x = torch.empty(8, 16, device="meta", requires_grad=True)
    sx = (x.abs().amax() / 127).reshape(1, 1)
    w = torch.empty(16, 4, device="meta")
    sw = torch.empty(1, 4, device="meta", requires_grad=True)
    bias = torch.empty(4, device="meta", requires_grad=True)
    y = tugemm_fused(x, w, sx, sw, bias, bits=8, out_dtype=torch.float32)
    gx, gsw, gb = torch.autograd.grad(y.sum(), (x, sw, bias))
    assert (gx.shape, gsw.shape, gb.shape) == (x.shape, sw.shape, bias.shape)


# ----------------------------------------------------------------- profiles
def test_hw_profile_by_card_name(monkeypatch):
    assert hw_profile("h100") is HW_PROFILES["h100"]
    with pytest.raises(KeyError, match="unknown hw profile"):
        hw_profile("v100")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert hw_profile(None).name == hw_profile("auto").name == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA H100 80GB HBM3")
    assert hw_profile("auto").name == "h100"
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA A100-SXM4-80GB")
    assert hw_profile().name == "gpu"


@pytest.mark.parametrize("byts,n_ops", [(1, 0), (10**9, 10**9), (4096, 10**12), (10**6, 7)])
def test_bound_keeps_the_cards_earlier_formula(byts, n_ops):
    """``chip_smoke.py``'s bounds before they moved here: bytes over 3.35
    TB/s, operations over 1979 TOP/s int8 or 67 TFLOP/s f32."""
    for rate, peak in (("int8", 1979e12), ("f32", 67e12)):
        tb, to = byts / 3.35e12, n_ops / peak
        assert kc.bound(byts, n_ops, rate) == dict(
            bytes=byts, ops=n_ops, bound_ms=max(tb, to) * 1e3,
            bound_by="bytes" if tb >= to else "operations")
    assert np.isclose(kc.bound(3.35e9, 0)["bound_ms"], 1.0)
