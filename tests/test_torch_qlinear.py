"""The port's quantized linear layer (``repro_torch.quant.qlinear``): the
legacy unfused pipeline and offline-prequantized leaves.

- On the port itself, ``gemm`` with ``fused=False`` is bit-exact against
  ``fused=True`` in outputs and ``TuGemmStats`` — the reference's own
  contract (``tests/test_fused.py``), dynamic and prequant.
- Against the reference on the same numpy inputs: the unfused dynamic
  ``gemm`` and ``dense`` over ``prequantize_tree`` leaves (fused and
  unfused), bit-exact in f32 and bf16, with one documented exception: XLA
  contracts the reference's jitted dequant multiply + bias add into an FMA
  (DESIGN.md §4) while the port rounds the product first, so an f32 output
  WITH a bias differs by at most that rounding plus the final one:
  ``ulp(y without bias) + ulp(y)``. Where the bias cancels most of the
  product this is a few ulps of the output, not one.
- The dispatch names each pipeline makes, and the ``:stats`` debug
  collector's records, equal the reference's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.quant import GemmBackend as JBackend
from repro.quant import collecting as j_collecting
from repro.quant import dense as j_dense
from repro.quant import gemm as j_gemm
from repro.quant import prequantize_tree as j_prequantize_tree
from repro_torch.interop import flat_leaves, params_from_reference
from repro_torch.kernels import ops as tops
from repro_torch.quant import GemmBackend, dense, gemm, prequantize_tree
from repro_torch.quant.quantize import dequantize, quantize
from repro_torch.quant.stats import collecting

torch.set_float32_matmul_precision("highest")
KINDS = [(8, "int8"), (4, "int4"), (2, "int2")]


def _data(M, K, N, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (M, K)).astype(np.float32),
            rng.normal(0, 0.1, (K, N)).astype(np.float32),
            rng.normal(0, 0.1, (N,)).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_stats_equal(a, b):
    np.testing.assert_array_equal(np.asarray(a.step_cycles), np.asarray(b.step_cycles))
    for f in ("serial_cycles", "parallel_cycles", "max_abs", "act_max"):
        assert int(getattr(a, f)) == int(getattr(b, f)), f


@pytest.mark.parametrize("act_scale", ["tensor", "token"])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("bits,kind", KINDS)
@pytest.mark.parametrize("M,K,N", [(1, 5, 3), (7, 33, 19), (130, 260, 36)])
def test_unfused_matches_fused_on_the_port(M, K, N, bits, kind, with_bias, act_scale):
    x, w, b = _data(M, K, N, seed=bits)
    bias = _t(b) if with_bias else None
    kw = dict(bias=bias, return_stats=True)
    yf, sf = gemm(_t(x), _t(w), backend=GemmBackend(kind, act_scale=act_scale), **kw)
    yu, su = gemm(_t(x), _t(w), backend=GemmBackend(kind, fused=False, act_scale=act_scale),
                  **kw)
    assert torch.equal(yf, yu)
    _assert_stats_equal(sf, su)


@pytest.mark.parametrize("bits,kind", KINDS)
def test_unfused_matches_fused_bf16_activations(bits, kind):
    x, w, b = _data(12, 40, 24, seed=3)
    xb = _t(x).to(torch.bfloat16)
    yf = gemm(xb, _t(w), backend=GemmBackend(kind), bias=_t(b))
    yu = gemm(xb, _t(w), backend=GemmBackend(kind, fused=False), bias=_t(b))
    assert yf.dtype == yu.dtype == torch.bfloat16
    assert torch.equal(yf, yu)


@pytest.mark.parametrize("bits,kind", KINDS)
@pytest.mark.parametrize("M,K,N", [(7, 30, 16), (33, 200, 20)])
def test_prequant_unfused_matches_fused_on_the_port(M, K, N, bits, kind):
    x, w, b = _data(M, K, N, seed=20 + bits)
    leaf = prequantize_tree({"p": {"kernel": _t(w), "bias": _t(b)}}, bits)["p"]
    yf = dense(leaf, _t(x), backend=GemmBackend(kind, "prequant"))
    yu = dense(leaf, _t(x), backend=GemmBackend(kind, "prequant", fused=False))
    assert torch.equal(yf, yu)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act_scale", ["tensor", "token"])
@pytest.mark.parametrize("bits,kind", KINDS)
def test_unfused_gemm_matches_reference(bits, kind, act_scale, dtype):
    x, w, _ = _data(9, 37, 21, seed=40 + bits)
    jx = jnp.asarray(x, dtype)
    jy, jst = j_gemm(jx, jnp.asarray(w), return_stats=True,
                     backend=JBackend(kind, fused=False, act_scale=act_scale, impl="xla"))
    ty, tst = gemm(_t(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype)), _t(w),
                   return_stats=True, backend=GemmBackend(kind, fused=False, act_scale=act_scale))
    np.testing.assert_array_equal(np.asarray(jy.astype(jnp.float32)), ty.float().numpy())
    _assert_stats_equal(jst, tst)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("with_bias,dtype", [(False, "float32"), (True, "float32"),
                                             (True, "bfloat16")])
@pytest.mark.parametrize("bits,kind", KINDS)
def test_prequant_dense_matches_reference(bits, kind, with_bias, dtype, fused):
    x, w, b = _data(11, 50, 24, seed=60 + bits)
    jx = jnp.asarray(x, dtype)
    tx = _t(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    tree = {"p": {"kernel": jnp.asarray(w)}}
    if with_bias:
        tree["p"]["bias"] = jnp.asarray(b)
    jleaf = j_prequantize_tree(tree, bits)["p"]
    tleaf = prequantize_tree(params_from_reference({"p": {k: np.asarray(v) for k, v in
                                                          tree["p"].items()}},
                                                   device="cpu"), bits)["p"]
    ja, ta = flat_leaves({k: v if k == "qbits" else np.asarray(v) for k, v in jleaf.items()}), \
        flat_leaves(tleaf)
    assert ja.keys() == ta.keys()
    for k in ja:
        assert (ja[k] == ta[k]) if k == "qbits" else np.array_equal(ja[k], ta[k]), k
    be = GemmBackend(kind, "prequant", fused=fused)
    jy = np.asarray(j_dense(jleaf, jx, backend=JBackend(kind, "prequant", fused=fused,
                                                        impl="xla")).astype(jnp.float32))
    ty = dense(tleaf, tx, backend=be).float().numpy()
    if with_bias and dtype == "float32":
        # XLA's FMA skips the rounding of the dequant product (module doc)
        y0 = dense({k: v for k, v in tleaf.items() if k != "bias"}, tx, backend=be).numpy()
        assert (np.abs(jy - ty) <= np.spacing(np.abs(y0)) + np.spacing(np.abs(ty))).all()
    else:
        np.testing.assert_array_equal(jy, ty)


@pytest.mark.parametrize("prequant", [False, True])
@pytest.mark.parametrize("fused", [True, False])
def test_dispatch_names_match_reference(fused, prequant):
    x, w, b = _data(6, 20, 12, seed=7)
    be = dict(fused=fused, collect_stats=False)
    if prequant:
        jleaf = j_prequantize_tree({"p": {"kernel": jnp.asarray(w)}}, 2)["p"]
        tleaf = prequantize_tree({"p": {"kernel": _t(w)}}, 2)["p"]
        with jops.counting_dispatches() as jlog:
            j_dense(jleaf, jnp.asarray(x), backend=JBackend("int2", "prequant", impl="xla",
                                                            **be))
        with tops.counting_dispatches() as tlog:
            dense(tleaf, _t(x), backend=GemmBackend("int2", "prequant", **be))
    else:
        with jops.counting_dispatches() as jlog:
            j_gemm(jnp.asarray(x), jnp.asarray(w), backend=JBackend("int8", impl="xla", **be),
                   return_stats=True)
        with tops.counting_dispatches() as tlog:
            gemm(_t(x), _t(w), backend=GemmBackend("int8", **be), return_stats=True)
    assert tlog == jlog
    assert len(tlog) == (2 if fused else (4 if prequant else 8))


@pytest.mark.parametrize("prequant", [False, True])
def test_stats_collector_records_match_reference(prequant):
    """The ``:stats`` debug collector: the unfused dynamic path records real
    cycles; the unfused prequant path records the activation max with zero
    cycles, as the reference does."""
    x, w, _ = _data(5, 24, 16, seed=9)
    kind = "int2" if prequant else "int8"
    if prequant:
        jw = j_prequantize_tree({"p": {"kernel": jnp.asarray(w)}}, 2)["p"]
        tw = prequantize_tree({"p": {"kernel": _t(w)}}, 2)["p"]
    else:
        jw, tw = {"kernel": jnp.asarray(w)}, {"kernel": _t(w)}
    mode = "prequant" if prequant else "dynamic"
    with j_collecting() as jcol:
        j_dense(jw, jnp.asarray(x), name="mlp.up",
                backend=JBackend(kind, mode, collect_stats=True, fused=False, impl="xla"))
    with collecting() as tcol:
        dense(tw, _t(x), name="mlp.up",
              backend=GemmBackend(kind, mode, collect_stats=True, fused=False))
    assert [vars(r) for r in tcol.records] == [vars(r) for r in jcol.records]
    assert len(tcol.records) == 1
    assert (tcol.records[0].serial_cycles == 0) == prequant


def test_quantize_dequantize_round_trip():
    x = _t(np.random.default_rng(0).normal(0, 1, (4, 8)).astype(np.float32))
    s = torch.tensor(0.05)
    q = quantize(x, s, 8)
    assert q.dtype == torch.int8 and int(q.abs().max()) <= 127
    assert torch.equal(dequantize(q, s), q.float() * s)
