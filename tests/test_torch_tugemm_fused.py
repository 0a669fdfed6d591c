"""Port parity: the fused tuGEMM GEMM (``repro_torch.kernels.ops.matmul_fused``
on CPU tensors, i.e. its plain PyTorch version) against the reference's
``repro.kernels.ops.matmul_fused`` — the XLA twin and the Pallas kernel in
interpret mode — on the same numpy inputs.

y must be bit-exact (f32 and bf16 outputs) and the tuGEMM stats exact, over
every weight mode, bits 8/4/2, per-tensor and per-token scales and ragged
shapes. One documented exception: an f32 output WITH a bias may differ by
1 ulp, because XLA contracts the reference's dequant multiply + bias add
into one FMA (DESIGN.md §4) while the port pins a separate multiply and add
(the CUDA kernel must not contract either)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.quant.quantize import fused_scales as j_fused_scales
from repro_torch.interop import tensor_from_numpy as _to_torch
from repro_torch.kernels import ops as tops
from repro_torch.kernels.packing import PLANES
from repro_torch.quant.quantize import fused_scales as t_fused_scales

torch.set_float32_matmul_precision("highest")


def tensor_from_numpy(arr):
    return _to_torch(arr, device="cpu")


MODES = [("quant", 8), ("quant", 4), ("quant", 2), ("int8", 8), ("packed", 4), ("packed", 2)]


def _inputs(M, K, N, mode, bits, per_token, seed, dtype="float32"):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    if mode == "quant":
        w = (rng.standard_normal((K, N)) * 0.1).astype(np.float32)
        jx, jw = jnp.asarray(x, dtype), jnp.asarray(w, dtype)
        sx, sw = j_fused_scales(jx, jw, bits, per_token)
        return jx, jw, np.asarray(sx), np.asarray(sw), False
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    wq = rng.integers(lo, hi + 1, (K, N)).astype(np.int8)
    jx = jnp.asarray(x, dtype)
    jw = jops.pack_weights(jnp.asarray(wq), bits) if mode == "packed" else jnp.asarray(wq)
    sx = j_fused_scales(jx, jnp.ones((K, N), jnp.float32), bits, per_token)[0]
    sw = (rng.random(N) * 0.01 + 1e-3).astype(np.float32)
    return jx, jw, np.asarray(sx), sw, True


def _both(M, K, N, mode, bits, per_token, impl, seed=0, dtype="float32", bias=False):
    jx, jw, sx, sw, wq = _inputs(M, K, N, mode, bits, per_token, seed, dtype)
    b = np.random.default_rng(seed + 7).standard_normal(N).astype(np.float32) if bias else None
    jb = None if b is None else jnp.asarray(b, dtype)
    jy, jst = jops.matmul_fused(jx, jw, sx=jnp.asarray(sx), sw=jnp.asarray(sw), bias=jb,
                                bits=bits, w_quantized=wq, collect_stats=True, impl=impl)
    tx, tw = tensor_from_numpy(np.asarray(jx)), tensor_from_numpy(np.asarray(jw))
    tb = None if jb is None else tensor_from_numpy(np.asarray(jb))
    ty, tst = tops.matmul_fused(tx, tw, sx=tensor_from_numpy(sx), sw=tensor_from_numpy(sw),
                                bias=tb, bits=bits, w_quantized=wq, collect_stats=True)
    return (np.asarray(jy.astype(jnp.float32)), jst), (ty.float().numpy(), tst)


def _assert_stats(jst, tst):
    np.testing.assert_array_equal(np.asarray(jst.step_cycles), tst.step_cycles.numpy())
    for f in ("serial_cycles", "parallel_cycles", "max_abs", "act_max"):
        assert int(getattr(jst, f)) == int(getattr(tst, f)), f


@pytest.mark.parametrize("per_token", [False, True])
@pytest.mark.parametrize("mode,bits", MODES)
@pytest.mark.parametrize("shape", [(5, 37, 19), (16, 64, 48)])
def test_matches_reference_twin(shape, mode, bits, per_token):
    (jy, jst), (ty, tst) = _both(*shape, mode, bits, per_token, "xla")
    np.testing.assert_array_equal(jy, ty)
    _assert_stats(jst, tst)


@pytest.mark.parametrize("per_token", [False, True])
@pytest.mark.parametrize("mode,bits", MODES)
def test_matches_pallas_kernel_interpret(mode, bits, per_token):
    (jy, jst), (ty, tst) = _both(9, 40, 24, mode, bits, per_token, "pallas_interpret", seed=3)
    np.testing.assert_array_equal(jy, ty)
    _assert_stats(jst, tst)


@pytest.mark.parametrize("mode,bits", [("quant", 8), ("packed", 2)])
def test_bf16_outputs_exact(mode, bits):
    (jy, jst), (ty, tst) = _both(6, 33, 17, mode, bits, False, "xla", dtype="bfloat16",
                                 bias=True)
    np.testing.assert_array_equal(jy, ty)
    _assert_stats(jst, tst)


def test_f32_bias_within_one_ulp():
    (jy, _), (ty, _) = _both(6, 33, 17, "quant", 8, False, "xla", bias=True)
    np.testing.assert_array_max_ulp(jy, ty, maxulp=1)


def test_packed_weight_bytes_identical():
    from repro_torch.kernels.packing import unpack_plane

    rng = np.random.default_rng(5)
    for bits in (4, 2):
        lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
        wq = rng.integers(lo, hi + 1, (30, 7)).astype(np.int8)   # K padded to planes
        j = np.asarray(jops.pack_weights(jnp.asarray(wq), bits))
        t = tops.pack_weights(torch.from_numpy(wq), bits)
        np.testing.assert_array_equal(j, t.numpy())
        planes = PLANES[bits]
        kp = t.shape[0]
        back = torch.cat([unpack_plane(t, bits, p) for p in range(planes)])[:30]
        np.testing.assert_array_equal(back.numpy(), wq)
        assert kp * planes >= 30


def test_scales_feed_identically():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((11, 23)).astype(np.float32)
    w = rng.standard_normal((23, 5)).astype(np.float32)
    for bits in (8, 4, 2):
        for per_token in (False, True):
            js = j_fused_scales(jnp.asarray(x), jnp.asarray(w), bits, per_token)
            ts = t_fused_scales(torch.from_numpy(x), torch.from_numpy(w), bits, per_token)
            for a, b in zip(js, ts):
                np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_cuda_impl_on_cpu_tensor_raises():
    x = torch.zeros(4, 8)
    w = torch.zeros(8, 3)
    with pytest.raises(ValueError, match="needs CUDA"):
        tops.matmul_fused(x, w, sx=torch.ones(()), sw=torch.ones(3), bits=8, impl="cuda")


def test_step_cycles_match_reference():
    from repro.core.tugemm import step_cycles as j_step_cycles
    from repro_torch.core.tugemm import step_cycles as t_step_cycles

    rng = np.random.default_rng(4)
    a = rng.integers(-128, 128, (7, 12)).astype(np.int8)
    b = rng.integers(-8, 8, (12, 5)).astype(np.int8)
    b[3] = 0    # an all-zero B row drains one cycle per column count
    want = np.asarray(j_step_cycles(jnp.asarray(a), jnp.asarray(b)))
    got = t_step_cycles(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode,bits", MODES)
def test_raw_stats_vectors_exact(mode, bits):
    """``ca`` (max_m |Xq|) and ``rb`` (max_n |Wq|) themselves, in logical K
    order, against the reference twin's — not only the cycle totals built
    from them."""
    from repro.kernels.ref import fused_gemm_ref as j_ref
    from repro_torch.kernels.ref import fused_gemm_ref as t_ref

    jx, jw, sx, sw, _ = _inputs(6, 40, 13, mode, bits, False, seed=11)
    sx2 = jnp.asarray(sx).reshape(1, 1)
    sw2 = jnp.asarray(sw).reshape(1, -1)
    _, jca, jrb = j_ref(jx, jw, sx2, sw2, bits=bits, w_mode=mode, collect_stats=True)
    _, tca, trb = t_ref(tensor_from_numpy(np.asarray(jx)), tensor_from_numpy(np.asarray(jw)),
                        tensor_from_numpy(np.asarray(sx2)), tensor_from_numpy(np.asarray(sw2)),
                        bits=bits, w_mode=mode, collect_stats=True)
    np.testing.assert_array_equal(np.asarray(jca), tca.reshape(-1).numpy())
    np.testing.assert_array_equal(np.asarray(jrb), trb.t().reshape(-1).numpy())
