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


# ------------------------------------- the kernel's split-K cluster grid
from repro_torch.core.tugemm import TuGemmStats  # noqa: E402
from repro_torch.kernels.packing import unpack_plane  # noqa: E402
from repro_torch.kernels.ref import _dequant_bias, _quant, assemble_stats_ref  # noqa: E402
from repro_torch.kernels.tugemm_fused import (BLOCK_RESERVED, BM, KC, MAX_RESIDENT,  # noqa: E402
                                              MAX_SPLITS, SM_SMEM, _smem, split_plan)

# (K, N) of qwen3-0.6b's layer GEMMs: q, k/v, o, gate/up, down
LAYER_SHAPES = [(1024, 2048), (1024, 1024), (2048, 1024), (1024, 3072), (3072, 1024)]


def _blocks(M, N, Kw, planes, sms=132, xbytes=1):
    bn, splits, _ = split_plan(M, N, Kw, planes, sms, xbytes)
    return splits * -(-N // bn) * -(-M // BM)


@pytest.mark.parametrize("planes", [1, 2, 4])
@pytest.mark.parametrize("mnk", [(64, 2048, 1024), (4, 1024, 768), (37, 65, 333), (1, 3, 5),
                                 (200, 128, 64), (64, 1040, 1040), (64, 1024, 96)])
def test_split_plan_covers_every_chunk_and_tile_once(planes, mnk):
    M, N, Kw = mnk
    bn, splits, chunks = split_plan(M, N, Kw, planes, sms=132)
    assert bn in (32, 64, 128) and 1 <= splits <= MAX_SPLITS
    k_chunks = -(-Kw // KC)
    owner = np.zeros((k_chunks, -(-N // bn)), int)
    for s in range(splits):
        owner[s * chunks:(s + 1) * chunks] += 1
    assert (owner == 1).all()
    # no block of the grid is left without work
    assert (splits - 1) * chunks < k_chunks


@pytest.mark.parametrize("M", [64, 32, 4])
@pytest.mark.parametrize("kn,planes", [(kn, 1) for kn in LAYER_SHAPES]
                         + [(kn, 4) for kn in LAYER_SHAPES[3:]])
def test_split_plan_fills_the_card_at_the_layer_gemms(M, kn, planes):
    """Quant or int8 weights (Kw = K) at every layer GEMM, and the MLP's
    int2 packed ones (Kw = K / 4, bf16 X) of the serve's prequant policy: at
    least half the 132 SMs get a block of 8 warps and each block walks at
    most two 64-row chunks where 16 splits allow it. One plane: a narrower
    tile is taken only where the wider one cannot reach half the SMs.
    Packed: every block is resident at once (one or two an SM by the
    mainloop's shared memory), and no cluster above 8 blocks where one block
    fills an SM."""
    K, N = kn
    Kw = K // planes
    xbytes = 2 if planes > 1 else 1
    bn, splits, chunks = split_plan(M, N, Kw, planes, 132, xbytes)
    blocks = _blocks(M, N, Kw, planes, xbytes=xbytes)
    assert blocks >= 66
    k_chunks = -(-Kw // KC)
    assert chunks <= max(2, -(-k_chunks // MAX_SPLITS))
    if planes == 1 and bn < 128:
        assert -(-N // (2 * bn)) * min(MAX_SPLITS, k_chunks) < 66
    if planes > 1:
        per_sm = min(MAX_RESIDENT, SM_SMEM // (_smem(planes, bn, chunks, xbytes) + BLOCK_RESERVED))
        assert blocks <= 132 * per_sm
        assert splits <= 8 or per_sm > 1


def test_split_plan_takes_shapes_only():
    import inspect

    assert list(inspect.signature(split_plan).parameters) == ["M", "N", "Kw", "planes", "sms",
                                                              "xbytes", "experts"]


def _split_emulation(x, w, sx, sw, bias, *, bits, w_mode, out_dtype, sms):
    """The kernel's grid in torch: for each (M tile, N tile) of ``split_plan``
    the int32 partial product of every K slice (its chunks of 32 W rows, all
    planes), summed, then the one epilogue; ca and rb as the max of per-block
    maxima (ca from the first N tile's blocks, rb from the first M tile's)."""
    planes = PLANES[bits] if w_mode == "packed" else 1
    M = x.shape[0]
    Kw, N = w.shape
    bn, splits, chunks = split_plan(M, N, Kw, planes, sms)
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    xq = _quant(x, sx, lo, hi).to(torch.int64)
    if w_mode == "packed":
        wq = [unpack_plane(w, bits, p).to(torch.int64) for p in range(planes)]
    else:
        wq = [(_quant(w, sw, lo, hi) if w_mode == "quant" else w).to(torch.int64)]
    acc = torch.zeros((M, N), dtype=torch.int64)
    ca = torch.zeros((planes, Kw), dtype=torch.int64)
    rb = torch.zeros((Kw, planes), dtype=torch.int64)
    for m0 in range(0, M, BM):
        for n0 in range(0, N, bn):
            for s in range(splits):
                k0, k1 = s * chunks * KC, min((s + 1) * chunks * KC, Kw)
                part = torch.zeros_like(acc[m0:m0 + BM, n0:n0 + bn])
                for p in range(planes):
                    xa = xq[m0:m0 + BM, p * Kw + k0:p * Kw + k1]
                    wb = wq[p][k0:k1, n0:n0 + bn]
                    part += xa @ wb
                    if n0 == 0 and k1 > k0:
                        ca[p, k0:k1] = torch.maximum(ca[p, k0:k1], xa.abs().amax(0))
                    if m0 == 0 and k1 > k0:
                        rb[k0:k1, p] = torch.maximum(rb[k0:k1, p], wb.abs().amax(1))
                acc[m0:m0 + BM, n0:n0 + bn] += part
    y = _dequant_bias(acc.to(torch.int32), sx, sw, bias, out_dtype)
    return y, ca.to(torch.int32), rb.to(torch.int32)


@pytest.mark.parametrize("per_token,dtype,bias", [(False, "float32", False),
                                                  (True, "bfloat16", True)])
@pytest.mark.parametrize("mode,bits", MODES)
@pytest.mark.parametrize("shape,sms", [((37, 333, 65), 4), ((70, 600, 40), 2)])
def test_split_emulation_matches_the_pallas_kernel(shape, sms, mode, bits, per_token, dtype,
                                                   bias):
    """Ragged M, N, K (and a K not a plane multiple), K split across up to 6
    blocks, two M tiles; outputs bit-exact against the reference's Pallas
    kernel in interpret mode, stats exact against it and raw ca / rb against
    the plain version."""
    M, K, N = shape
    jx, jw, sx, sw, wq = _inputs(M, K, N, mode, bits, per_token, seed=M + K, dtype=dtype)
    b = np.random.default_rng(K).standard_normal(N).astype(np.float32) if bias else None
    jb = None if b is None else jnp.asarray(b, dtype)
    jy, jst = jops.matmul_fused(jx, jw, sx=jnp.asarray(sx), sw=jnp.asarray(sw), bias=jb,
                                bits=bits, w_quantized=wq, collect_stats=True,
                                impl="pallas_interpret")
    tx, tw = tensor_from_numpy(np.asarray(jx)), tensor_from_numpy(np.asarray(jw))
    planes = PLANES[bits] if mode == "packed" else 1
    tx = torch.nn.functional.pad(tx, (0, planes * tw.shape[0] - K))
    tsx = tensor_from_numpy(np.asarray(sx)).reshape(-1, 1 if per_token else 1)
    tsx = tsx if per_token else tsx.reshape(1, 1)
    tsw = tensor_from_numpy(np.asarray(sw)).reshape(1, N)
    tb = None if jb is None else tensor_from_numpy(np.asarray(jb))
    out_dtype = tx.dtype
    y, ca, rb = _split_emulation(tx, tw, tsx, tsw, tb, bits=bits, w_mode=mode,
                                 out_dtype=out_dtype, sms=sms)
    assert split_plan(M, N, tw.shape[0], planes, sms)[1] > 1
    np.testing.assert_array_equal(np.asarray(jy.astype(jnp.float32)), y.float().numpy())
    _assert_stats(jst, TuGemmStats(*assemble_stats_ref(ca.reshape(-1)[:K],
                                                       rb.t().reshape(-1)[:K])))
    from repro_torch.kernels.ref import fused_gemm_ref

    want = fused_gemm_ref(tx, tw, tsx, tsw, tb, bits=bits, w_mode=mode, collect_stats=True,
                          out_dtype=out_dtype)
    for got, ref in zip((y, ca, rb), want):
        assert torch.equal(got, ref)


def test_packed_plane_decode_bytes_are_the_plain_unpack():
    """csrc/tugemm_mainloop.cuh decode_plane on packed words: every byte,
    every plane of int4 and int2, equals unpack_plane (the shift-up,
    arithmetic-shift-down decode) with no carry between bytes."""
    vals = np.arange(256, dtype=np.uint32)
    words = vals.reshape(-1, 4)
    raw = words[:, 0] | words[:, 1] << 8 | words[:, 2] << 16 | words[:, 3] << 24
    packed = torch.from_numpy(vals.astype(np.uint8).view(np.int8))
    for bits, planes in ((4, 2), (2, 4)):
        s = np.uint32(1 << (bits - 1))
        mask = np.uint32(0x01010101 * ((1 << bits) - 1))
        for p in range(planes):
            f = ((raw >> np.uint32(p * bits)) & mask) ^ (np.uint32(0x01010101) * s)
            d = (f + np.uint32(0x01010101) * (np.uint32(0x80) - s)) ^ np.uint32(0x80808080)
            got = np.stack([(d >> np.uint32(8 * i)) & np.uint32(0xFF) for i in range(4)], 1)
            got = got.reshape(-1).astype(np.uint8).view(np.int8)
            np.testing.assert_array_equal(got, unpack_plane(packed, bits, p).numpy())
