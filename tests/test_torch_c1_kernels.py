"""Port parity for the C1 validation path's kernels: ``repro_torch.kernels.ops``
``quantize_sym`` and ``temporal_gemm`` on CPU tensors, i.e. the plain
PyTorch versions of ``csrc/quantize_sym.cu`` and ``csrc/temporal_unary.cu``,
against the reference's ``repro.kernels.ops`` — its XLA twins and its Pallas
kernels in interpret mode — on the same numpy inputs (seeds stated per
test). Every output is an integer code and must be exact: operands holding
-2**(w-1), ragged shapes, per-tensor and per-column scales and bf16 inputs
included. NaN inputs are outside both packages' contract and are not drawn.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops
from repro_torch.kernels.quantize import quantize_sym as quantize_kernel
from repro_torch.kernels.ref import quantize_sym_ref, temporal_unary_gemm_ref

torch.set_float32_matmul_precision("highest")
IMPLS = ["xla", "pallas_interpret"]


def _int(rng, shape, bits):
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    a = rng.integers(lo, hi + 1, shape).astype(np.int8)
    a.flat[0] = lo        # the most negative code: |-2**(w-1)| must count 2**(w-1)
    return a


# ------------------------------------------------------------ temporal GEMM
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("shape", [(1, 5, 3), (8, 16, 8), (13, 37, 9)])
def test_temporal_gemm_matches_reference(impl, bits, shape):
    M, K, N = shape
    rng = np.random.default_rng(100 * bits + M)
    a, b = _int(rng, (M, K), bits), _int(rng, (K, N), bits)
    want = jops.temporal_gemm(jnp.asarray(a), jnp.asarray(b), bitwidth=bits, impl=impl)
    got = tops.temporal_gemm(torch.from_numpy(a), torch.from_numpy(b), bitwidth=bits)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b)


@pytest.mark.parametrize("impl", IMPLS)
def test_temporal_gemm_8bit_matches_reference(impl):
    """The full 8-bit decomposition (128 unary steps), -128 in both operands."""
    rng = np.random.default_rng(8)
    a, b = _int(rng, (8, 8), 8), _int(rng, (8, 8), 8)
    want = jops.temporal_gemm(jnp.asarray(a), jnp.asarray(b), bitwidth=8, impl=impl)
    got = tops.temporal_gemm(torch.from_numpy(a), torch.from_numpy(b), bitwidth=8)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_temporal_gemm_wide_int_operands_match_reference():
    """int32 operands in range: the plain version takes them as they are,
    as the reference's XLA twin does."""
    rng = np.random.default_rng(3)
    a = rng.integers(-8, 8, (6, 11)).astype(np.int32)
    b = rng.integers(-8, 8, (11, 4)).astype(np.int32)
    want = jops.temporal_gemm(jnp.asarray(a), jnp.asarray(b), bitwidth=4, impl="xla")
    got = tops.temporal_gemm(torch.from_numpy(a), torch.from_numpy(b), bitwidth=4)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_temporal_saturation_is_the_kernels_not_the_plain_gemms():
    """Outside the w-bit range the decomposition saturates |a| at 2**(w-1)
    (the Pallas kernel in interpret mode shows it); the plain GEMM does not.
    In-range operands are the contract; the card check holds the CUDA
    kernel against the plain GEMM of the saturated A."""
    rng = np.random.default_rng(4)
    a = rng.integers(-128, 128, (8, 16)).astype(np.int8)
    b = _int(rng, (16, 8), 2)
    kern = np.asarray(jops.temporal_gemm(jnp.asarray(a), jnp.asarray(b), bitwidth=2,
                                         impl="pallas_interpret"))
    sat = np.sign(a) * np.minimum(np.abs(a.astype(np.int32)), 2)
    np.testing.assert_array_equal(kern, sat.astype(np.int64) @ b)
    plain = temporal_unary_gemm_ref(torch.from_numpy(sat.astype(np.int8)),
                                    torch.from_numpy(b), 2)
    np.testing.assert_array_equal(plain.numpy(), kern)
    assert not np.array_equal(tops.temporal_gemm(torch.from_numpy(a), torch.from_numpy(b),
                                                 bitwidth=2).numpy(), kern)


def test_temporal_gemm_kernel_refuses_beyond_8_bits():
    a = torch.zeros((2, 2), dtype=torch.int8)
    with pytest.raises(ValueError, match="beyond 8 bits"):
        tops.temporal_gemm(a, a, bitwidth=9, impl="cuda")


# ------------------------------------------------------------------ quantize
def _scale(rng, N, per_column):
    if per_column:
        return np.abs(rng.normal(1, 0.3, (N,))).astype(np.float32) + 0.1
    return np.float32(0.5)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("per_column", [False, True])
@pytest.mark.parametrize("shape", [(4, 8), (37, 33)])
def test_quantize_sym_matches_reference(impl, bits, per_column, shape):
    M, N = shape
    rng = np.random.default_rng(7 + M + bits)
    x = rng.normal(0, 2.0, (M, N)).astype(np.float32)
    x.flat[0] = 1e6           # clipped at the top of the range
    x.flat[1] = -1e6          # ... and at the bottom, -2**(w-1)
    scale = _scale(rng, N, per_column)
    want = jops.quantize_sym(jnp.asarray(x), jnp.asarray(scale), bitwidth=bits, impl=impl)
    got = tops.quantize_sym(torch.from_numpy(x), torch.from_numpy(np.asarray(scale)),
                            bitwidth=bits)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert int(got.min()) == -(2 ** (bits - 1)) and int(got.max()) == 2 ** (bits - 1) - 1


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("per_column", [False, True])
def test_quantize_sym_bf16_matches_reference(impl, per_column):
    rng = np.random.default_rng(11)
    x = rng.normal(0, 3.0, (24, 40)).astype(np.float32)
    scale = _scale(rng, 40, per_column)
    want = jops.quantize_sym(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(scale),
                             bitwidth=8, impl=impl)
    got = tops.quantize_sym(torch.from_numpy(x).to(torch.bfloat16),
                            torch.from_numpy(np.asarray(scale)), bitwidth=8)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("scale_shape", [(), (1,), (40,), (1, 40)])
def test_quantize_sym_scale_shapes_match_reference(scale_shape):
    """Per-tensor and per-column scales in every shape the reference takes;
    ties sit exactly on x·(1/scale) = k + 1/2 and round half to even."""
    rng = np.random.default_rng(12)
    x = (rng.integers(-20, 20, (6, 40)) + 0.5).astype(np.float32) * 0.25
    scale = np.full(scale_shape, 0.25, np.float32)
    want = jops.quantize_sym(jnp.asarray(x), jnp.asarray(scale), bitwidth=4, impl="xla")
    got = tops.quantize_sym(torch.from_numpy(x), torch.from_numpy(scale), bitwidth=4)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    got_f = tops.quantize_sym(torch.from_numpy(x), 0.25, bitwidth=4)
    np.testing.assert_array_equal(got_f.numpy(), got.numpy())
    got_k = quantize_kernel(torch.from_numpy(x), torch.from_numpy(scale), bitwidth=4)
    np.testing.assert_array_equal(got_k.numpy(), got.numpy())


@pytest.mark.parametrize("form", ["float", "0-d", "(N,)", "(1, N)"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_sym_scale_forms_match_reference(form, dtype):
    """The four forms ``ops.quantize_sym`` hands to the kernel as they are:
    a Python float and a 0-d tensor per tensor, (N,) and (1, N) per column
    (values near the smallest scale ``amax_to_scale`` gives included); each
    gives the reference's codes, and the kernel wrapper given the scale as
    it is equals the plain version given inv = 1/scale in f32."""
    rng = np.random.default_rng(13)
    M, N = 9, 37
    x = rng.normal(0, 2.0, (M, N)).astype(np.float32)
    per_col = (rng.uniform(0.01, 2.0, N) * rng.choice([1.0, 1e-8 / 127], N)).astype(np.float32)
    scale = {"float": 0.37, "0-d": np.float32(0.37), "(N,)": per_col,
             "(1, N)": per_col.reshape(1, N)}[form]
    xt = torch.from_numpy(x).to(dtype)
    want = jops.quantize_sym(jnp.asarray(xt.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32),
        jnp.asarray(scale), bitwidth=8, impl="xla")
    arg = scale if form == "float" else torch.from_numpy(np.asarray(scale))
    got = tops.quantize_sym(xt, arg, bitwidth=8)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    inv = (1.0 / torch.as_tensor(np.asarray(scale, np.float32))).reshape(1, -1)
    np.testing.assert_array_equal(quantize_sym_ref(xt, inv, 8).numpy(), got.numpy())
    np.testing.assert_array_equal(quantize_kernel(xt, arg, bitwidth=8).numpy(), got.numpy())


def test_quantize_sym_wrapper_takes_one_scale_form():
    """The kernel wrapper takes the scale as given, and only one of 1 or N
    values: not its reciprocal under another name, nor another width."""
    x = torch.zeros((2, 3))
    with pytest.raises(TypeError):
        quantize_kernel(x, inv_scale=torch.ones((1, 3)), bitwidth=4)
    for bad in (torch.ones(2), torch.ones((2, 3)), np.ones(4, np.float32)):
        with pytest.raises(ValueError, match="neither per tensor nor per column"):
            quantize_kernel(x, bad, bitwidth=4)
        with pytest.raises(ValueError, match="neither per tensor nor per column"):
            tops.quantize_sym(x, bad, bitwidth=4)


# ---------------------------------------------------------- paths and counts
def test_dispatch_names_paths_and_plain_counts_match_reference():
    rng = np.random.default_rng(0)
    a, b = _int(rng, (4, 16), 4), _int(rng, (16, 8), 4)
    x = rng.normal(0, 1, (4, 16)).astype(np.float32)
    with jops.counting_dispatches() as jlog:
        jops.quantize_sym(jnp.asarray(x), 0.1, bitwidth=4, impl="xla")
        jops.temporal_gemm(jnp.asarray(a), jnp.asarray(b), bitwidth=4, impl="xla")
    tops.reset_counts()
    with tops.counting_dispatches() as tlog:
        tops.quantize_sym(torch.from_numpy(x), 0.1, bitwidth=4)
        tops.temporal_gemm(torch.from_numpy(a), torch.from_numpy(b), bitwidth=4)
    assert tlog == jlog == ["quantize_sym", "temporal_gemm"]
    assert tops.path_counts() == {"quantize_sym": {"torch": 1}, "temporal_gemm": {"torch": 1}}
    counts = tops.kernel_counts()
    assert len(counts) == 10
    assert counts["quantize_sym"] == {"launches": 0, "plain_calls": 1}
    assert counts["temporal_unary_gemm"] == {"launches": 0, "plain_calls": 1}


def test_cuda_path_without_a_card_raises_instead_of_falling_back():
    a = torch.zeros((2, 3), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        tops.temporal_gemm(a, a.t().contiguous(), bitwidth=4, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        tops.quantize_sym(torch.zeros((2, 3)), 1.0, bitwidth=4, impl="cuda")


# ------------------------------------- the tensor-core kernel's split grid
from repro_torch.kernels.temporal_unary import BK, BM, BN, split_plan  # noqa: E402

LAYER_SHAPES = [(1024, 2048), (1024, 1024), (2048, 1024), (1024, 3072), (3072, 1024)]


def _blocks(M, N, K, steps, sms=132):
    _, ks, _, us = split_plan(M, N, K, steps, sms)
    return -(-M // BM) * -(-N // BN) * ks * us


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("mkn", [(64, 1024, 2048), (4, 3072, 1024), (37, 333, 65),
                                 (64, 1040, 1040), (1, 5, 3), (200, 64, 128)])
def test_split_plan_covers_every_k_tile_and_step_once(bits, mkn):
    M, K, N = mkn
    steps = 2 ** (bits - 1)
    kchunk, ksplits, uchunk, usplits = split_plan(M, N, K, steps, sms=132)
    k_tiles = -(-K // BK)
    owner = np.zeros((k_tiles, steps), int)
    for ks in range(ksplits):
        for us in range(usplits):
            owner[ks * kchunk:(ks + 1) * kchunk, us * uchunk:(us + 1) * uchunk] += 1
    assert (owner == 1).all()
    # no block of the grid is left without work
    assert (ksplits - 1) * kchunk < k_tiles and (usplits - 1) * uchunk < steps


@pytest.mark.parametrize("M", [64, 4])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("kn", LAYER_SHAPES)
def test_split_plan_fills_the_card_at_the_layer_gemms(M, bits, kn):
    K, N = kn
    assert _blocks(M, N, K, 2 ** (bits - 1)) >= 132


def test_split_plan_takes_shapes_only():
    import inspect

    assert list(inspect.signature(split_plan).parameters) == ["M", "N", "K", "steps", "sms"]


def _split_decomposition(a, b, bits, sms=132, tile=(BM, BN)):
    """The kernel's grid in torch (output tiles of ``tile``, K tiles of BK):
    per output tile and (K range, step range) of the plan, the partial
    sum_u sign(A)·1[u < |A|] @ B over that range,
    added into a zeroed int32 output (the kernel's atomicAdd)."""
    M, K = a.shape
    N = b.shape[1]
    steps = 2 ** (bits - 1)
    kchunk, ksplits, uchunk, usplits = split_plan(M, N, K, steps, sms)
    bm, bn = tile
    ai, bi = a.to(torch.int64), b.to(torch.int64)
    sign, mag = ai.sign(), ai.abs()          # |-128| = 128 in int64
    y = torch.zeros((M, N), dtype=torch.int64)
    for m0 in range(0, M, bm):
        for n0 in range(0, N, bn):
            for ks in range(ksplits):
                k0, k1 = ks * kchunk * BK, min((ks + 1) * kchunk * BK, K)
                for us in range(usplits):
                    part = torch.zeros_like(y[m0:m0 + bm, n0:n0 + bn])
                    for u in range(us * uchunk, min((us + 1) * uchunk, steps)):
                        au = sign[m0:m0 + bm, k0:k1] * (mag[m0:m0 + bm, k0:k1] > u)
                        part += au @ bi[k0:k1, n0:n0 + bn]
                    y[m0:m0 + bm, n0:n0 + bn] += part
    return y.to(torch.int32)


@pytest.mark.parametrize("bits,mkn,sms", [(2, (13, 200, 150), 132), (4, (20, 130, 9), 132),
                                          (8, (8, 70, 8), 4), (1, (5, 64, 130), 132)])
def test_split_decomposition_matches_the_pallas_kernel(bits, mkn, sms):
    """Ragged M, N, K; -2**(w-1) in A; K and steps both split."""
    M, K, N = mkn
    rng = np.random.default_rng(40 + bits)
    a, b = _int(rng, (M, K), bits), _int(rng, (K, N), 8)
    want = np.asarray(jops.temporal_gemm(jnp.asarray(a), jnp.asarray(b), bitwidth=bits,
                                         impl="pallas_interpret"))
    got = _split_decomposition(torch.from_numpy(a), torch.from_numpy(b), bits, sms,
                               tile=(8, 8))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b)


def test_split_decomposition_saturates_like_the_pallas_kernel():
    rng = np.random.default_rng(41)
    a = rng.integers(-128, 128, (8, 48)).astype(np.int8)
    a[0, 0] = -128
    b = _int(rng, (48, 8), 2)
    want = np.asarray(jops.temporal_gemm(jnp.asarray(a), jnp.asarray(b), bitwidth=2,
                                         impl="pallas_interpret"))
    got = _split_decomposition(torch.from_numpy(a), torch.from_numpy(b), 2, sms=8,
                               tile=(8, 8))
    np.testing.assert_array_equal(got.numpy(), want)


def _prmt_sign(x):
    """prmt.b32 x, 0, 0xBA98: each byte's bit 7 replicated over the byte."""
    out = np.zeros_like(x)
    for i in range(4):
        out |= np.where((x >> np.uint32(8 * i + 7)) & np.uint32(1), np.uint32(0xFF << (8 * i)),
                        np.uint32(0))
    return out


def test_unary_step_bytes_are_the_thermometer_states():
    """The kernel's word arithmetic on packed A bytes (csrc/temporal_unary.cu:
    magnitude and sign bytes, then per step bit 7 of |a| + (127 - u)) gives
    sign(a)·1[u < |a|] for every int8 a and every step u < 128."""
    vals = np.arange(-128, 128, dtype=np.int64)
    words = (vals.reshape(-1, 4) & 0xFF).astype(np.uint32)
    raw = words[:, 0] | words[:, 1] << 8 | words[:, 2] << 16 | words[:, 3] << 24
    neg = _prmt_sign(raw)
    mag = (raw ^ neg) + (neg & np.uint32(0x01010101))
    nz = ((mag + np.uint32(0x7F7F7F7F)) & np.uint32(0x80808080)) >> np.uint32(7)
    sgn = neg | nz
    for u in range(128):
        au = _prmt_sign(mag + np.uint32(0x01010101 * (127 - u))) & sgn
        got = np.stack([(au >> np.uint32(8 * i)) & np.uint32(0xFF) for i in range(4)], 1)
        got = got.astype(np.int64).reshape(-1)
        got = np.where(got > 127, got - 256, got)
        np.testing.assert_array_equal(got, np.sign(vals) * (np.abs(vals) > u))
