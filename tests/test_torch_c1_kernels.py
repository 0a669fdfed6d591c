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
from repro_torch.kernels.ref import temporal_unary_gemm_ref

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
    assert len(counts) == 8
    assert counts["quantize_sym"] == {"launches": 0, "plain_calls": 1}
    assert counts["temporal_unary_gemm"] == {"launches": 0, "plain_calls": 1}


def test_cuda_path_without_a_card_raises_instead_of_falling_back():
    a = torch.zeros((2, 3), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        tops.temporal_gemm(a, a.t().contiguous(), bitwidth=4, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        tops.quantize_sym(torch.zeros((2, 3)), 1.0, bitwidth=4, impl="cuda")
