"""Port parity for the unfused pipeline's kernels: ``repro_torch.kernels.ops``
``matmul_int8`` (with and without C), ``matmul_packed`` (int4 / int2, K not
a plane multiple) and ``unary_step_stats`` on CPU tensors, i.e. the plain
PyTorch versions of ``csrc/tugemm_int8.cu``, ``csrc/tugemm_packed.cu`` and
``csrc/unary_stats.cu``, against the reference's ``repro.kernels.ops`` —
its XLA twins and its Pallas kernels in interpret mode — on the same numpy
inputs. Every output is an integer and must be exact: ragged shapes and
operands holding -128 included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops
from repro_torch.kernels.packing import PLANES

torch.set_float32_matmul_precision("highest")
IMPLS = ["xla", "pallas_interpret"]
# (M, K, N): the decode-shaped M=1 GEMM, odd ragged shapes, a multi-block one
SHAPES = [(1, 5, 3), (7, 33, 19), (16, 64, 48), (130, 70, 36)]


def _int8(rng, shape, lo=-128, hi=127):
    a = rng.integers(lo, hi + 1, shape).astype(np.int8)
    a.flat[0] = lo        # the most negative code: |-128| must count 128
    return a


def _cases(shapes):
    """(impl, shape) pairs; interpret mode is python-slow, so it takes the
    shapes of at most 64 rows."""
    return [(impl, s) for impl in IMPLS for s in shapes
            if impl == "xla" or s[0] <= 64]


@pytest.mark.parametrize("with_c", [False, True])
@pytest.mark.parametrize("impl,shape", _cases(SHAPES))
def test_matmul_int8_matches_reference(impl, shape, with_c):
    M, K, N = shape
    rng = np.random.default_rng(M * 1000 + K)
    a, b = _int8(rng, (M, K)), _int8(rng, (K, N))
    c = rng.integers(-(2 ** 20), 2 ** 20, (M, N)).astype(np.int32) if with_c else None
    want = jops.matmul_int8(jnp.asarray(a), jnp.asarray(b),
                            None if c is None else jnp.asarray(c), impl=impl)
    got = tops.matmul_int8(torch.from_numpy(a), torch.from_numpy(b),
                           None if c is None else torch.from_numpy(c))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("impl", IMPLS)
def test_matmul_int8_stats_match_reference(impl):
    rng = np.random.default_rng(5)
    a, b = _int8(rng, (9, 40)), _int8(rng, (40, 24))
    jy, jst = jops.matmul_int8(jnp.asarray(a), jnp.asarray(b), collect_stats=True, impl=impl)
    ty, tst = tops.matmul_int8(torch.from_numpy(a), torch.from_numpy(b), collect_stats=True)
    np.testing.assert_array_equal(np.asarray(jy), ty.numpy())
    np.testing.assert_array_equal(np.asarray(jst.step_cycles), tst.step_cycles.numpy())
    for f in ("serial_cycles", "parallel_cycles", "max_abs", "act_max"):
        assert int(getattr(jst, f)) == int(getattr(tst, f)), f


@pytest.mark.parametrize("bits", [4, 2])
@pytest.mark.parametrize("impl,shape", _cases([(1, 5, 3), (7, 33, 19), (5, 200, 20),
                                               (130, 70, 36)]))
def test_matmul_packed_matches_reference(impl, shape, bits):
    M, K, N = shape
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    rng = np.random.default_rng(K * 10 + bits)
    a = _int8(rng, (M, K))
    wq = _int8(rng, (K, N), lo, hi)
    packed = np.array(jops.pack_weights(jnp.asarray(wq), bits))
    assert np.array_equal(packed, tops.pack_weights(torch.from_numpy(wq), bits).numpy())
    assert packed.shape[0] * PLANES[bits] >= K
    want = jops.matmul_packed(jnp.asarray(a), jnp.asarray(packed), bits=bits, impl=impl)
    got = tops.matmul_packed(torch.from_numpy(a), torch.from_numpy(packed), bits=bits)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    # and both equal the exact product with the unpacked weight
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ wq.astype(np.int64))


def test_matmul_packed_rejects_too_many_columns():
    a = torch.zeros((2, 9), dtype=torch.int8)
    with pytest.raises(ValueError):
        tops.matmul_packed(a, torch.zeros((2, 4), dtype=torch.int8), bits=4)


@pytest.mark.parametrize("impl,shape", _cases(SHAPES))
def test_unary_step_stats_match_reference(impl, shape):
    M, K, N = shape
    rng = np.random.default_rng(M + K + N)
    a, b = _int8(rng, (M, K)), _int8(rng, (K, N))
    b[-1, -1] = -128
    b[0] = 0              # an all-zero row of B: the step still costs its A max
    jst = jops.unary_step_stats(jnp.asarray(a), jnp.asarray(b), impl=impl)
    tst = tops.unary_step_stats(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(np.asarray(jst.step_cycles), tst.step_cycles.numpy())
    for f in ("serial_cycles", "parallel_cycles", "max_abs", "act_max"):
        assert int(getattr(jst, f)) == int(getattr(tst, f)), f
    assert int(tst.act_max) == 128


def test_plain_calls_are_counted_and_launches_are_not():
    tops.reset_counts()
    a = torch.ones((3, 4), dtype=torch.int8)
    tops.matmul_int8(a, a.t().contiguous(), collect_stats=True)
    tops.matmul_packed(a, torch.zeros((2, 5), dtype=torch.int8), bits=4)
    counts = tops.kernel_counts()
    assert set(counts) == {"tugemm_fused", "flash_paged_decode", "tugemm_int8",
                           "tugemm_packed", "colabsmax", "rowabsmax", "quantize_sym",
                           "temporal_unary_gemm", "tugemm_stats", "unary_step_stats"}
    for name in ("tugemm_int8", "tugemm_packed", "colabsmax", "rowabsmax"):
        assert counts[name] == {"launches": 0, "plain_calls": 1}, name


def test_dispatch_names_match_reference():
    rng = np.random.default_rng(0)
    a, b = _int8(rng, (4, 16)), _int8(rng, (16, 8))
    with jops.counting_dispatches() as jlog:
        jops.matmul_int8(jnp.asarray(a), jnp.asarray(b), collect_stats=True, impl="xla")
        jops.matmul_packed(jnp.asarray(a), jops.pack_weights(jnp.asarray(b // 64), 2),
                           bits=2, impl="xla")
    with tops.counting_dispatches() as tlog:
        tops.matmul_int8(torch.from_numpy(a), torch.from_numpy(b), collect_stats=True)
        tops.matmul_packed(torch.from_numpy(a),
                           tops.pack_weights(torch.from_numpy(b // 64), 2), bits=2)
    assert tlog == jlog == ["matmul_int8", "absmax_a", "absmax_b", "matmul_packed"]


# ------------------------------------- the int8 kernel's split-K cluster grid
from repro_torch.kernels.tugemm_fused import BM, KC, split_plan  # noqa: E402


def _int8_split_emulation(a, b, c, sms):
    """``csrc/tugemm_int8.cu``'s grid in torch: per (M tile, N tile) of
    ``split_plan`` (one plane) the int32 partial product of every K slice,
    summed, with C added once by the reducing rank, not by every slice."""
    M, K = a.shape
    N = b.shape[1]
    bn, splits, chunks = split_plan(M, N, K, 1, sms)
    y = torch.zeros((M, N), dtype=torch.int64)
    ai, bi = a.to(torch.int64), b.to(torch.int64)
    for m0 in range(0, M, BM):
        for n0 in range(0, N, bn):
            for s in range(splits):
                k0, k1 = s * chunks * KC, min((s + 1) * chunks * KC, K)
                y[m0:m0 + BM, n0:n0 + bn] += ai[m0:m0 + BM, k0:k1] @ bi[k0:k1, n0:n0 + bn]
    if c is not None:
        y += c.to(torch.int64)
    return y.to(torch.int32)   # int32 wraps as the kernel's sums do


@pytest.mark.parametrize("with_c", [False, True])
@pytest.mark.parametrize("shape,sms", [((37, 333, 65), 4), ((70, 130, 40), 2),
                                       ((4, 1024, 96), 132), ((64, 200, 300), 132)])
def test_int8_split_emulation_matches_the_pallas_kernel(shape, sms, with_c):
    M, K, N = shape
    rng = np.random.default_rng(M + K + N)
    a, b = _int8(rng, (M, K)), _int8(rng, (K, N))
    c = rng.integers(-(2 ** 20), 2 ** 20, (M, N)).astype(np.int32) if with_c else None
    assert split_plan(M, N, K, 1, sms)[1] > 1
    want = jops.matmul_int8(jnp.asarray(a), jnp.asarray(b),
                            None if c is None else jnp.asarray(c), impl="pallas_interpret")
    got = _int8_split_emulation(torch.from_numpy(a), torch.from_numpy(b),
                                None if c is None else torch.from_numpy(c), sms)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
