"""The plane-packed GEMM's grid on the split-K cluster mainloop
(``csrc/tugemm_packed.cu`` on ``csrc/tugemm_mainloop.cuh``), on the CPU: a
torch emulation of the kernel's blocks (M tile, N tile, K slice of packed
rows feeding every plane's columns of A, masked at A's width) summed as the
cluster sums them, held exactly against the reference's Pallas kernel in
interpret mode; and the split plans the packed and the one-plane GEMMs get
at the serving shapes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops
from repro_torch.kernels.packing import BITS_TO_PLANES, unpack_plane
from repro_torch.kernels.tugemm_fused import BM, KC, MAX_SPLITS, split_plan


def _int8(rng, shape, lo=-128, hi=127):
    a = rng.integers(lo, hi + 1, shape).astype(np.int8)
    a.flat[0] = lo        # the most negative code: |-128| must count 128
    return a


def _packed_split_emulation(a, pb, bits, sms):
    """The kernel's grid in torch: for each (M tile, N tile) of ``split_plan``
    (``planes = 8/bits``, Kw = packed rows), the int32 partial of every K
    slice (packed rows ``[s·chunks·64, (s+1)·chunks·64)``, each feeding
    plane p's columns ``p·Kp + k`` of A, read as zeros at or past A's width
    K) over all planes, summed as the cluster sums the partials."""
    planes = BITS_TO_PLANES[bits]
    M, K = a.shape
    Kp, N = pb.shape
    bn, splits, chunks = split_plan(M, N, Kp, planes, sms)
    assert (splits - 1) * chunks * KC < max(Kp, 1) <= splits * chunks * KC
    ai = torch.nn.functional.pad(a.to(torch.int64), (0, planes * Kp - K))   # the mask
    wq = [unpack_plane(pb, bits, p).to(torch.int64) for p in range(planes)]
    y = torch.zeros((M, N), dtype=torch.int64)
    for m0 in range(0, M, BM):
        for n0 in range(0, N, bn):
            for s in range(splits):
                k0, k1 = s * chunks * KC, min((s + 1) * chunks * KC, Kp)
                part = torch.zeros_like(y[m0:m0 + BM, n0:n0 + bn])
                for p in range(planes):
                    part += ai[m0:m0 + BM, p * Kp + k0:p * Kp + k1] @ wq[p][k0:k1, n0:n0 + bn]
                y[m0:m0 + BM, n0:n0 + bn] += part
    return y.to(torch.int32)   # int32 wraps as the kernel's sums do


# (M, K, N, logical rows of B (None: K), sms): K not a plane multiple, K and
# Kp off 16 bytes, A narrower than B's planes with and without 16-byte rows,
# one and several M tiles, the serve's down GEMM
CASES = [((37, 333, 65, None), 4), ((70, 600, 40, None), 2), ((4, 1024, 96, None), 132),
         ((64, 3072, 1024, None), 132), ((64, 1008, 96, 1024), 132), ((5, 1022, 70, 1024), 2)]


@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("shape,sms", CASES)
def test_packed_split_emulation_matches_the_pallas_kernel(shape, sms, bits):
    M, K, N, rows = shape
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    rng = np.random.default_rng(M + K + N + bits)
    a = _int8(rng, (M, K))
    wq = _int8(rng, (rows or K, N), lo, hi)
    pb = np.array(jops.pack_weights(jnp.asarray(wq), bits))
    planes = BITS_TO_PLANES[bits]
    assert K <= planes * pb.shape[0]
    assert split_plan(M, N, pb.shape[0], planes, sms)[1] > 1
    want = jops.matmul_packed(jnp.asarray(a), jnp.asarray(pb), bits=bits,
                              impl="pallas_interpret")
    got = _packed_split_emulation(torch.from_numpy(a), torch.from_numpy(pb), bits, sms)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    # and the wrapper's plain version, which the kernel is held to on the card
    np.testing.assert_array_equal(
        got.numpy(), tops.matmul_packed(torch.from_numpy(a), torch.from_numpy(pb),
                                        bits=bits).numpy())


# (K, N) of qwen3-0.6b's layer GEMMs: q, k/v, o, gate/up, down
LAYER_SHAPES = [(1024, 2048), (1024, 1024), (2048, 1024), (1024, 3072), (3072, 1024)]
# the one-plane plans (fused quant / int8 weights, the int8 GEMM) measured in
# the split-K mainloop's redesign, at M = 64, 32 and 4 alike
ONE_PLANE = [(128, 8, 2), (128, 16, 1), (128, 16, 2), (128, 8, 2), (128, 16, 3)]


@pytest.mark.parametrize("xbytes", [1, 2, 4])
@pytest.mark.parametrize("M", [64, 32, 4])
@pytest.mark.parametrize("kn,plan", list(zip(LAYER_SHAPES, ONE_PLANE)))
def test_one_plane_plans_are_pinned(M, kn, plan, xbytes):
    """X's element size does not move a one-plane plan."""
    K, N = kn
    assert split_plan(M, N, K, 1, 132, xbytes) == plan


# the packed plans at the plan sweep's shapes (K, N, bits, X bytes): the
# packed GEMM's int8 X, the fused kernel's bf16 X (the MLP's shapes, and
# the attention's o, q and k packed); the same at M = 64 and 4
PACKED = [((1024, 3072, 2, 1), (128, 4, 1)), ((3072, 1024, 2, 1), (64, 12, 1)),
          ((1024, 3072, 4, 1), (128, 8, 1)), ((1024, 3072, 2, 2), (128, 4, 1)),
          ((3072, 1024, 2, 2), (64, 6, 2)), ((1024, 3072, 4, 2), (128, 8, 1)),
          ((3072, 1024, 4, 1), (64, 12, 2)), ((3072, 1024, 4, 2), (64, 12, 2)),
          ((2048, 1024, 2, 2), (128, 8, 1)), ((1024, 2048, 4, 2), (128, 8, 1)),
          ((1024, 1024, 4, 2), (128, 8, 1))]


@pytest.mark.parametrize("M", [64, 4])
@pytest.mark.parametrize("shape,plan", PACKED)
def test_packed_plans_are_pinned(M, shape, plan):
    K, N, bits, xbytes = shape
    planes = BITS_TO_PLANES[bits]
    assert split_plan(M, N, K // planes, planes, 132, xbytes) == plan


@pytest.mark.parametrize("M", [64, 4])
@pytest.mark.parametrize("K,N,bits", [(1024, 3072, 2), (3072, 1024, 2), (1024, 3072, 4)])
def test_packed_plans_cover_every_chunk_and_reach_half_the_card(M, K, N, bits):
    """The serve's packed MLP shapes (Kw = K / planes packed rows): every
    64-row chunk in exactly one block, no idle block, at least half the 132
    SMs busy, clusters within the kernel's 16."""
    planes = BITS_TO_PLANES[bits]
    Kp = K // planes
    bn, splits, chunks = split_plan(M, N, Kp, planes, 132)
    k_chunks = -(-Kp // KC)
    assert bn in (32, 64, 128) and 1 <= splits <= MAX_SPLITS
    assert (splits - 1) * chunks < k_chunks <= splits * chunks
    assert splits * -(-N // bn) * -(-M // BM) >= 66
