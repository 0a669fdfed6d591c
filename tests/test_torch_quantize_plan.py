"""The grid of ``csrc/quantize_sym.cu`` and the host side of its launch, on
the CPU: ``quantize_plan`` walked lane by lane in Python as the kernel walks
it (every (row, column) written exactly once, every 16-byte lane store
aligned, the scalar edge lane under 16 columns each side), the card filled at
the C1 path's shapes, and the host reciprocal of a number-valued scale equal
to PyTorch's f32 division bit for bit. The kernel itself runs only on the
card (``tests/test_torch_gpu_quantize.py``).
"""

import inspect

import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from repro_torch.kernels.quantize import host_reciprocal, quantize_plan

LANE = 16
SMS = 132
# the C1 path's 14 operand shapes on qwen3-0.6b: 7 weights (K, N) quantized
# per column, 7 activations (64, K) per tensor
C1_WEIGHTS = [(1024, 2048), (1024, 1024), (1024, 1024), (2048, 1024), (1024, 3072),
              (1024, 3072), (3072, 1024)]
C1_SHAPES = C1_WEIGHTS + [(64, K) for K, _ in C1_WEIGHTS]


def _walk(M, N, plan):
    """How many times the kernel writes each (row, column) under ``plan``,
    following its index arithmetic (``quantize_lanes`` and ``edge_lane``)."""
    gx, gy, tx, ty, u = plan
    cover = np.zeros((M, N), np.int32)
    L, ragged = N // LANE, N % LANE != 0
    rs = gy * ty

    def c0_of(r):        # the kernel's mask form of -r*N mod 16
        return (LANE - ((r * N) & (LANE - 1))) & (LANE - 1)

    def lanes_of(c0):
        return (N - c0) // LANE if N >= c0 else 0

    for lane in range(gx * tx):
        for r0 in range(min(gy * ty, M)):
            if ragged and lane == L:
                for r in range(r0, M, rs):
                    c0 = c0_of(r)
                    head, tail = min(c0, N), c0 + LANE * lanes_of(c0)
                    assert head < LANE and N - tail < LANE
                    cover[r, :head] += 1
                    cover[r, tail:] += 1
            elif lane < L:
                for r in range(r0, M, u * rs):
                    for k in range(u):
                        ru = r + k * rs
                        c0 = c0_of(ru) if ragged else 0
                        if ru >= M or (ragged and lane >= lanes_of(c0)):
                            continue
                        c = c0 + LANE * lane
                        assert c + LANE <= N and (ru * N + c) % LANE == 0
                        cover[ru, c:c + LANE] += 1
    return cover


@pytest.mark.parametrize("shape,sms", [
    ((64, 1024), SMS),      # an activation: 32-lane blocks
    ((512, 2048), SMS),     # aligned N, several rows a thread
    ((37, 333), SMS),       # ragged N
    ((333, 37), SMS),       # ragged N, every row offset differently
    ((64, 1004), SMS),      # the bf16 row pitch (2008 bytes) not 16-byte aligned
    ((40, 8), SMS),         # narrower than a lane: only the edge lane
    ((1, 1), SMS),
    ((1000, 333), 3),       # a small card: threads take several batches of rows
    ((3000, 4100), 4),      # more lanes than a block: two blocks across a row
])
def test_plan_covers_every_element_once(shape, sms):
    M, N = shape
    plan = quantize_plan(M, N, sms)
    gx, gy, tx, ty, u = plan
    assert 1 <= tx * ty <= 128 and 1 <= gy <= 65535 and u in (1, 2, 4)
    # the kernel stages a block's per-column inv, at most 17 columns a thread
    assert min(LANE * tx + LANE, N) <= 17 * tx * ty
    assert (_walk(M, N, plan) == 1).all()


@pytest.mark.parametrize("shape", [(0, 64), (64, 0), (0, 0)])
def test_plan_of_an_empty_tensor_launches_nothing(shape):
    gx, gy, *_ = quantize_plan(*shape, SMS)
    assert gx * gy == 0
    assert _walk(*shape, quantize_plan(*shape, SMS)).size == 0


@pytest.mark.parametrize("shape", C1_SHAPES)
def test_plan_fills_the_card_at_the_c1_shapes(shape):
    """Every SM gets a block wherever the work has a warp for each SM, and
    every thread takes one batch of rows."""
    M, N = shape
    gx, gy, tx, ty, u = quantize_plan(M, N, SMS)
    warps = -(-M * (N // LANE) // 32)
    assert gx * gy >= min(SMS, warps)
    assert gy * ty * u >= M
    if M > 64:
        assert gx * gy >= SMS


def test_plan_depends_on_shapes_only():
    assert list(inspect.signature(quantize_plan.__wrapped__).parameters) == ["M", "N", "sms"]
    before = [quantize_plan(M, N, SMS) for M, N in C1_SHAPES]
    quantize_plan.cache_clear()
    assert [quantize_plan.__wrapped__(M, N, SMS) for M, N in C1_SHAPES] == before


@settings(max_examples=300, deadline=None)
@given(st.floats(min_value=0.0, exclude_min=True, max_value=float(np.finfo(np.float32).max),
                 width=32, allow_nan=False, allow_infinity=False))
@example(1e-8 / 127)
@example(float(np.nextafter(np.float32(1e-8 / 127), np.float32(0))))
@example(float(np.nextafter(np.float32(1e-8 / 127), np.float32(1))))
@example(1e-8 / 7)
@example(1e-8)
@example(0.25)
@example(3.0)
def test_host_reciprocal_equals_torch_f32_division(scale):
    got = np.float32(host_reciprocal(scale))
    want = (1.0 / torch.tensor(scale, dtype=torch.float32)).numpy()
    assert got.view(np.uint32) == want.view(np.uint32)
