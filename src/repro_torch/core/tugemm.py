"""Functional tuGEMM op: exact integer GEMM + hardware latency statistics.

This is the mathematical contract of the tuGEMM hardware: ``Y = A @ B + C``
computed exactly in integers, together with the data-dependent cycle counts
the serial/parallel micro-architectures would take on this input.

Cycle model (validated cycle for cycle against ``core.cycle_sim``): step
``i`` of ``A (M, K) @ B (K, N)`` is one outer product; it drains in
``max_m |A[m,i]| * max(max_n |B[i,n]|, 1)`` cycles (the ``max(., 1)``
covers a whole B row of zeros: the column counters then drain one per
cycle). The serial unit sums the steps, the parallel unit takes their
maximum (paper §III-B). Worst case: ``K * (2**(w-1))**2`` serial.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.ref import int_matmul
from .encoding import max_magnitude

__all__ = ["TuGemmStats", "tugemm", "step_cycles", "validate_range"]


class TuGemmStats(NamedTuple):
    """Data-dependent hardware statistics for one (possibly batched) GEMM."""

    step_cycles: torch.Tensor      # (..., K) cycles per outer-product step
    serial_cycles: torch.Tensor    # (...,)   total cycles, serial variant
    parallel_cycles: torch.Tensor  # (...,)   total cycles, parallel variant
    max_abs: torch.Tensor          # (...,)   max |value| over A and B (Fig 5 statistic)
    act_max: torch.Tensor | None = None  # (...,) max |A| alone


def validate_range(x: torch.Tensor, bitwidth: int) -> torch.Tensor:
    """True (a bool tensor) iff every element of ``x`` is representable in
    w-bit two's complement."""
    m = max_magnitude(bitwidth)
    xi = x.to(torch.int32)
    return ((xi >= -m) & (xi <= m - 1)).all()


def step_cycles(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Per-step cycle counts. A: (..., M, K), B: (..., K, N) -> (..., K)."""
    max_a = A.to(torch.int32).abs().amax(dim=-2)
    max_b = B.to(torch.int32).abs().amax(dim=-1)
    return max_a * max_b.clamp_min(1)


def tugemm(
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor | None = None,
    *,
    collect_stats: bool = True,
) -> tuple[torch.Tensor, TuGemmStats | None]:
    """Exact integer GEMM ``Y = A @ B + C`` with tuGEMM cycle statistics.

    A: (..., M, K) int, B: (..., K, N) int, C: (..., M, N) int or None, of
    any integer dtype (nothing is narrowed to int8); leading axes batch.
    Y is int32: the hardware's output counters hold ``K * (2**(w-1))**2 +
    |C|`` without wrapping for w <= 8, K <= 2**14.

    The product is a plain one (``kernels/ref.py::int_matmul``): int32 on
    the CPU; on the card, where there is no integer ``matmul``, float64,
    which is exact while ``K * max|A| * max|B| < 2**53``."""
    a = A.to(torch.int32)
    b = B.to(torch.int32)
    y = int_matmul(a, b)
    if C is not None:
        y = y + C.to(torch.int32)
    if not collect_stats:
        return y, None
    sc = step_cycles(a, b)
    amax_a = a.abs().amax(dim=(-1, -2))
    stats = TuGemmStats(
        step_cycles=sc,
        serial_cycles=sc.sum(dim=-1, dtype=torch.int32),
        parallel_cycles=sc.amax(dim=-1),
        max_abs=torch.maximum(amax_a, b.abs().amax(dim=(-1, -2))),
        act_max=amax_a,
    )
    return y, stats
