"""tuGEMM cycle statistics (the hardware's data-dependent latency model).

Step ``i`` of ``A (M, K) @ B (K, N)`` is one outer product; it drains in
``max_m |A[m,i]| * max(max_n |B[i,n]|, 1)`` cycles. The serial unit sums the
steps, the parallel unit takes their maximum (paper §III-B)."""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["TuGemmStats", "step_cycles"]


class TuGemmStats(NamedTuple):
    """Data-dependent hardware statistics for one GEMM."""

    step_cycles: torch.Tensor      # (K,) cycles per outer-product step
    serial_cycles: torch.Tensor    # ()   total cycles, serial variant
    parallel_cycles: torch.Tensor  # ()   total cycles, parallel variant
    max_abs: torch.Tensor          # ()   max |value| over A and B (Fig 5 statistic)
    act_max: torch.Tensor | None = None  # () max |A| alone


def step_cycles(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Per-step cycle counts. A: (..., M, K), B: (..., K, N) -> (..., K)."""
    max_a = A.to(torch.int32).abs().amax(dim=-2)
    max_b = B.to(torch.int32).abs().amax(dim=-1)
    return max_a * max_b.clamp_min(1)
