"""Analytic Power-Performance-Area model calibrated to the paper's Table I.

Synthesis numbers cannot be executed in JAX; they are *modeled* (DESIGN.md
§2C). We fit, in log space, ``metric = c · S^alpha · w^beta`` per
(variant, metric) over all 12 Table-I datapoints (serial/parallel ×
{2,4,8}-bit × {16×16, 32×32}); max fit error ≤ 8.9 %, mean ≤ 5.5 %:

    serial   area ≈ 2.38e-5 · S^1.95 · w^1.10   (counter arrays: ∝ cells · w)
    serial   power≈ 9.00e-6 · S^1.95 · w^1.06
    parallel area ≈ 1.71e-4 · S^2.06 · w^0.65   (N-input adder tree per cell
    parallel power≈ 3.77e-5 · S^2.08 · w^0.71    dominates ⇒ sublinear in w)

Generalization beyond the square calibration points (documented assumption):
cells scale as M·P, and the parallel variant's replicated vector counters /
per-cell N-input adder trees scale linearly in N, so we use
``S_eff = sqrt(M·P)`` and multiply parallel metrics by ``N / S_eff`` (unity
at every calibration point, where M=N=P).

Clock model: synthesized at 400 MHz for 8-bit (the uGEMM comparison config);
the paper quotes average *delay* gains of 1.2× (serial) / 1.1× (parallel)
per 2× bit-width reduction — we scale the achievable clock accordingly.

uGEMM baseline constants (8-bit 16×16 @ 400 MHz) come straight from Table I.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

__all__ = [
    "TABLE1",
    "UGEMM_BASELINE",
    "PPAModel",
    "ppa_model",
    "PPAReport",
    "evaluate_ppa",
]

# ---- Paper data -------------------------------------------------------------
# (variant, S, bitwidth) -> (area mm^2, power W). 45 nm, post-synthesis.
TABLE1: dict[tuple[str, int, int], tuple[float, float]] = {
    ("serial", 16, 2): (0.011, 0.004),
    ("serial", 16, 4): (0.026, 0.009),
    ("serial", 16, 8): (0.052, 0.018),
    ("serial", 32, 2): (0.044, 0.016),
    ("serial", 32, 4): (0.099, 0.034),
    ("serial", 32, 8): (0.198, 0.068),
    ("parallel", 16, 2): (0.080, 0.018),
    ("parallel", 16, 4): (0.116, 0.034),
    ("parallel", 16, 8): (0.209, 0.053),
    ("parallel", 32, 2): (0.347, 0.083),
    ("parallel", 32, 4): (0.506, 0.145),
    ("parallel", 32, 8): (0.794, 0.202),
}

UGEMM_BASELINE = {"area_mm2": 0.770, "power_w": 0.200, "S": 16, "bitwidth": 8}

BASE_CLOCK_HZ = 400e6  # synthesis target at 8-bit (paper §III-A)
# paper §III-A: avg delay reduction per 2x bit-width reduction
DELAY_GAIN_PER_HALVING = {"serial": 1.2, "parallel": 1.1}


def _logfit(variant: str, idx: int) -> tuple[float, float, float]:
    pts = sorted((s, w) for (v, s, w) in TABLE1 if v == variant)
    X = np.array([[1.0, math.log(s), math.log(w)] for (s, w) in pts])
    y = np.log([TABLE1[(variant, s, w)][idx] for (s, w) in pts])
    coef, *_ = np.linalg.lstsq(X, y, rcond=None)
    return math.exp(coef[0]), float(coef[1]), float(coef[2])


@dataclass(frozen=True)
class PPAModel:
    """Calibrated analytic PPA model for one tuGEMM variant."""

    variant: str
    area_c: float
    area_alpha: float
    area_beta: float
    power_c: float
    power_alpha: float
    power_beta: float

    def area_mm2(self, bitwidth: int, M: int, N: int, P: int) -> float:
        s_eff = math.sqrt(M * P)
        a = self.area_c * s_eff**self.area_alpha * bitwidth**self.area_beta
        if self.variant == "parallel":
            a *= N / s_eff
        return a

    def power_w(self, bitwidth: int, M: int, N: int, P: int) -> float:
        s_eff = math.sqrt(M * P)
        p = self.power_c * s_eff**self.power_alpha * bitwidth**self.power_beta
        if self.variant == "parallel":
            p *= N / s_eff
        return p

    def clock_hz(self, bitwidth: int) -> float:
        halvings = math.log2(8 / bitwidth)
        return BASE_CLOCK_HZ * DELAY_GAIN_PER_HALVING[self.variant] ** halvings

    def energy_j(self, bitwidth: int, M: int, N: int, P: int, cycles: float) -> float:
        """Energy = power × time for a workload of ``cycles`` clock cycles."""
        return self.power_w(bitwidth, M, N, P) * cycles / self.clock_hz(bitwidth)


_MODELS: dict[str, PPAModel] = {}
for _v in ("serial", "parallel"):
    _ac, _aa, _ab = _logfit(_v, 0)
    _pc, _pa, _pb = _logfit(_v, 1)
    _MODELS[_v] = PPAModel(_v, _ac, _aa, _ab, _pc, _pa, _pb)


def ppa_model(variant: str) -> PPAModel:
    if variant not in _MODELS:
        raise KeyError(f"unknown tuGEMM variant {variant!r} (serial|parallel)")
    return _MODELS[variant]


@dataclass(frozen=True)
class PPAReport:
    variant: str
    bitwidth: int
    M: int
    N: int
    P: int
    area_mm2: float
    power_w: float
    clock_hz: float
    cycles: float
    latency_s: float
    energy_j: float


def evaluate_ppa(
    variant: str, bitwidth: int, M: int, N: int, P: int, cycles: float
) -> PPAReport:
    """Full PPA evaluation of one tuGEMM unit executing ``cycles`` cycles."""
    m = ppa_model(variant)
    clk = m.clock_hz(bitwidth)
    return PPAReport(
        variant=variant,
        bitwidth=bitwidth,
        M=M,
        N=N,
        P=P,
        area_mm2=m.area_mm2(bitwidth, M, N, P),
        power_w=m.power_w(bitwidth, M, N, P),
        clock_hz=clk,
        cycles=cycles,
        latency_s=cycles / clk,
        energy_j=m.energy_j(bitwidth, M, N, P, cycles),
    )
