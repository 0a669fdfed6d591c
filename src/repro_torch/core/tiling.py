"""tuGEMM deployment planner: map large GEMM workloads onto tile arrays (the
port's own copy of the reference's planner).

The paper evaluates fixed 16×16 / 32×32 units; real layers are far larger.
Because the output array holds exact *binary* results, units cascade directly
(§II-B: "enables direct cascading of multiple tuGEMM units"). We model the
standard blocked decomposition: an (M, N, P) GEMM becomes
``ceil(M/S) · ceil(P/S)`` output tiles, each accumulating ``ceil(N/S)``
S×S-GEMM passes (the C-input port does the accumulation between passes).

This module generalizes the paper's §III-B latency evaluation into an edge
deployment planner ("beyond paper"): given a GEMM workload and a hardware
budget (number of units), report area / power / latency / energy, using
either worst-case or profiled average-case per-pass cycles.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from .latency import MaxValueProfile, average_case_cycles, worst_case_cycles
from .ppa import PPAReport, evaluate_ppa, ppa_model

__all__ = ["GemmTask", "TileConfig", "PlanReport", "plan_gemm", "plan_workload"]


@dataclass(frozen=True)
class GemmTask:
    """One GEMM in a workload: Y(M×P) = A(M×N) @ B(N×P), executed `count` times."""

    name: str
    M: int
    N: int
    P: int
    count: int = 1

    @property
    def macs(self) -> int:
        return self.M * self.N * self.P * self.count


@dataclass(frozen=True)
class TileConfig:
    variant: str = "serial"      # serial | parallel
    S: int = 16                  # tile dimension (square S×S unit)
    bitwidth: int = 8
    units: int = 1               # number of parallel tuGEMM units deployed


@dataclass
class PlanReport:
    tile: TileConfig
    tasks: list[GemmTask] = field(default_factory=list)
    total_passes: int = 0
    cycles: float = 0.0
    area_mm2: float = 0.0
    power_w: float = 0.0
    latency_s: float = 0.0
    energy_j: float = 0.0

    def __str__(self) -> str:  # pragma: no cover - formatting
        return (
            f"[{self.tile.variant} S={self.tile.S} w={self.tile.bitwidth} "
            f"units={self.tile.units}] passes={self.total_passes} "
            f"cycles={self.cycles:.3e} area={self.area_mm2:.3f}mm2 "
            f"power={self.power_w:.3f}W latency={self.latency_s*1e3:.3f}ms "
            f"energy={self.energy_j*1e3:.3f}mJ"
        )


def _passes(task: GemmTask, S: int) -> int:
    return (
        math.ceil(task.M / S) * math.ceil(task.P / S) * math.ceil(task.N / S)
    ) * task.count


def _per_pass_cycles(tile: TileConfig, profile: MaxValueProfile | None) -> float:
    if profile is None:
        return float(worst_case_cycles(tile.bitwidth, tile.S, tile.variant))
    return float(average_case_cycles(profile, tile.S, tile.variant))


def plan_gemm(
    task: GemmTask, tile: TileConfig, profile: MaxValueProfile | None = None
) -> PlanReport:
    """Plan a single GEMM task onto the tile array."""
    return plan_workload([task], tile, profile)


def plan_workload(
    tasks: list[GemmTask], tile: TileConfig, profile: MaxValueProfile | None = None
) -> PlanReport:
    """Plan a whole workload (e.g. every GEMM in one model forward pass).

    Passes are distributed round-robin over ``tile.units`` identical units;
    each unit is time-multiplexed over its share (perfect load balance —
    passes are homogeneous under the worst/avg-case cycle model).
    """
    model = ppa_model(tile.variant)
    per_pass = _per_pass_cycles(tile, profile)
    total_passes = sum(_passes(t, tile.S) for t in tasks)
    cycles = per_pass * math.ceil(total_passes / tile.units)
    clk = model.clock_hz(tile.bitwidth)
    unit: PPAReport = evaluate_ppa(
        tile.variant, tile.bitwidth, tile.S, tile.S, tile.S, cycles
    )
    return PlanReport(
        tile=tile,
        tasks=list(tasks),
        total_passes=total_passes,
        cycles=cycles,
        area_mm2=unit.area_mm2 * tile.units,
        power_w=unit.power_w * tile.units,
        latency_s=cycles / clk,
        energy_j=unit.power_w * tile.units * cycles / clk,
    )
