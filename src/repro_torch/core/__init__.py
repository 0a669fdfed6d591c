"""tuGEMM core: the paper's contribution as a composable PyTorch library.

- ``encoding``      temporal-unary / thermometer codes (C1)
- ``tugemm``        exact integer GEMM + data-dependent cycle statistics
- ``cycle_sim``     cycle-accurate golden model of the counter architecture (C2, C3)
- ``latency``       analytic worst/average-case latency (§III-B)
- ``ppa``           area/power/clock model calibrated to Table I (C4)
- ``report``        captured GEMM stats -> PPA/energy report
- ``ugemm_baseline`` stochastic rate-coded GEMM baseline (uGEMM [21])
- ``tiling``        deployment planner: big GEMMs onto tuGEMM tile arrays
"""

from .encoding import (
    int_range,
    max_magnitude,
    temporal_bitstream,
    thermometer_decode,
    thermometer_encode,
)
from .latency import (
    MaxValueProfile,
    average_case_cycles,
    seconds,
    worst_case_cycles,
)
from .ppa import TABLE1, UGEMM_BASELINE, PPAModel, PPAReport, evaluate_ppa, ppa_model
from .report import EnergyReport, LayerEnergy, energy_report, slot_energy, ugemm_comparison
from .tiling import GemmTask, PlanReport, TileConfig, plan_gemm, plan_workload
from .tugemm import TuGemmStats, step_cycles, tugemm, validate_range
from .ugemm_baseline import stochastic_stream, ugemm_stochastic

__all__ = [
    "int_range",
    "max_magnitude",
    "temporal_bitstream",
    "thermometer_decode",
    "thermometer_encode",
    "MaxValueProfile",
    "average_case_cycles",
    "seconds",
    "worst_case_cycles",
    "TABLE1",
    "UGEMM_BASELINE",
    "PPAModel",
    "PPAReport",
    "evaluate_ppa",
    "ppa_model",
    "EnergyReport",
    "LayerEnergy",
    "energy_report",
    "slot_energy",
    "ugemm_comparison",
    "GemmTask",
    "PlanReport",
    "TileConfig",
    "plan_gemm",
    "plan_workload",
    "TuGemmStats",
    "step_cycles",
    "tugemm",
    "validate_range",
    "stochastic_stream",
    "ugemm_stochastic",
]
