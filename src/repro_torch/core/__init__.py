"""Cycle model and PPA/energy pricing of the tuGEMM unit."""

from .encoding import int_range, max_magnitude
from .report import slot_energy
from .tugemm import TuGemmStats, step_cycles

__all__ = ["TuGemmStats", "int_range", "max_magnitude", "slot_energy", "step_cycles"]
