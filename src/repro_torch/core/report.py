"""Per-slot energy pricing of measured tuGEMM cycles (the part of the
reference's ``core/report.py`` that serving needs)."""

from __future__ import annotations

from .ppa import ppa_model

__all__ = ["slot_energy"]


def slot_energy(bits: int, variant: str, cycles: int) -> tuple[float, float]:
    """(latency_s, energy_j) for ``cycles`` on the paper's 16×16 evaluation
    unit — the per-slot accounting model (one shared unit, time-multiplexed
    across requests)."""
    m = ppa_model(variant)
    lat = cycles / m.clock_hz(bits)
    return lat, m.power_w(bits, 16, 16, 16) * lat
