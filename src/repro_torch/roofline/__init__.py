"""Roofline analysis from counted costs: the three terms of a step run on
``meta`` tensors (``op_cost``), priced on a hardware profile
(``analysis``); and the kernels' own counts (``kernel_cost``)."""

from .analysis import HW, HW_PROFILES, CollectiveStats, RooflineReport, analyze, hw_profile

__all__ = ["HW", "HW_PROFILES", "CollectiveStats", "RooflineReport", "analyze", "hw_profile"]
