"""Quantization: symmetric dynamic scales, per-layer policies, the fused
GEMM backend and eager stats capture."""

from .policy import LayerRule, PolicyError, QuantPolicy, effective_policy
from .qlinear import BF16, GemmBackend, dense, gemm

__all__ = ["BF16", "GemmBackend", "LayerRule", "PolicyError", "QuantPolicy",
           "dense", "effective_policy", "gemm"]
