"""Quantization: symmetric scales, per-layer policies, the fused and the
legacy unfused GEMM backends, offline prequantization (surgery), eager
stats capture and the debug stats collector."""

from .policy import LayerRule, PolicyError, QuantPolicy, ResolvedPolicy, effective_policy
from .qlinear import BF16, GemmBackend, QBits, dense, gemm, prequantize_tree
from .quantize import QuantConfig, compute_scale, dequantize, fake_quant, quantize
from .surgery import (
    apply_surgery,
    draft_quant_view,
    forward_with_stats,
    plan_surgery,
    validate_runtime_policy,
)

__all__ = ["BF16", "GemmBackend", "LayerRule", "PolicyError", "QBits", "QuantConfig",
           "QuantPolicy", "ResolvedPolicy", "apply_surgery", "compute_scale", "dense",
           "dequantize", "draft_quant_view", "effective_policy", "fake_quant",
           "forward_with_stats", "gemm", "plan_surgery", "prequantize_tree", "quantize",
           "validate_runtime_policy"]
