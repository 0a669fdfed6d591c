"""Symmetric quantization: dynamic scales, and the standalone quantize /
dequantize passes of the unfused pipeline and of offline weight packing.

Every scale flows through :func:`amax_to_scale`, which multiplies by the
precomputed reciprocal of the top code (``amax * (1/hi)``) exactly as the
reference does (``repro/quant/quantize.py``), so the port's scales — and
with them every quantized carrier — are bit-identical to the reference's.
"""

from __future__ import annotations

import torch

from ..core.encoding import int_range

__all__ = ["int_range", "compute_scale", "raw_amax", "amax_to_scale", "fused_scales",
           "quantize", "dequantize"]


def raw_amax(x: torch.Tensor, *, axis: int | None = None) -> torch.Tensor:
    """max |x| over everything (axis=None) or over every dim but ``axis``,
    as f32. One reduction in x's own dtype (the inf-norm): |x| and max are
    exact in any float format, so widening the result afterwards equals
    the reference's widen-then-reduce without an f32 copy of x."""
    dims = None if axis is None else tuple(i for i in range(x.ndim) if i != axis)
    return torch.linalg.vector_norm(x, ord=float("inf"), dim=dims).to(torch.float32)


def amax_to_scale(amax: torch.Tensor, bits: int) -> torch.Tensor:
    """amax -> symmetric scale: ``max(amax, 1e-8) * (1/hi)`` (reciprocal
    multiply, the reference's pinned form)."""
    _, hi = int_range(bits)
    return amax.clamp_min(1e-8) * (1.0 / hi)


def compute_scale(x: torch.Tensor, bits: int, *, axis: int | None = None) -> torch.Tensor:
    """Absmax scale: per-tensor scalar (axis=None) or one per slice along
    ``axis``."""
    return amax_to_scale(raw_amax(x, axis=axis), bits)


def fused_scales(x: torch.Tensor, w: torch.Tensor, bits: int,
                 per_token: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Activation scale (scalar, or per-row (M,) with ``per_token``) and the
    per-out-channel weight scale (N,) of a dynamic-quant linear layer."""
    sx = compute_scale(x, bits, axis=0 if per_token else None)
    return sx, compute_scale(w, bits, axis=1)


def quantize(x: torch.Tensor, scale, bits: int) -> torch.Tensor:
    """``clip(round(x / scale))`` to the w-bit two's-complement range, as
    int8: an f32 IEEE divide, rounded half to even — the fused kernel's own
    quantizer, so the unfused and fused pipelines agree bit for bit."""
    lo, hi = int_range(bits)
    q = torch.round(x.to(torch.float32) / scale)
    return torch.clamp(q, lo, hi).to(torch.int8)


def dequantize(q: torch.Tensor, scale) -> torch.Tensor:
    return q.to(torch.float32) * scale
