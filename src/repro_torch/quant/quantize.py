"""Symmetric quantization: dynamic scales, and the standalone quantize /
dequantize passes of the unfused pipeline and of offline weight packing.

Every scale flows through :func:`amax_to_scale`, which multiplies by the
precomputed reciprocal of the top code (``amax * (1/hi)``) exactly as the
reference does (``repro/quant/quantize.py``), so the port's scales — and
with them every quantized carrier — are bit-identical to the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.encoding import int_range

__all__ = ["QuantConfig", "int_range", "compute_scale", "raw_amax", "amax_to_scale",
           "fused_scales", "act_scale", "weight_scale", "quantize", "dequantize", "fake_quant"]


@dataclass(frozen=True)
class QuantConfig:
    bits: int = 8
    per_channel: bool = True        # scale per output channel (weights) / feature
    percentile: float = 100.0       # 100 = absmax calibration
    mode: str = "dynamic"           # dynamic | prequant (weights packed offline)

    def __post_init__(self):
        if self.bits not in (2, 4, 8):
            raise ValueError(f"bits must be one of 2/4/8, got {self.bits}")


def raw_amax(x: torch.Tensor, *, axis: int | tuple | None = None) -> torch.Tensor:
    """max |x| over everything (axis=None) or over every dim but ``axis``
    (one kept dim, or a tuple of them), as f32. One reduction in x's own
    dtype (the inf-norm): |x| and max are exact in any float format, so
    widening the result afterwards equals the reference's
    widen-then-reduce without an f32 copy of x."""
    keep = () if axis is None else (axis,) if isinstance(axis, int) else tuple(axis)
    dims = tuple(i for i in range(x.ndim) if i not in keep)
    if not dims:
        return x.abs().to(torch.float32)
    return torch.linalg.vector_norm(x, ord=float("inf"), dim=dims).to(torch.float32)


def amax_to_scale(amax: torch.Tensor, bits: int) -> torch.Tensor:
    """amax -> symmetric scale: ``max(amax, 1e-8) * (1/hi)`` (reciprocal
    multiply, the reference's pinned form)."""
    _, hi = int_range(bits)
    return amax.clamp_min(1e-8) * (1.0 / hi)


def compute_scale(x: torch.Tensor, bits: int, *, axis: int | tuple | None = None
                  ) -> torch.Tensor:
    """Absmax scale: per-tensor scalar (axis=None) or one per slice along
    ``axis`` (a tuple: along each of those axes)."""
    return amax_to_scale(raw_amax(x, axis=axis), bits)


def fused_scales(x: torch.Tensor, w: torch.Tensor, bits: int,
                 per_token: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Activation scale (scalar, or per-row (M,) with ``per_token``) and the
    per-out-channel weight scale (N,) of a dynamic-quant linear layer.

    With a leading expert axis (x (E, M, K), w (E, K, N): the MoE expert
    GEMMs) each expert gets its own scales, as the reference's vmapped
    ``dense`` computes them: sx (E,) over that expert's whole dispatch
    buffer, zero-filled empty slots included (an expert that received no
    token has amax 0, which ``amax_to_scale`` clamps), or (E, M) per token;
    sw (E, N)."""
    return act_scale(x, bits, per_token), weight_scale(w, bits)


def weight_scale(w: torch.Tensor, bits: int) -> torch.Tensor:
    """The per-out-channel weight scale of w (K, N): (N,); of an expert
    stack w (E, K, N): (E, N)."""
    return compute_scale(w, bits, axis=(*range(w.ndim - 2), w.ndim - 1))


def act_scale(x: torch.Tensor, bits: int, per_token: bool = False) -> torch.Tensor:
    """The activation scale of x (M, K): a scalar, or (M,) per token; of an
    expert stack x (E, M, K): (E,), or (E, M) per token."""
    return compute_scale(x, bits, axis=tuple(range(x.ndim - 2 + per_token)))


def quantize(x: torch.Tensor, scale, bits: int) -> torch.Tensor:
    """``clip(round(x / scale))`` to the w-bit two's-complement range, as
    int8: an f32 IEEE divide, rounded half to even — the fused kernel's own
    quantizer, so the unfused and fused pipelines agree bit for bit."""
    lo, hi = int_range(bits)
    q = torch.round(x.to(torch.float32) / scale)
    return torch.clamp(q, lo, hi).to(torch.int8)


def dequantize(q: torch.Tensor, scale) -> torch.Tensor:
    return q.to(torch.float32) * scale


def fake_quant(x: torch.Tensor, bits: int, *, axis: int | None = None) -> torch.Tensor:
    """Quantize-dequantize (the straight-through value), in x's dtype; per
    tensor, or one scale per slice along ``axis``."""
    s = compute_scale(x, bits, axis=axis)
    if axis is not None:
        shape = [1] * x.ndim
        shape[axis] = x.shape[axis]
        s = s.reshape(shape)
    return dequantize(quantize(x, s, bits), s).to(x.dtype)
