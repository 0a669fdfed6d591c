"""Plain PyTorch versions of the fused GEMM's arithmetic.

``fused_gemm_ref`` is the function the CUDA kernel in ``tugemm_fused.py`` is
held against bit for bit (on the card) and what runs on CPU tensors; it
mirrors the reference's ``repro/kernels/ref.py::fused_gemm_ref`` op for op.
"""

from __future__ import annotations

import torch

from .packing import BITS_TO_PLANES, unpack_plane

__all__ = ["fused_gemm_ref", "int_matmul"]


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer product of two int8 carriers, as int32.

    CUDA has no integer ``matmul``; there the product runs in float64, which
    is exact here because ``K * 128**2 < 2**53`` for every K a layer has."""
    if a.device.type == "cpu":
        return torch.matmul(a.to(torch.int32), b.to(torch.int32))
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.int32)


def _dequant_bias(acc, sx, sw, bias, out_dtype):
    """Epilogue: int32 acc -> ``acc * (sx*sw)`` in f32 -> out dtype, then the
    bias added in the out dtype (separate multiply and add, never an FMA)."""
    y = (acc.to(torch.float32) * (sx * sw)).to(out_dtype)
    if bias is not None:
        y = y + bias.reshape(1, -1).to(out_dtype)
    return y


def _quant(x: torch.Tensor, s: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """round(x / s) (IEEE divide, half to even), clipped to [lo, hi]."""
    return torch.clamp(torch.round(x.to(torch.float32) / s), lo, hi).to(torch.int8)


def fused_gemm_ref(
    x: torch.Tensor,
    w: torch.Tensor,
    sx: torch.Tensor,
    sw: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    bits: int,
    w_mode: str = "quant",
    collect_stats: bool = False,
    out_dtype: torch.dtype = torch.float32,
):
    """``Y = clip(round(X/sx)) @ Wq · (sx·sw[n]) + bias``.

    x (M, planes·Kw) float; sx (1, 1) per-tensor or (M, 1) per-token f32;
    sw (1, N) f32. W by ``w_mode``: ``quant`` (Kw, N) float quantized with
    sw, ``int8`` (Kw, N) stored int8, ``packed`` (Kw, N) plane-packed
    int4/int2 whose plane p multiplies x columns ``[p·Kw, (p+1)·Kw)``.

    Returns y (M, N) ``out_dtype``, or (y, ca (planes, Kw), rb (Kw, planes))
    with ``ca[p, k] = max_m |Xq[m, p·Kw + k]|`` and
    ``rb[k, p] = max_n |Wq_p[k, n]|`` — the kernel's stats layout."""
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    Kw = w.shape[0]
    xq = _quant(x, sx, lo, hi)
    if w_mode == "packed":
        planes = BITS_TO_PLANES[bits]
        wq = torch.cat([unpack_plane(w, bits, p) for p in range(planes)], dim=0)
    elif w_mode == "quant":
        planes = 1
        wq = _quant(w, sw, lo, hi)
    elif w_mode == "int8":
        planes = 1
        wq = w
    else:
        raise ValueError(f"unknown w_mode {w_mode!r}")
    if xq.shape[1] != wq.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} does not match w {tuple(w.shape)} ({w_mode})")
    y = _dequant_bias(int_matmul(xq, wq), sx, sw, bias, out_dtype)
    if not collect_stats:
        return y
    ca = xq.to(torch.int32).abs().amax(dim=0).reshape(planes, Kw)
    rb = wq.to(torch.int32).abs().amax(dim=1).reshape(planes, Kw).t().contiguous()
    return y, ca, rb
