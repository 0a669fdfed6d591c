"""Fused dynamic-quant tuGEMM linear layer: CUDA kernel + plain version.

Replaces ``repro/kernels/tugemm_fused.py::tugemm_fused_pallas`` (the TPU
kernel). The CUDA source is ``csrc/tugemm_fused.cu``; its header says what
bounds it on the card (reading W once: device-memory bytes) and how its
design answers that. ``tugemm_fused`` launches the kernel for CUDA tensors
and runs the plain version (``kernels/ref.py::fused_gemm_ref``) for CPU
tensors or under ``impl="torch"``; the two agree bit for bit, outputs and
stats.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from ._launch import DTYPE_CODE, KernelCount, check, ptr, raise_on, stream_ptr
from .packing import PLANES
from .ref import fused_gemm_ref

__all__ = ["tugemm_fused", "COUNT"]

COUNT = KernelCount("tugemm_fused")
_W_MODES = {"quant": 0, "int8": 1, "packed": 2}
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = build.load("tugemm_fused")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.tugemm_fused_launch.argtypes = [
            vp, ci, vp, ci, ci, vp, ci, vp, vp, vp, ci, vp, vp,
            ci, ci, ci, ci, ci, ci, vp,
        ]
        lib.tugemm_fused_launch.restype = ci
        _lib = lib
    return _lib


def tugemm_fused(
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
    impl: str = "auto",
):
    """``Y = clip(round(X/sx)) @ Wq · (sx·sw[n]) + bias`` in one pass.

    x (M, planes·Kw) f32/bf16; w (Kw, N): float for ``quant``, int8 for
    ``int8``, plane-packed int8 for ``packed`` (plane p multiplies x columns
    ``[p·Kw, (p+1)·Kw)``); sx (1, 1) per-tensor or (M, 1) per-token f32;
    sw (1, N) f32; bias (N,) or None. Returns y (M, N) ``out_dtype``, or
    (y, ca (planes, Kw), rb (Kw, planes)) int32 with ``collect_stats``.

    ``impl``: ``auto`` launches the kernel on CUDA tensors and runs the plain
    version on CPU tensors; ``torch`` runs the plain version anywhere;
    ``cuda`` insists on the kernel."""
    if impl not in ("auto", "torch", "cuda"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "torch" or (impl == "auto" and x.device.type == "cpu"):
        COUNT.plain_calls += 1
        return fused_gemm_ref(x, w, sx, sw, bias, bits=bits, w_mode=w_mode,
                              collect_stats=collect_stats, out_dtype=out_dtype)
    check(x.device.type == "cuda", f"tugemm_fused: impl={impl!r} needs CUDA tensors")
    planes = PLANES[bits] if w_mode == "packed" else 1
    M, Kx = x.shape
    Kw, N = w.shape
    dev = x.device
    check(w_mode in _W_MODES, f"unknown w_mode {w_mode!r}")
    check(bits in (2, 4, 8) and (w_mode != "packed" or bits < 8),
          f"bits={bits} with w_mode={w_mode!r}")
    check(Kx == planes * Kw, f"x {tuple(x.shape)} vs w {tuple(w.shape)} ({w_mode}, {bits}-bit)")
    check(x.dtype in (torch.float32, torch.bfloat16), f"x dtype {x.dtype}")
    check((w.dtype == torch.int8) == (w_mode != "quant") and w.dtype in DTYPE_CODE,
          f"w dtype {w.dtype} with w_mode={w_mode!r}")
    check(out_dtype in (torch.float32, torch.bfloat16), f"out dtype {out_dtype}")
    sx = sx.reshape(-1)
    sw = sw.reshape(-1)
    check(sx.dtype == torch.float32 and sx.numel() in (1, M), f"sx {tuple(sx.shape)} {sx.dtype}")
    check(sw.dtype == torch.float32 and sw.numel() == N, f"sw {tuple(sw.shape)} {sw.dtype}")
    per_token = sx.numel() == M and M > 1
    if bias is not None:
        bias = bias.reshape(-1).to(out_dtype).contiguous()
        check(bias.numel() == N, f"bias {tuple(bias.shape)}")
    for t in (x, w, sx, sw, bias):
        check(t is None or (t.device == dev and t.is_contiguous()),
              "tugemm_fused: every operand must be contiguous on x's device")
    y = torch.empty((M, N), dtype=out_dtype, device=dev)
    ca = rb = None
    if collect_stats:
        ca = torch.zeros((planes, Kw), dtype=torch.int32, device=dev)
        rb = torch.zeros((Kw, planes), dtype=torch.int32, device=dev)
    if M > 0 and N > 0:
        rc = _load().tugemm_fused_launch(
            ptr(x), DTYPE_CODE[x.dtype], ptr(w), _W_MODES[w_mode], DTYPE_CODE[w.dtype],
            ptr(sx), int(per_token), ptr(sw), ptr(bias), ptr(y), DTYPE_CODE[out_dtype],
            ptr(ca), ptr(rb), M, N, Kw, planes, bits, int(collect_stats), stream_ptr(dev),
        )
        raise_on(rc, "tugemm_fused")
        COUNT.launches += 1
    return (y, ca, rb) if collect_stats else y
