"""Symmetric w-bit quantization by a reciprocal scale: CUDA kernel + plain
version.

Replaces ``repro/kernels/quantize.py::quantize_sym_pallas`` (the TPU
kernel). The CUDA source is ``csrc/quantize_sym.cu``; its header says what
bounds it on the card (one read of x, one write of the codes: bytes) and
how its design answers that. ``quantize_sym`` launches the kernel for CUDA
tensors and runs the plain version (``kernels/ref.py::quantize_sym_ref``)
for CPU tensors or under ``impl="torch"``; both round the same f32 product
half to even, so they agree bit for bit (NaN inputs are outside the
contract).
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from ._launch import DTYPE_CODE, KernelCount, check, ptr, raise_on, stream_ptr
from .ref import quantize_sym_ref

__all__ = ["quantize_sym", "COUNT"]

COUNT = KernelCount("quantize_sym")
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = build.load("quantize_sym")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.quantize_sym_launch.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, vp]
        lib.quantize_sym_launch.restype = ci
        _lib = lib
    return _lib


def quantize_sym(x: torch.Tensor, inv_scale: torch.Tensor, *, bitwidth: int,
                 impl: str = "auto") -> torch.Tensor:
    """``clip(round(x · inv_scale))`` to the w-bit range as int8: x (M, N)
    f32 or bf16, inv_scale (1, N) f32. Any M, N: the kernel needs no padding.

    ``impl``: ``auto`` launches the kernel on CUDA tensors and runs the plain
    version on CPU tensors; ``torch`` runs the plain version anywhere;
    ``cuda`` insists on the kernel."""
    if impl not in ("auto", "torch", "cuda"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "torch" or (impl == "auto" and x.device.type == "cpu"):
        COUNT.plain_calls += 1
        return quantize_sym_ref(x, inv_scale, bitwidth)
    check(x.device.type == "cuda", f"quantize_sym: impl={impl!r} needs CUDA tensors")
    check(x.ndim == 2 and x.dtype in (torch.float32, torch.bfloat16) and x.is_contiguous(),
          f"quantize_sym: x must be a contiguous 2-D f32 or bf16 tensor, got {x.dtype} "
          f"{tuple(x.shape)}")
    M, N = x.shape
    check(inv_scale.dtype == torch.float32 and tuple(inv_scale.shape) == (1, N)
          and inv_scale.is_contiguous() and inv_scale.device == x.device,
          f"quantize_sym: inv_scale must be contiguous f32 of shape {(1, N)} on x's device")
    check(1 <= bitwidth <= 8, f"quantize_sym: bitwidth {bitwidth} does not fit an int8 carrier")
    q = torch.empty((M, N), dtype=torch.int8, device=x.device)
    if M > 0 and N > 0:
        vec = 16 // x.element_size()
        vec16 = int(N % vec == 0 and x.data_ptr() % 16 == 0)
        raise_on(_load().quantize_sym_launch(ptr(x), ptr(inv_scale), ptr(q), M, N, bitwidth,
                                             DTYPE_CODE[x.dtype], vec16, stream_ptr(x.device)),
                 "quantize_sym")
        COUNT.launches += 1
    return q
