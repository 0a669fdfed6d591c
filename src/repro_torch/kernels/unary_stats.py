"""tuGEMM cycle-statistics reductions: CUDA kernels + plain versions.

Replaces ``repro/kernels/unary_stats.py::colabsmax_pallas`` and
``::rowabsmax_pallas`` (the TPU kernels). The CUDA source is
``csrc/unary_stats.cu``; its header says what bounds them on the card (one
read of the operand: device-memory bytes, near the launch cost at serving
sizes) and how the design answers that. ``colabsmax`` and ``rowabsmax``
launch their kernels for CUDA tensors and run the plain versions
(``kernels/ref.py::colabsmax_ref`` / ``rowabsmax_ref``) for CPU tensors or
under ``impl="torch"``; the maxima are exact, so the two agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from ._launch import KernelCount, check, ptr, raise_on, stream_ptr
from .ref import colabsmax_ref, rowabsmax_ref

__all__ = ["colabsmax", "rowabsmax", "COL_COUNT", "ROW_COUNT"]

COL_COUNT = KernelCount("colabsmax")
ROW_COUNT = KernelCount("rowabsmax")
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = build.load("unary_stats")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.colabsmax_launch.argtypes = [vp, vp, ci, ci, vp]
        lib.colabsmax_launch.restype = ci
        lib.rowabsmax_launch.argtypes = [vp, vp, ci, ci, ci, vp]
        lib.rowabsmax_launch.restype = ci
        _lib = lib
    return _lib


def _plain(x: torch.Tensor, impl: str) -> bool:
    if impl not in ("auto", "torch", "cuda"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "torch" or (impl == "auto" and x.device.type == "cpu"):
        return True
    check(x.device.type == "cuda", f"unary_stats: impl={impl!r} needs a CUDA tensor")
    check(x.dtype == torch.int8 and x.ndim == 2 and x.is_contiguous(),
          f"unary_stats: needs a contiguous 2-D int8 tensor, got {x.dtype} {tuple(x.shape)}")
    return False


def colabsmax(a: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """``max_m |A[m, k]|``: (M, K) int8 -> (K,) int32 (the A-side stats)."""
    if _plain(a, impl):
        COL_COUNT.plain_calls += 1
        return colabsmax_ref(a)
    M, K = a.shape
    out = torch.empty(K, dtype=torch.int32, device=a.device)
    if K > 0:
        raise_on(_load().colabsmax_launch(ptr(a), ptr(out), M, K, stream_ptr(a.device)),
                 "colabsmax")
        COL_COUNT.launches += 1
    return out


def rowabsmax(b: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """``max_n |B[k, n]|``: (K, N) int8 -> (K,) int32 (the B-side stats)."""
    if _plain(b, impl):
        ROW_COUNT.plain_calls += 1
        return rowabsmax_ref(b)
    K, N = b.shape
    out = torch.empty(K, dtype=torch.int32, device=b.device)
    if K > 0:
        vec16 = int(N % 16 == 0 and b.data_ptr() % 16 == 0)
        raise_on(_load().rowabsmax_launch(ptr(b), ptr(out), K, N, vec16,
                                          stream_ptr(b.device)), "rowabsmax")
        ROW_COUNT.launches += 1
    return out
