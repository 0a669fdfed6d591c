"""Thermometer-decomposed (temporal-unary) exact GEMM: CUDA kernel + plain
version.

Replaces ``repro/kernels/temporal_unary.py::temporal_unary_gemm_pallas``
(the TPU kernel): ``A @ B`` as ``2**(w-1)`` masked accumulations
``sign(A)·1[u < |A|] @ B``, the paper's C1 validation path. The CUDA source
is ``csrc/temporal_unary.cu``; its header says what bounds it on the card
(the decomposition's operations, ``2**(w-1)`` times one int8 GEMM's) and how
its design answers that. ``temporal_unary_gemm`` launches the kernel for
CUDA tensors and runs the plain version (``kernels/ref.py::
temporal_unary_gemm_ref``, a plain GEMM that does not share the
decomposition's structure) for CPU tensors or under ``impl="torch"``.

In-range operands are the contract: on w-bit operands both compute A @ B
exactly. On operands outside the w-bit range the decomposition saturates
``|a|`` at ``2**(w-1)``, as the TPU kernel does, while the plain GEMM does
not; no range check is added (the reference has none).
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from ._launch import KernelCount, check, ptr, raise_on, stream_ptr
from .ref import temporal_unary_gemm_ref

__all__ = ["temporal_unary_gemm", "COUNT"]

COUNT = KernelCount("temporal_unary_gemm")
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = build.load("temporal_unary")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.temporal_unary_launch.argtypes = [vp, vp, vp, ci, ci, ci, ci, vp]
        lib.temporal_unary_launch.restype = ci
        _lib = lib
    return _lib


def temporal_unary_gemm(a: torch.Tensor, b: torch.Tensor, *, bitwidth: int,
                        impl: str = "auto") -> torch.Tensor:
    """A (M, K) · B (K, N) -> (M, N) int32 via ``2**(w-1)`` unary steps.
    The kernel takes int8 operands (``ops.temporal_gemm`` casts them, as the
    reference's wrapper does); any M, N, K: it masks its ragged edges.

    ``impl``: ``auto`` launches the kernel on CUDA tensors and runs the plain
    version on CPU tensors; ``torch`` runs the plain version anywhere;
    ``cuda`` insists on the kernel."""
    if impl not in ("auto", "torch", "cuda"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "torch" or (impl == "auto" and a.device.type == "cpu"):
        COUNT.plain_calls += 1
        return temporal_unary_gemm_ref(a, b, bitwidth)
    if bitwidth > 8:
        raise ValueError("temporal decomposition beyond 8 bits is impractical")
    check(a.device.type == "cuda", f"temporal_unary_gemm: impl={impl!r} needs CUDA tensors")
    check(bitwidth >= 1, f"temporal_unary_gemm: bitwidth {bitwidth} < 1")
    M, K = a.shape
    K2, N = b.shape
    check(K == K2, f"temporal_unary_gemm: a {tuple(a.shape)} does not match b {tuple(b.shape)}")
    check(a.dtype == torch.int8 and b.dtype == torch.int8,
          f"temporal_unary_gemm: a {a.dtype}, b {b.dtype}; both must be int8")
    check(a.is_contiguous() and b.is_contiguous() and b.device == a.device,
          "temporal_unary_gemm: both operands must be contiguous on one device")
    y = torch.empty((M, N), dtype=torch.int32, device=a.device)
    if M > 0 and N > 0:
        rc = _load().temporal_unary_launch(ptr(a), ptr(b), ptr(y), M, N, K,
                                           2 ** (bitwidth - 1), stream_ptr(a.device))
        raise_on(rc, "temporal_unary_gemm")
        COUNT.launches += 1
    return y
