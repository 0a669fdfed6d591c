"""Exact int8 GEMM with int32 accumulators: CUDA kernel + plain version.

Replaces ``repro/kernels/tugemm_int8.py::matmul_int8_pallas`` (the TPU
kernel, both its plain and its C-seeded body). The CUDA source is
``csrc/tugemm_int8.cu``, on the fused kernel's mainloop
(``csrc/tugemm_mainloop.cuh``) and split plan (``tugemm_fused.split_plan``
with one plane); its header says what bounds it on the card (reading B
once: device-memory bytes) and how its design answers that.
``tugemm_int8`` launches the kernel for CUDA tensors and runs the plain
version (``kernels/ref.py::matmul_int_ref``) for CPU tensors or under
``impl="torch"``; both are exact, so they agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from ._launch import KernelCount, check, ptr, raise_on, sm_count, stream_ptr
from .ref import matmul_int_ref
from .tugemm_fused import split_plan

__all__ = ["tugemm_int8", "COUNT"]

COUNT = KernelCount("tugemm_int8")
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = build.load("tugemm_int8")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.tugemm_int8_launch.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp]
        lib.tugemm_int8_launch.restype = ci
        _lib = lib
    return _lib


def tugemm_int8(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor | None = None, *,
                impl: str = "auto") -> torch.Tensor:
    """A (M, K) int8 · B (K, N) int8 [+ C (M, N) int32] -> (M, N) int32,
    exact. Any M, N, K: the kernel masks its ragged edges.

    ``impl``: ``auto`` launches the kernel on CUDA tensors and runs the plain
    version on CPU tensors; ``torch`` runs the plain version anywhere;
    ``cuda`` insists on the kernel."""
    if impl not in ("auto", "torch", "cuda"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "torch" or (impl == "auto" and a.device.type == "cpu"):
        COUNT.plain_calls += 1
        return matmul_int_ref(a, b, c)
    check(a.device.type == "cuda",
          lambda: f"tugemm_int8: impl={impl!r} needs CUDA tensors")
    M, K = a.shape
    K2, N = b.shape
    check(K == K2,
          lambda: f"tugemm_int8: a {tuple(a.shape)} does not match b {tuple(b.shape)}")
    check(a.dtype == torch.int8 and b.dtype == torch.int8,
          lambda: f"tugemm_int8: a {a.dtype}, b {b.dtype}; both must be int8")
    check(c is None or (c.dtype == torch.int32 and tuple(c.shape) == (M, N)),
          lambda: f"tugemm_int8: c must be int32 of shape {(M, N)}")
    for t in (a, b, c):
        check(t is None or (t.device == a.device and t.is_contiguous()),
              "tugemm_int8: every operand must be contiguous on a's device")
    y = torch.empty((M, N), dtype=torch.int32, device=a.device)
    if M > 0 and N > 0:
        plan = split_plan(M, N, K, 1, sm_count(a.device))
        rc = _load().tugemm_int8_launch(ptr(a), ptr(b), ptr(c), ptr(y), M, N, K, *plan,
                                        stream_ptr(a.device))
        raise_on(rc, "tugemm_int8")
        COUNT.launches += 1
    return y
