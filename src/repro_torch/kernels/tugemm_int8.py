"""Exact int8 GEMM with int32 accumulators: CUDA kernel + plain version.

Replaces ``repro/kernels/tugemm_int8.py::matmul_int8_pallas`` (the TPU
kernel, both its plain and its C-seeded body). The CUDA source is
``csrc/tugemm_int8.cu``, on the fused kernel's mainloop
(``csrc/tugemm_mainloop.cuh``) and split plan (``tugemm_fused.split_plan``
with one plane); its header says what bounds it on the card (reading B
once: device-memory bytes) and how its design answers that. With
``collect_stats`` the same launch also takes the tuGEMM step maxima of A
and B from its tiles (the TPU kernels ``colabsmax_pallas`` and
``rowabsmax_pallas``). ``tugemm_int8`` launches the kernel for CUDA tensors
and runs the plain version (``kernels/ref.py::matmul_int_ref``, with the
plain ``unary_stats.colabsmax`` / ``rowabsmax``) for CPU tensors or under
``impl="torch"``; both are exact, so they agree bit for bit. A leading
expert axis (the unfused MoE expert GEMMs: A (E, M, K), B (E, K, N)) runs
all E GEMMs in one launch, the expert folded into the grid's z axis as in
the fused kernel, each expert's maxima its own.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from ._launch import (KernelCount, charge_meta, check, meta_route, ptr, raise_on, sm_count,
                      stream_ptr)
from .ref import matmul_int_ref
from .tugemm_fused import split_plan
from .unary_stats import colabsmax, rowabsmax

__all__ = ["tugemm_int8", "COUNT"]

COUNT = KernelCount("tugemm_int8")
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = build.load("tugemm_int8")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.tugemm_int8_launch.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, vp]
        lib.tugemm_int8_launch.restype = ci
        _lib = lib
    return _lib


def tugemm_int8(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor | None = None, *,
                collect_stats: bool = False, impl: str = "auto"):
    """A (M, K) int8 · B (K, N) int8 [+ C (M, N) int32] -> (M, N) int32,
    exact. Any M, N, K: the kernel masks its ragged edges. With
    ``collect_stats`` (M, N, K > 0), (y, ca (1, K), rb (K, 1)) int32:
    ``ca[0, k] = max_m |A[m, k]|`` and ``rb[k, 0] = max_n |B[k, n]|``, the mainloop's
    plane-major stats layout at one plane (``unary_stats.tugemm_stats``
    assembles them).

    A leading expert axis gives every operand and result one: A (E, M, K),
    B (E, K, N), C (E, M, N); y (E, M, N), ca (E, 1, K), rb (E, K, 1). One
    launch (and one memset with stats) computes all E GEMMs.

    ``impl``: ``auto`` launches the kernel on CUDA tensors and runs the plain
    version on CPU tensors; ``torch`` runs the plain version anywhere;
    ``cuda`` insists on the kernel; on meta tensors (or ``meta``) the
    outputs are empty and the call is charged (``roofline.kernel_cost``)."""
    check(a.ndim == b.ndim and a.ndim in (2, 3) and a.shape[:-2] == b.shape[:-2],
          lambda: f"tugemm_int8: a {tuple(a.shape)}, b {tuple(b.shape)}: 2-D, or 3-D with "
                  "one expert axis")
    # the maxima over an empty M or N have no value (the plain reduction and
    # the reference's raise); the kernel would leave its zeroed buffer
    check(not collect_stats or (a.numel() > 0 and b.numel() > 0),
          lambda: f"tugemm_int8: stats of a {tuple(a.shape)} by b {tuple(b.shape)} need "
                  "M, N, K > 0")
    lead = tuple(a.shape[:-2])
    if meta_route(impl, a):
        return _meta(a, b, c, collect_stats)
    if impl == "torch" or (impl == "auto" and a.device.type == "cpu"):
        COUNT.plain_calls += 1
        y = matmul_int_ref(a, b, c)
        if not collect_stats:
            return y
        return (y, colabsmax(a, impl="torch").unsqueeze(-2),
                rowabsmax(b, impl="torch").unsqueeze(-1))
    check(a.device.type == "cuda",
          lambda: f"tugemm_int8: impl={impl!r} needs CUDA tensors")
    E = lead[0] if lead else 1
    M, K = a.shape[-2:]
    K2, N = b.shape[-2:]
    check(K == K2,
          lambda: f"tugemm_int8: a {tuple(a.shape)} does not match b {tuple(b.shape)}")
    check(a.dtype == torch.int8 and b.dtype == torch.int8,
          lambda: f"tugemm_int8: a {a.dtype}, b {b.dtype}; both must be int8")
    check(c is None or (c.dtype == torch.int32 and tuple(c.shape) == lead + (M, N)),
          lambda: f"tugemm_int8: c must be int32 of shape {lead + (M, N)}")
    for t in (a, b, c):
        check(t is None or (t.device == a.device and t.is_contiguous()),
              "tugemm_int8: every operand must be contiguous on a's device")
    y = torch.empty(lead + (M, N), dtype=torch.int32, device=a.device)
    # ca then rb in one buffer: the launcher zeroes it (one memset), the
    # kernel merges its maxima into it by atomicMax
    stats = (torch.empty(2 * E * K, dtype=torch.int32, device=a.device) if collect_stats
             else None)
    if M > 0 and N > 0 and E > 0:
        plan = split_plan(M, N, K, 1, sm_count(a.device), 1, E)
        rc = _load().tugemm_int8_launch(ptr(a), ptr(b), ptr(c), ptr(y), ptr(stats), E, M, N,
                                        K, int(collect_stats), *plan, stream_ptr(a.device))
        raise_on(rc, "tugemm_int8")
        COUNT.launches += 1
    if not collect_stats:
        return y
    return y, stats[:E * K].view(lead + (1, K)), stats[E * K:].view(lead + (K, 1))


def _meta(a, b, c, collect_stats):
    """The meta path: empty (y[, ca, rb]) and one charge at the kernel's count."""
    from ..roofline.kernel_cost import gemm_bytes_ops

    lead = tuple(a.shape[:-2])
    M, K = a.shape[-2:]
    N = b.shape[-1]
    y = torch.empty(lead + (M, N), dtype=torch.int32, device=a.device)
    outs = (y,)
    if collect_stats:
        outs += (torch.empty(lead + (1, K), dtype=torch.int32, device=a.device),
                 torch.empty(lead + (K, 1), dtype=torch.int32, device=a.device))
    E = lead[0] if lead else 1
    charge_meta(COUNT, gemm_bytes_ops((a, b, c), outs, M, K, N, E), y.shape)
    return outs if collect_stats else y
