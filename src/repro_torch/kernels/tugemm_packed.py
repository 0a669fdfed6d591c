"""Exact int8 x plane-packed int4/int2 GEMM: CUDA kernel + plain version.

Replaces ``repro/kernels/tugemm_packed.py::matmul_packed_pallas`` (the TPU
kernel). The CUDA source is ``csrc/tugemm_packed.cu``, on the fused and int8
kernels' mainloop (``csrc/tugemm_mainloop.cuh``) and split plan
(``tugemm_fused.split_plan`` with ``planes = 8/bits``); its header says what
bounds it on the card (reading the packed weight once: device-memory bytes)
and how its design answers that. ``tugemm_packed`` launches the kernel for
CUDA tensors and runs the plain version (zero-extend A, unpack the planes,
``kernels/ref.py::packed_matmul_ref``) for CPU tensors or under
``impl="torch"``; both are exact, so they agree bit for bit. A leading
expert axis (the unfused prequant MoE expert GEMMs: A (E, M, K), packed B
(E, Kp, N)) runs all E GEMMs in one launch, the expert folded into the
grid's z axis.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from ._launch import (KernelCount, charge_meta, check, meta_route, ptr, raise_on, sm_count,
                      stream_ptr)
from .packing import BITS_TO_PLANES
from .ref import packed_matmul_ref
from .tugemm_fused import split_plan

__all__ = ["tugemm_packed", "COUNT"]

COUNT = KernelCount("tugemm_packed")
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = build.load("tugemm_packed")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.tugemm_packed_launch.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, ci, vp]
        lib.tugemm_packed_launch.restype = ci
        _lib = lib
    return _lib


def tugemm_packed(a: torch.Tensor, packed_b: torch.Tensor, *, bits: int,
                  impl: str = "auto") -> torch.Tensor:
    """A (M, K) int8 · plane-packed B (Kp, N) -> (M, N) int32, exact.

    Plane p of packed row k is logical row ``k + p·Kp`` (``pack_planes``
    layout); A may have fewer than ``planes·Kp`` columns, the missing ones
    count as zeros (``pack_weights`` pads K the same way). A leading expert
    axis, A (E, M, K) and B (E, Kp, N), gives y (E, M, N) from one launch.

    ``impl``: ``auto`` launches the kernel on CUDA tensors and runs the plain
    version on CPU tensors; ``torch`` runs the plain version anywhere;
    ``cuda`` insists on the kernel; on meta tensors (or ``meta``) the
    outputs are empty and the call is charged (``roofline.kernel_cost``)."""
    meta = meta_route(impl, a)
    check(bits in BITS_TO_PLANES, lambda: f"tugemm_packed: bits={bits}; packed weights are 4 or 2 bits")
    check(a.ndim == packed_b.ndim and a.ndim in (2, 3) and a.shape[:-2] == packed_b.shape[:-2],
          lambda: f"tugemm_packed: a {tuple(a.shape)}, packed b {tuple(packed_b.shape)}: 2-D, "
                  "or 3-D with one expert axis")
    planes = BITS_TO_PLANES[bits]
    lead = tuple(a.shape[:-2])
    M, K = a.shape[-2:]
    Kp, N = packed_b.shape[-2:]
    check(K <= planes * Kp,
          lambda: f"tugemm_packed: a {tuple(a.shape)} has more columns than packed b "
          f"{tuple(packed_b.shape)} holds at {bits} bits")
    if meta:
        from ..roofline.kernel_cost import gemm_bytes_ops

        y = torch.empty(lead + (M, N), dtype=torch.int32, device=a.device)
        charge_meta(COUNT, gemm_bytes_ops((a, packed_b), (y,), M, K, N,
                                          lead[0] if lead else 1), y.shape)
        return y
    if impl == "torch" or (impl == "auto" and a.device.type == "cpu"):
        COUNT.plain_calls += 1
        return packed_matmul_ref(torch.nn.functional.pad(a, (0, planes * Kp - K)),
                                 packed_b, bits)
    check(a.device.type == "cuda", lambda: f"tugemm_packed: impl={impl!r} needs CUDA tensors")
    check(a.dtype == torch.int8 and packed_b.dtype == torch.int8,
          lambda: f"tugemm_packed: a {a.dtype}, packed b {packed_b.dtype}; both must be int8")
    for t in (a, packed_b):
        check(t.device == a.device and t.is_contiguous(),
              "tugemm_packed: every operand must be contiguous on a's device")
    E = lead[0] if lead else 1
    y = torch.empty(lead + (M, N), dtype=torch.int32, device=a.device)
    if M > 0 and N > 0 and E > 0:
        plan = split_plan(M, N, Kp, planes, sm_count(a.device), 1, E)
        rc = _load().tugemm_packed_launch(ptr(a), ptr(packed_b), ptr(y), E, M, N, K, Kp, bits,
                                          *plan, stream_ptr(a.device))
        raise_on(rc, "tugemm_packed")
        COUNT.launches += 1
    return y
