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
import functools

import torch

from . import build
from ._launch import (KernelCount, charge_meta, check, meta_route, ptr, raise_on, sm_count,
                      stream_ptr)
from .ref import temporal_unary_gemm_ref

__all__ = ["temporal_unary_gemm", "split_plan", "COUNT"]

COUNT = KernelCount("temporal_unary_gemm")
BM, BN, BK = 64, 128, 64   # csrc tile: output rows, output columns, K per tile
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = build.load("temporal_unary")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.temporal_unary_launch.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, vp]
        lib.temporal_unary_launch.restype = ci
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=256)
def split_plan(M: int, N: int, K: int, steps: int, sms: int):
    """(kchunk, ksplits, uchunk, usplits): how the kernel's grid cuts the
    work beyond its (M/BM) x (N/BN) output tiles, from shapes alone.

    Block z takes K tiles ``[ks·kchunk, +kchunk)`` and unary steps
    ``[us·uchunk, +uchunk)`` for ``ks < ksplits``, ``us < usplits``; each
    (K tile, step) pair of every output tile falls in exactly one block.
    K is split first (it also splits the bytes each block reads), then the
    steps, aiming at two blocks per SM, or more where M leaves some of a
    block's four 16-row warps without rows."""
    cdiv = lambda x, y: -(-x // y)
    warps = min(4, cdiv(max(M, 1), 16))
    tiles = cdiv(M, BM) * cdiv(N, BN)
    k_tiles = max(1, cdiv(K, BK))
    want = cdiv(2 * sms * (4 // warps), max(tiles, 1))
    kchunk = max(1, k_tiles // want)
    ksplits = cdiv(k_tiles, kchunk)
    uchunk = cdiv(steps, min(steps, cdiv(want, ksplits)))
    return kchunk, ksplits, uchunk, cdiv(steps, uchunk)


def temporal_unary_gemm(a: torch.Tensor, b: torch.Tensor, *, bitwidth: int,
                        impl: str = "auto") -> torch.Tensor:
    """A (M, K) · B (K, N) -> (M, N) int32 via ``2**(w-1)`` unary steps.
    The kernel takes int8 operands (``ops.temporal_gemm`` casts them, as the
    reference's wrapper does); any M, N, K: it masks its ragged edges.

    ``impl``: ``auto`` launches the kernel on CUDA tensors and runs the plain
    version on CPU tensors; ``torch`` runs the plain version anywhere;
    ``cuda`` insists on the kernel; on meta tensors (or ``meta``) the
    outputs are empty and the call is charged (``roofline.kernel_cost``)."""
    if meta_route(impl, a):
        from ..roofline.kernel_cost import temporal_bytes_ops

        y = torch.empty((a.shape[0], b.shape[1]), dtype=torch.int32, device=a.device)
        charge_meta(COUNT, temporal_bytes_ops(a, b, y, bitwidth), y.shape)
        return y
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
    # the launcher zeroes y before the split grid adds its partial sums
    y = torch.empty((M, N), dtype=torch.int32, device=a.device)
    if K == 0:
        y.zero_()
    elif M > 0 and N > 0:
        steps = 2 ** (bitwidth - 1)
        plan = split_plan(M, N, K, steps, sm_count(a.device))
        rc = _load().temporal_unary_launch(ptr(a), ptr(b), ptr(y), M, N, K, steps, *plan,
                                           stream_ptr(a.device))
        raise_on(rc, "temporal_unary_gemm")
        COUNT.launches += 1
    return y
