"""Symmetric w-bit quantization by a reciprocal scale: CUDA kernel + plain
version.

Replaces ``repro/kernels/quantize.py::quantize_sym_pallas`` (the TPU
kernel). The CUDA source is ``csrc/quantize_sym.cu``; its header says what
bounds it on the card (one read of x and of the scale as given, one write of
the codes: bytes) and how its design answers that. ``quantize_plan`` fits
its grid to the card from the shapes. ``quantize_sym`` launches the kernel
for CUDA tensors and runs the plain version (``kernels/ref.py::
quantize_sym_ref``) for CPU tensors or under ``impl="torch"``; both round
the same f32 product half to even, so they agree bit for bit (NaN inputs
are outside the contract).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import build
from ._launch import (DTYPE_CODE, KernelCount, charge_meta, check, meta_route, ptr, raise_on,
                      sm_count, stream_ptr)
from .ref import quantize_sym_ref

__all__ = ["quantize_sym", "launch", "quantize_plan", "host_reciprocal", "COUNT"]

COUNT = KernelCount("quantize_sym")
LANE = 16          # columns a thread owns in a row: one 16-byte store of codes
BLOCK = 128        # threads a block, at most (the kernel's launch bound)
RESIDENT = 512     # threads an SM holds at once: the launch bound's 128 registers a thread
U_MAX = 4          # rows a thread loads before it forms any code
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = build.load("quantize_sym")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.quantize_sym_launch.argtypes = [vp, vp, ctypes.c_float, vp] + [ci] * 11 + [vp]
        lib.quantize_sym_launch.restype = ci
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=256)
def quantize_plan(M: int, N: int, sms: int):
    """(gx, gy, tx, ty, u): the kernel's grid for x (M, N) on a card of
    ``sms`` SMs, from the shapes alone (a batch of f32 rows is twice the
    bytes of bf16's, on the same grid).

    A row has ``N // 16`` lanes of 16 columns, plus one edge lane where N is
    not a multiple of 16. Block (bx, by) holds (tx, ty) threads; thread (i,
    j) takes lane ``bx·tx + i`` of rows ``by·ty + j + k·gy·ty``, ``u`` rows
    a batch. u is the largest of 4, 2, 1 that still gives every SM a block
    (1 for ragged rows, whose lanes are placed row by row); where even
    u = 1 does not, blocks take fewer rows, then 32 lanes. The
    grid holds at most what the card keeps resident at once; past that,
    threads take more batches."""
    cdiv = lambda a, b: -(-a // b)
    lanes = N // LANE + (N % LANE != 0)
    if M <= 0 or lanes == 0:
        return 0, 0, 1, 1, 1
    gx = cdiv(lanes, BLOCK)
    tx = cdiv(lanes, gx)
    ty = max(1, BLOCK // tx)
    u = U_MAX if N % LANE == 0 else 1    # a ragged row's lanes start where its codes align
    while u > 1 and gx * cdiv(M, ty * u) < sms:
        u //= 2
    while ty > 1 and gx * cdiv(M, ty * u) < sms:
        ty //= 2
    if gx * cdiv(M, ty * u) < sms and tx > 32:
        gx = cdiv(lanes, 32)
        tx = cdiv(lanes, gx)
    resident = sms * min(32, RESIDENT // (tx * ty))
    gy = min(cdiv(M, ty * u), max(1, resident // gx), 65535)
    return gx, gy, tx, ty, u


def host_reciprocal(scale) -> float:
    """1/scale rounded once in f32, on the host: bit for bit PyTorch's
    ``1.0 / torch.tensor(scale, dtype=torch.float32)`` (both one IEEE f32
    division of the scale rounded to f32)."""
    with np.errstate(divide="ignore", over="ignore"):
        return float(np.float32(1) / np.float32(scale))


def _scale_arg(scale, x: torch.Tensor):
    """(s tensor or None, inv on the host, s_cols) of a scale as given: a
    number goes as its reciprocal, a tensor as it is (copied to x's device
    and to f32 only where it is not already)."""
    if not isinstance(scale, torch.Tensor):
        if np.ndim(scale) == 0:
            return None, host_reciprocal(scale), 0
        scale = torch.as_tensor(scale)
    s = scale.to(device=x.device, dtype=torch.float32).reshape(-1).contiguous()
    return s, 0.0, int(s.numel() == x.shape[1] and s.numel() != 1)


def quantize_sym(x: torch.Tensor, scale, *, bitwidth: int, impl: str = "auto") -> torch.Tensor:
    """``clip(round(x · inv))`` to the w-bit range as int8, x (M, N) f32 or
    bf16, inv = 1/scale rounded once in f32; ``scale`` a number or a tensor
    of 1 or N values in any shape (per tensor or per column). On the card
    the call is one launch: the kernel takes the reciprocal of a tensor, the
    host that of a number. Any M, N: the kernel needs no padding.

    ``impl``: ``auto`` launches the kernel on CUDA tensors and runs the plain
    version on CPU tensors; ``torch`` runs the plain version anywhere;
    ``cuda`` insists on the kernel; on meta tensors (or ``meta``) the
    outputs are empty and the call is charged (``roofline.kernel_cost``)."""
    meta = meta_route(impl, x)
    n_scale = scale.numel() if isinstance(scale, torch.Tensor) else np.size(scale)
    check(x.ndim == 2 and n_scale in (1, x.shape[1]), lambda: f"quantize_sym: a scale of "
          f"{n_scale} values is neither per tensor nor per column of x {tuple(x.shape)}")
    if meta:
        from ..roofline.kernel_cost import quantize_bytes_ops

        q = torch.empty(tuple(x.shape), dtype=torch.int8, device=x.device)
        charge_meta(COUNT, quantize_bytes_ops(x, scale, q), q.shape)
        return q
    if impl == "torch" or (impl == "auto" and x.device.type == "cpu"):
        COUNT.plain_calls += 1
        inv = 1.0 / torch.as_tensor(scale, dtype=torch.float32, device=x.device)
        return quantize_sym_ref(x, inv.reshape(1, -1), bitwidth)
    check(x.device.type == "cuda", f"quantize_sym: impl={impl!r} needs CUDA tensors")
    check(x.dtype in (torch.float32, torch.bfloat16) and x.is_contiguous(),
          lambda: f"quantize_sym: x must be a contiguous 2-D f32 or bf16 tensor, got "
          f"{x.dtype} {tuple(x.shape)}")
    check(1 <= bitwidth <= 8, f"quantize_sym: bitwidth {bitwidth} does not fit an int8 carrier")
    return launch(x, scale, bitwidth, quantize_plan(*x.shape, sm_count(x.device)))


def launch(x: torch.Tensor, scale, bitwidth: int, plan) -> torch.Tensor:
    """The kernel on x (checked by ``quantize_sym``) under ``plan``, a grid
    of ``quantize_plan``'s form: one launch, counted, where x is not empty."""
    M, N = x.shape
    s, s_host, s_cols = _scale_arg(scale, x)
    q = torch.empty((M, N), dtype=torch.int8, device=x.device)
    if M > 0 and N > 0:
        raise_on(_load().quantize_sym_launch(
            ptr(x), ptr(s), s_host, ptr(q), M, N, bitwidth, DTYPE_CODE[x.dtype],
            int(x.data_ptr() % 16 != 0), s_cols, *plan, stream_ptr(x.device)),
            "quantize_sym")
        COUNT.launches += 1
    return q
