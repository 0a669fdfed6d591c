"""Fused dynamic-quant tuGEMM linear layer: CUDA kernel + plain version.

Replaces ``repro/kernels/tugemm_fused.py::tugemm_fused_pallas`` (the TPU
kernel). The CUDA source is ``csrc/tugemm_fused.cu`` (its mainloop,
``csrc/tugemm_mainloop.cuh``, is shared with ``csrc/tugemm_int8.cu``); its
header says what bounds it on the card (reading W once: device-memory
bytes) and how its design answers that. ``tugemm_fused`` launches the kernel
for CUDA tensors and runs the plain version (``kernels/ref.py::
fused_gemm_ref``) for CPU tensors or under ``impl="torch"``; the two agree
bit for bit, outputs and stats. ``split_plan`` cuts K across the blocks of
a thread block cluster, from the shapes alone. A leading expert axis (the
MoE expert GEMMs: x (E, M, Kx), w (E, Kw, N)) runs all E GEMMs in one
launch, the expert folded into the grid's z axis.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from ._launch import (DTYPE_CODE, KernelCount, charge_meta, check, meta_route, ptr, raise_on,
                      sm_count, stream_ptr)
from .packing import PLANES
from .ref import fused_gemm_ref

__all__ = ["tugemm_fused", "split_plan", "COUNT"]

COUNT = KernelCount("tugemm_fused")
# csrc/tugemm_mainloop.cuh: rows of a block tile, W rows a K chunk, the tile
# widths it takes (widest first) and its largest cluster
BM, KC, BNS, MAX_SPLITS = 64, 64, (128, 64, 32), 16
# ... and its shared-memory layout (``layout``, ``ring_depth``): the int8
# operand rows' byte stride, the raw ring's budget and deepest ring, the
# partial tile's row padding, warps a block, the most dynamic shared memory
# a block may take; an H100 SM's shared memory, the part each resident block
# reserves, and the blocks an SM holds at most (``__launch_bounds__``)
QST, RING_BUDGET, RMAX, PPAD, NWARP, SMEM_MAX = 80, 96 * 1024, 8, 8, 8, 227 * 1024
SM_SMEM, BLOCK_RESERVED, MAX_RESIDENT = 228 * 1024, 1024, 2
_W_MODES = {"quant": 0, "int8": 1, "packed": 2}
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = build.load("tugemm_fused")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.tugemm_fused_launch.argtypes = [
            vp, ci, vp, ci, ci, vp, ci, vp, vp, vp, ci, vp,
            ci, ci, ci, ci, ci, ci, ci, ci, ci, ci, vp,
        ]
        lib.tugemm_fused_launch.restype = ci
        _lib = lib
    return _lib


def _cdiv(x: int, y: int) -> int:
    return -(-x // y)


def _smem(planes: int, bn: int, chunks: int, xbytes: int) -> int:
    """Dynamic shared memory of one block: ``layout(...).total`` of
    ``csrc/tugemm_mainloop.cuh`` for int8 (or packed) W."""
    stage = BM * planes * KC * xbytes + KC * bn
    ring = min(chunks, max(1, min(RMAX, RING_BUDGET // stage)))
    xq = max(ring * stage, BM * (bn + PPAD) * 4)
    return xq + 2 * planes * (BM + bn) * QST + NWARP * planes * (KC // 4) * 4


@functools.lru_cache(maxsize=256)
def split_plan(M: int, N: int, Kw: int, planes: int, sms: int, xbytes: int = 1,
               experts: int = 1):
    """(bn, splits, chunks): how the kernel's grid cuts the work, from shapes
    alone. The grid is (splits, ceil(N/bn), experts·ceil(M/64)); the ``splits``
    blocks of one output tile form a thread block cluster, block s taking
    the W rows of chunks ``[s·chunks, (s+1)·chunks)`` (chunks of 64 rows,
    each row feeding all ``planes``), so every (K chunk, N tile) of every M
    tile falls in exactly one block. ``xbytes``: bytes of an X element (1
    for int8 X; the fused kernel's f32 / bf16 X 4 / 2); only packed W
    (``planes > 1``) reads it.

    Measured on the H100 (``scripts/tugemm_plan_sweep.py``, PERF.md),
    a block's time grows with its chunks and its fixed cost (copies,
    barriers, the cluster reduction) outweighs the warps more blocks add,
    while each narrower tile quantizes X again. So, for one plane: the
    widest tile, then two chunks a block (one where two leave fewer than
    half the SMs a block of 8 warps), and as few splits as that needs; K
    longer than 16 splits of two chunks takes more chunks a block. A shape
    too small for half the SMs takes the most blocks the kernel can make.

    A packed chunk carries ``planes`` slices of X, so its blocks are
    costlier and larger (one or two an SM by shared memory), and a plan
    whose blocks do not all fit on the card at once runs in waves (the
    sweep: 12-block clusters of one-block SMs, or more blocks than the SMs
    hold, took up to twice as long). So, for ``planes > 1``: the fewest
    waves times chunks a block, then the fewest waves; then, at one chunk
    a block, the widest tile that reaches a quarter of the SMs (each tile
    copies, and the fused kernel quantizes, X again), and otherwise the
    most blocks. A cluster above the portable 8 blocks counts as filling twice
    its SMs where one block fills an SM.

    ``experts`` > 1 (one launch over the MoE experts) multiplies the output
    tiles, which at the expert shapes fill the card several times over. The
    sweep at deepseek-v2-lite's (64 experts, M=16, K/N 2048/1408) found the
    widest tile best in every form; for one plane, two or three chunks a
    block in a cluster of a power of two (16 splits at K=2048, 8 at 1408;
    one split, each block walking its whole K, took 30-35% longer, 11 or 12
    splits up to 30%); for packed W, the fewest splits whose blocks fill
    every SM once (one split here: within 5% of the fastest, where the
    single-GEMM model's plan took 30-90% longer)."""
    cdiv = _cdiv
    m_tiles = experts * cdiv(max(M, 1), BM)
    k_chunks = max(1, cdiv(Kw, KC))
    if experts > 1:
        tiles = m_tiles * cdiv(max(N, 1), BNS[0])
        if planes > 1:
            splits = min(MAX_SPLITS, k_chunks, cdiv(sms, tiles))
        else:
            splits = 1 << (min(MAX_SPLITS, max(1, k_chunks // 2)).bit_length() - 1)
        chunks = cdiv(k_chunks, splits)
        return BNS[0], cdiv(k_chunks, chunks), chunks
    if planes > 1:
        return _packed_plan(m_tiles, N, k_chunks, planes, sms, xbytes)
    least = cdiv(k_chunks, MAX_SPLITS)   # chunks a block at 16 splits
    want = cdiv(sms, 2)
    for bn in BNS:
        tiles = m_tiles * cdiv(max(N, 1), bn)
        for chunks in ((min(2, k_chunks), 1) if least == 1 else (least,)):
            splits = cdiv(k_chunks, chunks)
            if tiles * splits >= want:
                return bn, splits, chunks
    return BNS[-1], cdiv(k_chunks, least), least


def _packed_plan(m_tiles: int, N: int, k_chunks: int, planes: int, sms: int, xbytes: int):
    """``split_plan`` for packed W: see there."""
    best = None
    for bn in BNS:
        for splits in range(1, min(MAX_SPLITS, k_chunks) + 1):
            chunks = _cdiv(k_chunks, splits)
            if _cdiv(k_chunks, chunks) != splits:   # a block would be left idle
                continue
            smem = _smem(planes, bn, chunks, xbytes)
            per_sm = min(MAX_RESIDENT, SM_SMEM // (smem + BLOCK_RESERVED))
            if smem > SMEM_MAX or per_sm == 0:
                continue
            blocks = m_tiles * _cdiv(max(N, 1), bn) * splits
            room = sms * per_sm if splits <= 8 or per_sm > 1 else sms // 2
            waves = _cdiv(blocks, room)
            wide = chunks == 1 and 4 * blocks >= sms
            key = (waves * chunks, waves, not wide, -bn if wide else -blocks)
            if best is None or key < best[0]:
                best = (key, (bn, splits, chunks))
    return best[1]


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

    With a leading expert axis every operand and result gains it: x (E, M,
    Kx), w (E, Kw, N), sx (E, 1, 1) or (E, M, 1), sw (E, 1, N), bias (E, N);
    y (E, M, N), ca (E, planes, Kw), rb (E, Kw, planes). One launch (and one
    memset with stats) computes all E GEMMs.

    ``impl``: ``auto`` launches the kernel on CUDA tensors and runs the plain
    version on CPU tensors; ``torch`` runs the plain version anywhere;
    ``cuda`` insists on the kernel; on meta tensors (or ``meta``) the
    outputs are empty and the call is charged (``roofline.kernel_cost``)."""
    if meta_route(impl, x):
        return _meta(x, w, sx, sw, bias, bits, w_mode, collect_stats, out_dtype)
    if impl == "torch" or (impl == "auto" and x.device.type == "cpu"):
        COUNT.plain_calls += 1
        return fused_gemm_ref(x, w, sx, sw, bias, bits=bits, w_mode=w_mode,
                              collect_stats=collect_stats, out_dtype=out_dtype)
    check(x.device.type == "cuda",
          lambda: f"tugemm_fused: impl={impl!r} needs CUDA tensors")
    planes = PLANES[bits] if w_mode == "packed" else 1
    batched = x.ndim == 3
    check(x.ndim == w.ndim and x.ndim in (2, 3) and (not batched or x.shape[0] == w.shape[0]),
          lambda: f"x {tuple(x.shape)} vs w {tuple(w.shape)}: 2-D, or 3-D with one expert axis")
    E = x.shape[0] if batched else 1
    M, Kx = x.shape[-2:]
    Kw, N = w.shape[-2:]
    dev = x.device
    check(w_mode in _W_MODES, lambda: f"unknown w_mode {w_mode!r}")
    check(bits in (2, 4, 8) and (w_mode != "packed" or bits < 8),
          lambda: f"bits={bits} with w_mode={w_mode!r}")
    check(Kx == planes * Kw,
          lambda: f"x {tuple(x.shape)} vs w {tuple(w.shape)} ({w_mode}, {bits}-bit)")
    check(x.dtype in (torch.float32, torch.bfloat16), lambda: f"x dtype {x.dtype}")
    check((w.dtype == torch.int8) == (w_mode != "quant") and w.dtype in DTYPE_CODE,
          lambda: f"w dtype {w.dtype} with w_mode={w_mode!r}")
    check(out_dtype in (torch.float32, torch.bfloat16), lambda: f"out dtype {out_dtype}")
    sx = sx.reshape(-1)
    sw = sw.reshape(-1)
    check(sx.dtype == torch.float32 and sx.numel() in (E, E * M),
          lambda: f"sx {tuple(sx.shape)} {sx.dtype}")
    check(sw.dtype == torch.float32 and sw.numel() == E * N,
          lambda: f"sw {tuple(sw.shape)} {sw.dtype}")
    per_token = sx.numel() == E * M and M > 1
    if bias is not None:
        bias = bias.to(out_dtype).expand(E, N).contiguous().reshape(-1)
    for t in (x, w, sx, sw, bias):
        check(t is None or (t.device == dev and t.is_contiguous()),
              "tugemm_fused: every operand must be contiguous on x's device")
    lead = (E,) if batched else ()
    y = torch.empty(lead + (M, N), dtype=out_dtype, device=dev)
    stats = None
    if collect_stats:
        # ca then rb in one buffer: the launcher zeroes it (one memset), the
        # kernel merges its maxima into it by atomicMax
        stats = torch.empty(2 * E * planes * Kw, dtype=torch.int32, device=dev)
    if M > 0 and N > 0 and E > 0:
        plan = split_plan(M, N, Kw, planes, sm_count(dev), x.element_size(), E)
        rc = _load().tugemm_fused_launch(
            ptr(x), DTYPE_CODE[x.dtype], ptr(w), _W_MODES[w_mode], DTYPE_CODE[w.dtype],
            ptr(sx), int(per_token), ptr(sw), ptr(bias), ptr(y), DTYPE_CODE[out_dtype],
            ptr(stats), E, M, N, Kw, planes, bits, int(collect_stats), *plan,
            stream_ptr(dev),
        )
        raise_on(rc, "tugemm_fused")
        COUNT.launches += 1
    elif stats is not None:
        stats.zero_()
    if not collect_stats:
        return y
    half = E * planes * Kw
    return (y, stats[:half].view(lead + (planes, Kw)),
            stats[half:].view(lead + (Kw, planes)))


def _meta(x, w, sx, sw, bias, bits, w_mode, collect_stats, out_dtype):
    """The meta path: empty (y[, ca, rb]) and one charge at the kernel's count."""
    from ..roofline.kernel_cost import gemm_bytes_ops

    planes = PLANES[bits] if w_mode == "packed" else 1
    lead = tuple(x.shape[:-2])
    M, Kx = x.shape[-2:]
    Kw, N = w.shape[-2:]
    y = torch.empty(lead + (M, N), dtype=out_dtype, device=x.device)
    outs = (y,)
    if collect_stats:
        outs += (torch.empty(lead + (planes, Kw), dtype=torch.int32, device=x.device),
                 torch.empty(lead + (Kw, planes), dtype=torch.int32, device=x.device))
    E = lead[0] if lead else 1
    charge_meta(COUNT, gemm_bytes_ops((x, w, sx, sw, bias), outs, M, Kx, N, E), y.shape)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (sx, sw, bias)):
        y = _MetaDequant.apply(y, sx, sw, bias)
        outs = (y,) + outs[1:]
    return outs if collect_stats else y


class _MetaDequant(torch.autograd.Function):
    """The plain version's autograd structure on the meta path: ``y = acc ·
    (sx·sw) + bias`` is differentiable in the scales and the bias (rounding
    cuts the rest), so a train step on meta tensors runs the backward the
    plain version (and the reference's XLA twin) runs. The kernel itself has
    no backward: on the card such a call raises (``ops.resolve_path``)."""

    @staticmethod
    def forward(ctx, y, sx, sw, bias):
        ctx.save_for_backward(y, sx, sw)
        ctx.bias_shape = None if bias is None else bias.shape
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        y, sx, sw = ctx.saved_tensors
        acc = torch.empty(y.shape, dtype=torch.float32, device=y.device)
        gf = g.to(torch.float32) * acc

        def reduce_to(t, shape):
            while t.ndim > len(shape):
                t = t.sum(0)
            return t.sum(tuple(i for i, n in enumerate(shape) if n == 1 and t.shape[i] != 1),
                         keepdim=True)

        dsx = reduce_to(gf * sw, sx.shape) if ctx.needs_input_grad[1] else None
        dsw = reduce_to(gf * sx, sw.shape) if ctx.needs_input_grad[2] else None
        dbias = None
        if ctx.needs_input_grad[3]:
            gb = g.to(torch.float32)
            dbias = gb.sum(-2) if len(ctx.bias_shape) == gb.ndim - 1 else reduce_to(
                gb, ctx.bias_shape)
            dbias = dbias.reshape(ctx.bias_shape)
        return None, dsx, dsw, dbias
