"""Paged flash-decode attention: CUDA kernel + plain version.

Replaces ``repro/kernels/flash_paged.py::flash_paged_decode`` (the TPU
kernel). The CUDA source is ``csrc/flash_paged.cu``: a split-over-pages
pass writing per-split (m, l, acc) partials into f32 scratch the wrapper
allocates, and a combine pass; its header says what bounds it on the card
and how its design answers that. ``split_plan`` picks the splits from
shapes alone. ``flash_paged_decode`` launches the
kernel for CUDA tensors and runs the plain version — gather the pages
through the block tables, dequantize, then a masked softmax — for CPU
tensors or under ``impl="torch"``. The two agree to f32 summation order.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from ._launch import (DTYPE_CODE, KernelCount, charge_meta, check, meta_route, ptr, raise_on,
                      sm_count, stream_ptr)

__all__ = ["flash_paged_decode", "flash_paged_ref", "gather_pages", "split_plan", "COUNT",
           "NEG_INF", "ROW_TILE"]

COUNT = KernelCount("flash_paged_decode")
NEG_INF = -1e30           # the reference's finite mask value
ROW_TILE = 16             # csrc RT: most query rows of one kv head per block
MAX_SPLITS = 256          # csrc MAX_SPLITS: splits the combine pass takes
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = build.load("flash_paged")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.flash_paged_launch.argtypes = [
            vp, ci, vp, vp, ci, vp, vp, ci, vp, vp, ci, ci, vp, vp, vp, vp, vp, vp, vp,
            ci, ci, ci, ci, ci, ci, ci, ci, ctypes.c_float, ci, ci, ci, vp,
        ]
        lib.flash_paged_launch.restype = ci
        _lib = lib
    return _lib


def split_plan(batch: int, kv_heads: int, rows_head: int, pages: int, sms: int):
    """(splits, pages per split) of the page axis, from shapes alone.

    Pass 1 launches ``batch * kv_heads * ceil(rows_head / ROW_TILE)`` row
    tiles times ``splits`` blocks. A block is bound by the latency of its
    chunk copies, not by bandwidth, so the plan aims at eight blocks per SM
    (several resident on each), with at least two pages per split (one
    chunk of 32 tokens at pages of 16) and at most MAX_SPLITS splits. It
    cuts the ``pages`` block-table entries into contiguous runs of ``pages
    per split`` (the last may be shorter). It reads no ``kv_len`` or
    ``pos``: which splits hold live pages is decided on the device, so the
    host never waits for the card."""
    pages = max(pages, 1)
    tiles = max(batch * kv_heads * -(-rows_head // ROW_TILE), 1)
    want = -(-8 * sms // tiles)
    per = max(min(2, pages), -(-pages // want), -(-pages // MAX_SPLITS))
    return -(-pages // per), per


def gather_pages(pool: torch.Tensor, scale: torch.Tensor | None, tables: torch.Tensor) -> torch.Tensor:
    """Pages (P+1, bs, F) of every row, in table order, dequantized to one
    f32 (B, MB·bs, F) tensor (int8 pools times their per-token scales)."""
    B, MB = tables.shape
    idx = tables.long()
    g = pool[idx].to(torch.float32)                      # (B, MB, bs, F)
    if scale is not None:
        g = g * scale[idx].unsqueeze(-1)
    return g.reshape(B, MB * pool.shape[1], pool.shape[2])


def flash_paged_ref(q, k_parts, k_scales, v_pool, v_scale, tables, pos, kv_len,
                    *, kv_heads, causal=True, window=None):
    """Plain version: gather + dequantize the pages, then a masked softmax
    (masked after the exp, so idle rows give exact zeros)."""
    B, sq, H, hd = q.shape
    kv = kv_heads
    group = H // kv
    L = tables.shape[1] * v_pool.shape[1]
    k = torch.cat([gather_pages(p, s, tables).reshape(B, L, kv, -1)
                   for p, s in zip(k_parts, k_scales)], dim=-1)
    v = gather_pages(v_pool, v_scale, tables).reshape(B, L, kv, -1)
    k_pos = torch.arange(L, device=q.device)
    q_pos = pos.long()[:, None] + torch.arange(sq, device=q.device)     # (B, sq)
    mask = k_pos[None, None, :] < kv_len.long()[:, None, None]          # (B, sq, L)
    if causal:
        mask = mask & (k_pos[None, None, :] <= q_pos[:, :, None])
    if window is not None:
        mask = mask & (q_pos[:, :, None] - k_pos[None, None, :] < window)
    live = (k_pos[None, :] < kv_len.long()[:, None])[:, :, None, None]
    k = torch.where(live, k, 0.0)
    v = torch.where(live, v, 0.0)
    qf = q.to(torch.float32) * (1.0 / hd ** 0.5)
    qf = qf.reshape(B, sq, kv, group, hd).permute(0, 2, 3, 1, 4)        # (B,kv,g,sq,hd)
    s = torch.matmul(qf, k.permute(0, 2, 3, 1).unsqueeze(2))            # (B,kv,g,sq,L)
    m4 = mask[:, None, None]
    s = torch.where(m4, s, NEG_INF)
    p = torch.where(m4, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, v.permute(0, 2, 1, 3).unsqueeze(2)) / l.clamp_min(1e-30)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, sq, H, -1)
    return out.to(q.dtype)


def flash_paged_decode(q, k_parts, k_scales, v_pool, v_scale, tables, pos, kv_len,
                       *, kv_heads, causal=True, window=None, impl="auto", plan_dims=None):
    """Paged attention for a step of width Sq; returns (B, Sq, H, hdv) in
    q.dtype.

    q (B, Sq, H, hd_tot) with query heads kv-major (head h reads kv head
    h // (H / kv_heads)); ``k_parts`` one (GQA) or two (MLA ``[ckv; kr]``)
    pools (P+1, bs, kv·f_i) whose per-head features concatenate to hd_tot;
    ``k_scales`` per part (P+1, bs) f32 for int8 pools, else None; v_pool
    (P+1, bs, kv·hdv); tables (B, MB) int32 page ids; pos (B,) position of
    q[:, 0]; kv_len (B,) live tokens after this step's writes. Scores are
    scaled by 1/sqrt(hd_tot).

    ``impl``: ``auto`` launches the kernel on CUDA tensors and runs the plain
    version on CPU tensors; ``torch`` runs the plain version anywhere;
    ``cuda`` insists on the kernel. ``plan_dims`` = (batch, kv_heads,
    rows a kv head) replaces this call's own in ``split_plan``: a mesh
    rank's slice of a launch takes the whole launch's plan, and with it
    the whole launch's per-head results. On meta tensors (or ``meta``) the
    output is empty and the call is charged with every page of the table
    read (``roofline.kernel_cost.attn_bytes_ops``)."""
    k_parts, k_scales = tuple(k_parts), tuple(k_scales)
    if meta_route(impl, q):
        from ..roofline.kernel_cost import attn_bytes_ops

        B, sq, H, _ = q.shape
        out = torch.empty((B, sq, H, v_pool.shape[2] // kv_heads), dtype=q.dtype, device=q.device)
        args = (q, k_parts, k_scales, v_pool, v_scale, tables, pos, kv_len)
        charge_meta(COUNT, attn_bytes_ops(args, kv_heads, v_pool.shape[1], window,
                                          every_page=True), out.shape)
        return out
    if impl == "torch" or (impl == "auto" and q.device.type == "cpu"):
        COUNT.plain_calls += 1
        return flash_paged_ref(q, k_parts, k_scales, v_pool, v_scale, tables, pos, kv_len,
                               kv_heads=kv_heads, causal=causal, window=window)
    check(q.device.type == "cuda", f"flash_paged_decode: impl={impl!r} needs CUDA tensors")
    dev = q.device
    scales = (*k_scales, v_scale)
    # shape and dtype checks and the split plan depend on shapes alone: cached
    feats, hdv, bs, MB, splits, per, q_code, kv_code = _shape_plan(
        tuple(q.shape), q.dtype, kv_heads, tuple((tuple(p.shape), p.dtype) for p in k_parts),
        tuple(v_pool.shape), v_pool.dtype,
        tuple(None if t is None else (tuple(t.shape), t.dtype) for t in scales),
        tuple(tables.shape), tuple(pos.shape), tuple(kv_len.shape), sm_count(dev),
        None if plan_dims is None else tuple(plan_dims))
    if tables.dtype != torch.int32:
        tables = tables.to(torch.int32)
    if pos.dtype != torch.int32:
        pos = pos.to(torch.int32)
    if kv_len.dtype != torch.int32:
        kv_len = kv_len.to(torch.int32)
    for t in (q, *k_parts, v_pool, *scales, tables, pos, kv_len):
        if t is not None and (t.device != dev or not t.is_contiguous()):
            raise ValueError("flash_paged_decode: every operand must be contiguous on q's device")
    B, sq, H, hd = q.shape
    kv = kv_heads
    # V read from K part 0's copy when it is the same pool (MLA's ckv)
    alias = (v_pool.data_ptr() == k_parts[0].data_ptr() and v_pool.shape == k_parts[0].shape
             and ptr(v_scale) == ptr(k_scales[0]))
    out = torch.empty((B, sq, H, hdv), dtype=q.dtype, device=dev)
    if B > 0:
        n = B * kv * (H // kv) * sq * splits
        scratch = torch.empty(n * (hdv + 2), dtype=torch.float32, device=dev).data_ptr()
        two = len(k_parts) == 2
        rc = _load().flash_paged_launch(
            q.data_ptr(), q_code, k_parts[0].data_ptr(), ptr(k_scales[0]), feats[0],
            k_parts[1].data_ptr() if two else None, ptr(k_scales[1]) if two else None,
            feats[1] if two else 0, v_pool.data_ptr(), ptr(v_scale), hdv, kv_code,
            tables.data_ptr(), pos.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
            scratch + 4 * n * hdv, scratch + 4 * n * (hdv + 1), scratch,
            B, sq, H, kv, bs, MB, splits, per, 1.0 / hd ** 0.5, int(causal),
            0 if window is None else int(window), int(alias), stream_ptr(dev),
        )
        raise_on(rc, "flash_paged_decode")
        COUNT.launches += 1
    return out


@functools.lru_cache(maxsize=256)
def _shape_plan(q_shape, q_dtype, kv, parts, v_shape, v_dtype, scales, t_shape, p_shape,
                l_shape, sms, plan_dims=None):
    """The kernel's shape checks and launch plan: (feature widths of the K
    parts, hdv, page size, pages per row, splits, pages per split, q dtype
    code, pool dtype code). Raises on shapes the kernel does not take."""
    B, sq, H, hd = q_shape
    check(len(parts) in (1, 2) and len(scales) == len(parts) + 1, "1 or 2 K parts")
    check(H % kv == 0, f"{H} heads over {kv} kv heads")
    check(q_dtype in (torch.float32, torch.bfloat16), f"q dtype {q_dtype}")
    check(v_dtype in DTYPE_CODE and all(dt == v_dtype for _, dt in parts), "K/V pool dtypes")
    int8 = v_dtype == torch.int8
    n_rows, bs = v_shape[:2]
    feats = [shape[2] // kv for shape, _ in parts]
    hdv = v_shape[2] // kv
    check(sum(feats) == hd, f"K parts {feats} vs hd_tot {hd}")
    check(all(shape[:2] == (n_rows, bs) and shape[2] % kv == 0 for shape, _ in parts)
          and v_shape[2] % kv == 0, "pool shapes")
    check(all((s is not None) == int8 for s in scales), "scales iff int8 pools")
    check(all(s is None or (s[1] == torch.float32 and s[0] == (n_rows, bs)) for s in scales),
          "scale shapes")
    check(len(t_shape) == 2 and t_shape[0] == B and p_shape == (B,) and l_shape == (B,),
          "tables/pos/kv_len shapes")
    # rows of whole 16-byte pieces take the kernel's wide path, others its
    # narrow one (csrc/flash_paged.cu); any width up to 512 columns
    check(feats[0] > 0 and 0 < hdv <= 512,
          f"flash_paged_decode: head widths {feats}/{hdv} must be positive, hdv <= 512")
    MB = t_shape[1]
    splits, per = split_plan(*(plan_dims or (B, kv, (H // kv) * sq)), MB, sms)
    return feats, hdv, bs, MB, splits, per, DTYPE_CODE[q_dtype], DTYPE_CODE[v_dtype]
