"""Paged flash-decode attention: CUDA kernel + plain version.

Replaces ``repro/kernels/flash_paged.py::flash_paged_decode`` (the TPU
kernel). The CUDA source is ``csrc/flash_paged.cu``; its header says what
bounds it on the card (reading each live K/V page once: device-memory
bytes) and how its design answers that. ``flash_paged_decode`` launches the
kernel for CUDA tensors and runs the plain version — gather the pages
through the block tables, dequantize, then a masked softmax — for CPU
tensors or under ``impl="torch"``. The two agree to f32 summation order.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from ._launch import DTYPE_CODE, KernelCount, check, ptr, raise_on, stream_ptr

__all__ = ["flash_paged_decode", "flash_paged_ref", "gather_pages", "rows_tile", "COUNT",
           "NEG_INF"]

COUNT = KernelCount("flash_paged_decode")
NEG_INF = -1e30           # the reference's finite mask value
# csrc MAXACC * FT and MAX_SMEM: the launcher refuses a tile past either
_MAX_ACC = 64 * 256       # accumulator registers per block
_MAX_SMEM = 232448        # dynamic shared memory a Hopper block may use
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = build.load("flash_paged")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.flash_paged_launch.argtypes = [
            vp, ci, vp, vp, ci, vp, vp, ci, vp, vp, ci, ci, vp, vp, vp, vp,
            ci, ci, ci, ci, ci, ci, ci, ctypes.c_float, ci, ci, vp,
        ]
        lib.flash_paged_launch.restype = ci
        _lib = lib
    return _lib


def _smem_bytes(rows: int, hd: int, hdv: int, bs: int) -> int:
    return 4 * (rows * hd + bs * (hd + 1) + bs * hdv + rows * bs + 3 * rows)


def rows_tile(rows_head: int, hd: int, hdv: int, bs: int) -> int:
    """Query rows one block handles: all of a kv head's rows when the
    accumulator fits in registers and Q plus one K/V page in shared memory
    (GQA), else the largest tile that does (MLA's 16 heads x Sq rows)."""
    r = min(rows_head, _MAX_ACC // hdv)
    while r > 1 and _smem_bytes(r, hd, hdv, bs) > _MAX_SMEM:
        r //= 2
    if r < 1 or _smem_bytes(r, hd, hdv, bs) > _MAX_SMEM:
        raise ValueError(f"flash_paged_decode: head dims {hd}/{hdv} at block size {bs} "
                         "do not fit one block")
    return r


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
                       *, kv_heads, causal=True, window=None, impl="auto"):
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
    ``cuda`` insists on the kernel."""
    if impl not in ("auto", "torch", "cuda"):
        raise ValueError(f"unknown impl {impl!r}")
    k_parts, k_scales = tuple(k_parts), tuple(k_scales)
    if impl == "torch" or (impl == "auto" and q.device.type == "cpu"):
        COUNT.plain_calls += 1
        return flash_paged_ref(q, k_parts, k_scales, v_pool, v_scale, tables, pos, kv_len,
                               kv_heads=kv_heads, causal=causal, window=window)
    check(q.device.type == "cuda", f"flash_paged_decode: impl={impl!r} needs CUDA tensors")
    dev = q.device
    B, sq, H, hd = q.shape
    kv = kv_heads
    check(len(k_parts) in (1, 2) and len(k_scales) == len(k_parts), "1 or 2 K parts")
    check(H % kv == 0, f"{H} heads over {kv} kv heads")
    check(q.dtype in (torch.float32, torch.bfloat16), f"q dtype {q.dtype}")
    kvt = v_pool.dtype
    check(kvt in DTYPE_CODE and all(p.dtype == kvt for p in k_parts), "K/V pool dtypes")
    int8 = kvt == torch.int8
    n_rows, bs = v_pool.shape[:2]
    feats = [p.shape[2] // kv for p in k_parts]
    hdv = v_pool.shape[2] // kv
    check(sum(feats) == hd, f"K parts {feats} vs hd_tot {hd}")
    check(all(p.shape[:2] == (n_rows, bs) and p.shape[2] % kv == 0 for p in k_parts)
          and v_pool.shape[2] % kv == 0, "pool shapes")
    scales = [*k_scales, v_scale]
    check(all((s is not None) == int8 for s in scales), "scales iff int8 pools")
    check(all(s is None or (s.dtype == torch.float32 and s.shape == (n_rows, bs))
              for s in scales), "scale shapes")
    tables = tables.to(torch.int32)
    pos = pos.to(torch.int32)
    kv_len = kv_len.to(torch.int32)
    MB = tables.shape[1]
    check(tables.shape[0] == B and pos.shape == (B,) and kv_len.shape == (B,),
          "tables/pos/kv_len shapes")
    ops_ = [q, *k_parts, v_pool, *scales, tables, pos, kv_len]
    check(all(t is None or (t.device == dev and t.is_contiguous()) for t in ops_),
          "flash_paged_decode: every operand must be contiguous on q's device")
    tile = rows_tile((H // kv) * sq, hd, hdv, bs)
    out = torch.empty((B, sq, H, hdv), dtype=q.dtype, device=dev)
    if B > 0:
        k1 = k_parts[1] if len(k_parts) == 2 else None
        s1 = k_scales[1] if len(k_parts) == 2 else None
        rc = _load().flash_paged_launch(
            ptr(q), DTYPE_CODE[q.dtype], ptr(k_parts[0]), ptr(k_scales[0]), feats[0],
            ptr(k1), ptr(s1), feats[1] if k1 is not None else 0, ptr(v_pool), ptr(v_scale),
            hdv, DTYPE_CODE[kvt], ptr(tables), ptr(pos), ptr(kv_len), ptr(out),
            B, sq, H, kv, bs, MB, tile, float(1.0 / hd ** 0.5), int(causal),
            0 if window is None else int(window), stream_ptr(dev),
        )
        raise_on(rc, "flash_paged_decode")
        COUNT.launches += 1
    return out
