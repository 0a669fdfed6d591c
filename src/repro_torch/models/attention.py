"""GQA attention (+qk_norm, RoPE) and MLA (DeepSeek-V2) over a KV cache in
one of the reference's two layouts, or over the step's own K/V (no cache).

- **dense**: per-slot ``(batch, capacity)`` buffers. The legacy Engine
  writes every row at one scalar position (``kv_cache_write(..., pos)``,
  the start clamped so the span fits, as ``dynamic_update_slice`` clamps
  it); the Scheduler's dense layout writes each row at its own position
  through a :class:`KVView` without tables, dropping columns past the live
  width or the capacity. Reads are contiguous and attend through
  ``blockwise_attention``.
- **paged**: a fixed set of ``block_size``-token pages shared by all slots
  and addressed through per-slot block tables, so one step mixes prefill
  chunks and decode rows; attention runs the paged flash-decode kernel.

Under a mesh program (``parallel.collectives``: the sharded serving step)
an int8 write max-merges each token's raw amax over the tp ranks' head
shards before the scale transform, so the scale is the single-device
all-heads one; a paged write gathers the dp-local rows' already quantized
planes and writes the whole batch through the program's full-batch write
view (the pool is replicated over dp). The dense layout's caches are
batch-sharded and written locally.

int8 caches store per-(row, token) scales (``_quantize_kv``); every dense
read is length-masked, so positions at or beyond the live length read as
exact zeros and a recycled slot never sees its previous occupant. Writes
are eager in-place updates of the cache tensors. MLA caches the compressed
kv latent (``ckv``) and the shared rope key (``kr``), each with its own
per-token scale, and attends in the absorbed form: one kv head whose K is
``[ckv ; kr]`` and whose V is ``ckv``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..configs.base import ModelConfig
from ..kernels.flash_paged import gather_pages
from ..parallel.collectives import current_program
from ..parallel.sharding import constrain
from ..quant.qlinear import dense
from .flash import blockwise_attention, paged_decode_attention
from .layers import apply_mrope, apply_rope, rms_norm

__all__ = [
    "KVView",
    "init_kv_cache",
    "kv_cache_write",
    "kv_cache_read",
    "gqa_attention",
    "mla_attention",
]


@dataclass
class KVView:
    """Per-row addressing for one mixed prefill+decode step.

    ``pos[b]`` is row b's first write position, ``lens[b]`` how many of the
    step's S columns are real tokens (0 = idle row), ``tables[b]`` maps
    block index -> page id in the pool (None: the dense layout, row b of
    the cache is slot b)."""

    pos: torch.Tensor                   # (B,) int32
    lens: torch.Tensor                  # (B,) int32
    tables: torch.Tensor | None = None  # (B, max_blocks) int32 page ids
    block_size: int = 16
    layout: str = "dense"               # dense | paged

    @property
    def kv_len(self) -> torch.Tensor:
        """Per-row live length after this step's writes."""
        return self.pos + self.lens


def init_kv_cache(cfg: ModelConfig, rows: int, width: int, dtype, device) -> dict:
    """One layer's k/v buffers (rows, width, kv, hd) — a paged pool passes
    rows = pages + 1, width = block_size — or, for MLA, its ckv (rows, width,
    kv_lora_rank) and kr (rows, width, rope) pools; plus a (rows, width) f32
    scale per pool for int8."""
    if cfg.attn_type == "mla":
        cache = {
            "ckv": torch.zeros((rows, width, cfg.kv_lora_rank), dtype=dtype, device=device),
            "kr": torch.zeros((rows, width, cfg.qk_rope_head_dim), dtype=dtype, device=device),
        }
    else:
        kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        cache = {
            "k": torch.zeros((rows, width, kv, hd), dtype=dtype, device=device),
            "v": torch.zeros((rows, width, kv, hd), dtype=dtype, device=device),
        }
    if dtype == torch.int8:
        for n in list(cache):
            cache[n + "_scale"] = torch.zeros((rows, width), dtype=torch.float32, device=device)
    return cache


def _kv_amax(x: torch.Tensor) -> torch.Tensor:
    """Per-(batch, position) raw amax over heads*dim, f32."""
    return x.to(torch.float32).abs().amax(dim=tuple(range(2, x.ndim)))


def _kv_codes(x: torch.Tensor, amax: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 codes and the scale ``max(amax, 1e-8) / 127`` in the division
    form (a tensor divisor, so no backend rewrites it into a reciprocal
    multiply; filled on the device, so no host copy waits for the stream)."""
    scale = amax.clamp_min(1e-8) / torch.full((), 127.0, dtype=torch.float32, device=x.device)
    q = torch.round(x.to(torch.float32) / scale.reshape(scale.shape + (1,) * (x.ndim - 2)))
    return torch.clamp(q, -128, 127).to(torch.int8), scale


def _quantize_kv(x: torch.Tensor, sync=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(batch, position) int8 quantization over heads*dim (``_kv_codes``
    of ``_kv_amax``). ``sync`` max-merges the raw amax across tp head
    shards before the scale transform."""
    amax = _kv_amax(x)
    return _kv_codes(x, amax if sync is None else sync(amax))


def _paged_targets(view: KVView, B: int, S: int, num_rows: int):
    """(page, offset) per token; padded columns land on the trash page (the
    pool's last row, never read)."""
    bs = view.block_size
    cols = torch.arange(S, dtype=torch.int64, device=view.pos.device)
    tp = view.pos.long()[:, None] + cols[None, :]                 # (B, S)
    live = cols[None, :] < view.lens.long()[:, None]
    max_blocks = view.tables.shape[1]
    blk = torch.clamp(tp // bs, 0, max_blocks - 1)
    page = torch.gather(view.tables.long(), 1, blk)               # (B, S)
    page = torch.where(live & (tp < max_blocks * bs), page, num_rows - 1)
    return page, tp % bs


def _dense_window(view: KVView, W: int, capacity: int):
    """Per-row write window of a dense step: (rows, q, j, live), each (B, W).
    Row b's window is W distinct in-bounds positions ``q`` that hold every
    in-bounds target ``pos[b] + c`` of its columns; ``j`` is the column
    landing at ``q`` and ``live`` says whether that column is a real token.
    The window's other positions are written back with their own values,
    so padded columns and columns past the capacity are dropped (the
    reference's ``mode="drop"``) with no host sync and no two writes to one
    position."""
    dev = view.pos.device
    pos = view.pos.long()
    start = torch.clamp(pos, max=capacity - W)
    q = start[:, None] + torch.arange(W, dtype=torch.int64, device=dev)[None, :]
    j = q - pos[:, None]
    live = (j >= 0) & (j < view.lens.long()[:, None])
    rows = torch.arange(pos.shape[0], dtype=torch.int64, device=dev)[:, None].expand_as(q)
    return rows, q, torch.clamp(j, 0, W - 1), live


def kv_cache_write(cache: dict, names: tuple[str, ...], new: tuple, pos: int | None = None, *,
                   view: KVView | None = None) -> dict:
    """Write a (B, S, ...) span of each of ``names`` in place; int8 buffers
    quantize per token first.

    ``view=None``: every row writes at the scalar position ``pos`` (a
    Python int), the start clamped to ``[0, capacity - S]``. A
    :class:`KVView` without tables: row b writes its ``lens[b]`` tokens at
    ``pos[b]`` of its dense row, padded columns and positions past the
    capacity dropped. A paged view: through the block table, padded
    columns landing on the trash page (the pool's last row, never read)."""
    prog = current_program()
    # the paged pool is replicated over dp: every rank writes every row's
    # tokens, so the dp-local rows' planes (already quantized: int8 on the
    # wire) are gathered and written through the full-batch view
    gather = (prog is not None and prog.write_view is not None and view is not None
              and view.tables is not None)
    if gather:
        view = prog.write_view
    int8 = [n for n in names if cache[n].dtype == torch.int8]
    amax = dict(zip(names, (_kv_amax(v) if n in int8 else None for n, v in zip(names, new))))
    if prog is not None:
        # the tp head shards' amaxes, then the dp rows' planes: each in one
        # collective for all of the write's leaves
        sync = [n for n in int8 if n in prog.kv_sync_names]
        for n, a in zip(sync, prog.sync_amax_tp_many([(f"kv.{n}", amax[n]) for n in sync])):
            amax[n] = a
    per_name = []
    for name, val in zip(names, new):
        if name in int8:
            q, s = _kv_codes(val, amax[name])
            per_name.append([(name, q), (name + "_scale", s)])
        else:
            per_name.append([(name, val.to(cache[name].dtype))])
    if gather:
        flat = prog.gather_rows_dp_many([(f"kv.{n}", v) for vals in per_name for n, v in vals])
        it = iter(flat)
        per_name = [[(n, next(it)) for n, _ in vals] for vals in per_name]
    for name, vals in zip(names, per_name):
        buf = cache[name]
        B, S = vals[0][1].shape[:2]
        if view is None:
            start = min(max(pos, 0), buf.shape[1] - S)
            for n, v in vals:
                cache[n][:, start:start + S] = v
        elif view.tables is None:
            W = min(S, buf.shape[1])
            rows, q, j, live = _dense_window(view, W, buf.shape[1])
            for n, v in vals:
                dst = cache[n]
                src = v[:, :W][rows, j]
                keep = live.reshape(live.shape + (1,) * (src.ndim - 2))
                dst[rows, q] = torch.where(keep, src, dst[rows, q])
        else:
            page, off = _paged_targets(view, B, S, buf.shape[0])
            for n, v in vals:
                cache[n][page, off] = v
    return cache


def _mask_dead(x: torch.Tensor, kv_len) -> torch.Tensor:
    """Zero every position at or beyond the live length (an int, or (B,))."""
    if kv_len is None:
        return x
    pos = torch.arange(x.shape[1], device=x.device)
    if isinstance(kv_len, torch.Tensor) and kv_len.ndim == 1:
        live = pos[None, :] < kv_len.long()[:, None]
    else:
        live = (pos < kv_len)[None, :]
    return torch.where(live.reshape(live.shape + (1,) * (x.ndim - 2)), x, 0)


def kv_cache_read(cache: dict, name: str, compute_dtype, *, kv_len=None,
                  view: KVView | None = None) -> torch.Tensor:
    """One cache buffer as a contiguous (B, capacity, ...) tensor,
    dequantized and length-masked: positions at or beyond ``kv_len`` (an
    int or (B,)) read as exact zeros. With a paged ``view``, the pages are
    gathered through its block tables and masked at ``view.kv_len``."""
    if view is not None and view.tables is not None:
        pool = cache[name]
        flat = pool.reshape(pool.shape[0], pool.shape[1], -1)
        buf = gather_pages(flat, cache.get(name + "_scale"), view.tables)
        buf = buf.reshape(buf.shape[:2] + tuple(pool.shape[2:]))
        return _mask_dead(buf, view.kv_len).to(compute_dtype)
    buf = cache[name]
    if buf.dtype == torch.int8:
        s = cache[name + "_scale"]
        buf = buf.to(torch.float32) * s.reshape(s.shape + (1,) * (buf.ndim - 2))
    return _mask_dead(buf, kv_len).to(compute_dtype)


def _dense_kv(cache, names, new, x, cache_pos, kv_view):
    """Write a dense cache (scalar ``cache_pos`` or a table-less view) and
    read every buffer of ``names`` back: (buffers, q_offset, kv_len)."""
    S = x.shape[1]
    if kv_view is not None:
        kv_cache_write(cache, names, new, view=kv_view)
        kv_len, q_offset = kv_view.kv_len, kv_view.pos
    else:
        kv_cache_write(cache, names, new, cache_pos)
        kv_len, q_offset = min(cache_pos + S, cache[names[0]].shape[1]), cache_pos
    bufs = [kv_cache_read(cache, n, x.dtype, kv_len=kv_len) for n in names]
    return bufs, q_offset, kv_len


def gqa_attention(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,                # (B, S, D)
    positions: torch.Tensor,        # (B, S), or (3, B, S) for M-RoPE
    *,
    backend,
    cache: dict | None = None,
    cache_pos: int | None = None,   # scalar write position (the dense lock step)
    kv_view: KVView | None = None,  # per-row addressing (mixed steps, paged or dense)
    is_global: bool = True,
    chunk: int = 1024,
    impl: str = "auto",
) -> torch.Tensor:
    """One GQA layer: projections, qk-norm, RoPE (M-RoPE over (3, B, S)
    positions where ``cfg.mrope_sections`` is set), then the in-place KV
    write and attention — the paged kernel through a paged view, contiguous
    ``blockwise_attention`` on a dense cache or, with no cache, over the
    step's own K/V — and the output projection."""
    B, S, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    if cfg.attn_logit_softcap is not None and cache is not None:
        # the reference drops the softcap with a cache (its cached branches
        # never pass it); the port refuses instead of serving other logits
        # than the no-cache forward computes (ROADMAP C13)
        raise NotImplementedError("the attention logit softcap with a KV cache is refused "
                                  "(ROADMAP C13); only the no-cache forward applies it")
    q = dense(p["wq"], x, backend=backend, name="attn.q", impl=impl).reshape(B, S, h, hd)
    k = dense(p["wk"], x, backend=backend, name="attn.k", impl=impl).reshape(B, S, kv, hd)
    v = dense(p["wv"], x, backend=backend, name="attn.v", impl=impl).reshape(B, S, kv, hd)
    if cfg.qk_norm:
        q = rms_norm(p["q_norm"], q, cfg.rms_eps)
        k = rms_norm(p["k_norm"], k, cfg.rms_eps)
    if cfg.mrope_sections is not None:
        q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    elif cfg.attn_type != "none":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q = constrain(q, "batch", "seq", "act_heads", None)
    window = None if is_global else cfg.sliding_window
    if cache is None:
        out = blockwise_attention(q, k, v, causal=cfg.causal, window=window, chunk=chunk,
                                  softcap=cfg.attn_logit_softcap)
    elif kv_view is not None and kv_view.tables is not None:
        kv_cache_write(cache, ("k", "v"), (k, v), view=kv_view)
        out = paged_decode_attention(
            q, cache, ("k",), "v", kv_view, kv_heads=kv, causal=cfg.causal,
            window=window, impl=impl, name="attn.paged",
        )
    else:
        (k_full, v_full), q_offset, kv_len = _dense_kv(cache, ("k", "v"), (k, v), x,
                                                       cache_pos, kv_view)
        out = blockwise_attention(q, k_full, v_full, q_offset=q_offset, kv_len=kv_len,
                                  causal=cfg.causal, window=window, chunk=chunk)
    out = constrain(out, "batch", "seq", "act_heads", None)
    return dense(p["wo"], out.reshape(B, S, h * hd), backend=backend, name="attn.o", impl=impl)


def mla_attention(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,                # (B, S, D)
    positions: torch.Tensor,        # (B, S)
    *,
    backend,
    cache: dict | None = None,
    cache_pos: int | None = None,
    kv_view: KVView | None = None,
    chunk: int = 1024,
    impl: str = "auto",
    **_unused,
) -> torch.Tensor:
    """One MLA layer in the absorbed form: q and the compressed kv latent,
    RoPE on their rope parts, ``q_nope`` absorbed into the latent space
    through ``w_uk`` (an f32 einsum, outside the hardware boundary as in
    the reference), the in-place write of ``ckv`` / ``kr``, attention over
    one kv head with K = ``[ckv ; kr]`` and V = ``ckv`` (the paged kernel,
    or ``blockwise_attention`` on a dense cache or the step's own latent),
    then ``w_uv`` and the output projection."""
    B, S, _ = x.shape
    h = cfg.num_heads
    nope, rope_d = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    vd, lora = cfg.v_head_dim, cfg.kv_lora_rank
    scale_dim = nope + rope_d

    q = dense(p["wq"], x, backend=backend, name="mla.q", impl=impl).reshape(B, S, h, scale_dim)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    prog = current_program()

    def absorb(site, eq, a, w):
        """An absorbed f32 product; on a mesh at the single-device batch
        and heads, so each head's float contraction is the single-device
        one."""
        def f(a, w):
            return torch.einsum(eq, a.to(torch.float32), w.to(torch.float32)).to(x.dtype)
        if prog is None:
            return f(a, w)
        return prog.at_full(site, f, (a, {0: prog.dp, 2: prog.tp}), (w, {1: prog.tp}))
    dkv = dense(p["w_dkv"], x, backend=backend, name="mla.dkv", impl=impl)
    ckv, k_rope = dkv[..., :lora], dkv[..., lora:]
    ckv = rms_norm(p["kv_norm"], ckv, cfg.rms_eps)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]

    # absorbed form: q_abs[b,s,h,:] = q_nope · W_uk[:,h,:]^T (in latent space)
    q_abs = absorb("mla.w_uk", "bshn,lhn->bshl", q_nope, p["w_uk"]["kernel"])
    q_eff = torch.cat([q_abs, q_rope], dim=-1)                  # (B, S, h, lora+rope)
    # the kernel scales scores by 1/sqrt(lora+rope); MLA's is 1/sqrt(nope+rope)
    comp = ((lora + rope_d) ** 0.5) / (scale_dim ** 0.5)

    if cache is not None and kv_view is not None and kv_view.tables is not None:
        kv_cache_write(cache, ("ckv", "kr"), (ckv, k_rope), view=kv_view)
        ctx = paged_decode_attention(
            q_eff * comp, cache, ("ckv", "kr"), "ckv", kv_view, kv_heads=1,
            causal=cfg.causal, impl=impl, name="mla.paged",
        )                                                       # (B, S, h, lora)
    else:
        if cache is None:
            ckv_full, kr_full, kv_len, q_offset = ckv, k_rope, None, 0
        else:
            (ckv_full, kr_full), q_offset, kv_len = _dense_kv(
                cache, ("ckv", "kr"), (ckv, k_rope), x, cache_pos, kv_view)
        k_eff = torch.cat([ckv_full, kr_full], dim=-1)[:, :, None, :]
        ctx = blockwise_attention(q_eff * comp, k_eff, ckv_full[:, :, None, :],
                                  q_offset=q_offset, kv_len=kv_len, causal=cfg.causal,
                                  chunk=chunk)
    out = absorb("mla.w_uv", "bshl,lhv->bshv", ctx, p["w_uv"]["kernel"])
    return dense(p["wo"], out.reshape(B, S, h * vd), backend=backend, name="mla.o", impl=impl)
