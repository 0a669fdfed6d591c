"""GQA attention (+qk_norm, RoPE) and MLA (DeepSeek-V2) over the paged KV
pool.

The pool is a fixed set of ``block_size``-token pages shared by all slots
and addressed through per-slot block tables (a :class:`KVView`), so one
step mixes prefill chunks and decode rows. int8 pools store per-(page,
token) scales (``_quantize_kv``). Writes are eager in-place scatters into
the pool; padded step columns land on the trailing trash page, which is
never read. MLA caches the compressed kv latent (``ckv``) and the shared
rope key (``kr``), each with its own per-token scale, and attends in the
absorbed form: one kv head whose K is ``[ckv ; kr]`` and whose V is
``ckv``. The dense per-slot layout is a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..configs.base import ModelConfig
from ..kernels.flash_paged import gather_pages
from ..quant.qlinear import dense
from .flash import paged_decode_attention
from .layers import apply_rope, rms_norm

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
    block index -> page id in the pool."""

    pos: torch.Tensor                   # (B,) int32
    lens: torch.Tensor                  # (B,) int32
    tables: torch.Tensor | None = None  # (B, max_blocks) int32 page ids
    block_size: int = 16
    layout: str = "paged"

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


def _quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(batch, position) int8 quantization over heads*dim; the scale is
    ``max(amax, 1e-8) / 127`` in the division form (a tensor divisor, so no
    backend rewrites it into a reciprocal multiply; filled on the device, so
    no host copy waits for the stream)."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=tuple(range(2, x.ndim)))
    scale = amax.clamp_min(1e-8) / torch.full((), 127.0, dtype=torch.float32, device=x.device)
    q = torch.round(xf / scale.reshape(scale.shape + (1,) * (x.ndim - 2)))
    return torch.clamp(q, -128, 127).to(torch.int8), scale


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


def kv_cache_write(cache: dict, names: tuple[str, ...], new: tuple, *, view: KVView) -> dict:
    """Write each row's ``lens[b]`` tokens of ``new`` (B, S, ...) at its own
    ``pos[b]`` through the block table, in place; int8 pools quantize per
    token first."""
    if view.tables is None:
        raise NotImplementedError("dense KV layout is not ported yet; use kv_layout='paged'")
    for name, val in zip(names, new):
        buf = cache[name]
        if buf.dtype == torch.int8:
            q, s = _quantize_kv(val)
            vals = [(name, q), (name + "_scale", s)]
        else:
            vals = [(name, val.to(buf.dtype))]
        B, S = val.shape[:2]
        page, off = _paged_targets(view, B, S, buf.shape[0])
        for n, v in vals:
            cache[n][page, off] = v
    return cache


def kv_cache_read(cache: dict, name: str, compute_dtype, *, view: KVView) -> torch.Tensor:
    """Gather one pool through the block tables into a contiguous
    (B, max_blocks*block_size, ...) view, dequantized and length-masked:
    positions at or beyond kv_len read as exact zeros."""
    if view.tables is None:
        raise NotImplementedError("dense KV layout is not ported yet; use kv_layout='paged'")
    pool = cache[name]
    flat = pool.reshape(pool.shape[0], pool.shape[1], -1)
    buf = gather_pages(flat, cache.get(name + "_scale"), view.tables)
    buf = buf.reshape(buf.shape[:2] + tuple(pool.shape[2:]))
    live = torch.arange(buf.shape[1], device=buf.device)[None, :] < view.kv_len.long()[:, None]
    buf = torch.where(live.reshape(live.shape + (1,) * (buf.ndim - 2)), buf, 0)
    return buf.to(compute_dtype)


def gqa_attention(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,                # (B, S, D)
    positions: torch.Tensor,        # (B, S)
    *,
    backend,
    cache: dict,
    kv_view: KVView,
    is_global: bool = True,
    impl: str = "auto",
) -> torch.Tensor:
    """One GQA layer of a paged mixed step: projections, qk-norm, RoPE, the
    in-place KV write, paged attention, output projection."""
    B, S, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    if cfg.mrope_sections is not None or cfg.attn_logit_softcap is not None:
        raise NotImplementedError("M-RoPE / logit softcap are not ported yet")
    q = dense(p["wq"], x, backend=backend, name="attn.q", impl=impl).reshape(B, S, h, hd)
    k = dense(p["wk"], x, backend=backend, name="attn.k", impl=impl).reshape(B, S, kv, hd)
    v = dense(p["wv"], x, backend=backend, name="attn.v", impl=impl).reshape(B, S, kv, hd)
    if cfg.qk_norm:
        q = rms_norm(p["q_norm"], q, cfg.rms_eps)
        k = rms_norm(p["k_norm"], k, cfg.rms_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    kv_cache_write(cache, ("k", "v"), (k, v), view=kv_view)
    window = None if is_global else cfg.sliding_window
    out = paged_decode_attention(
        q, cache, ("k",), "v", kv_view, kv_heads=kv, causal=cfg.causal,
        window=window, impl=impl, name="attn.paged",
    )
    return dense(p["wo"], out.reshape(B, S, h * hd), backend=backend, name="attn.o", impl=impl)


def mla_attention(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,                # (B, S, D)
    positions: torch.Tensor,        # (B, S)
    *,
    backend,
    cache: dict,
    kv_view: KVView,
    impl: str = "auto",
    **_unused,
) -> torch.Tensor:
    """One MLA layer of a paged mixed step in the absorbed form: q and the
    compressed kv latent, RoPE on their rope parts, the in-place write of
    ``ckv`` / ``kr``, ``q_nope`` absorbed into the latent space through
    ``w_uk`` (an f32 einsum, outside the hardware boundary as in the
    reference), paged attention over one kv head with K = ``[ckv ; kr]``
    and V = ``ckv``, then ``w_uv`` and the output projection."""
    B, S, _ = x.shape
    h = cfg.num_heads
    nope, rope_d = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    vd, lora = cfg.v_head_dim, cfg.kv_lora_rank
    scale_dim = nope + rope_d

    q = dense(p["wq"], x, backend=backend, name="mla.q", impl=impl).reshape(B, S, h, scale_dim)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    dkv = dense(p["w_dkv"], x, backend=backend, name="mla.dkv", impl=impl)
    ckv, k_rope = dkv[..., :lora], dkv[..., lora:]
    ckv = rms_norm(p["kv_norm"], ckv, cfg.rms_eps)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]

    # absorbed form: q_abs[b,s,h,:] = q_nope · W_uk[:,h,:]^T (in latent space)
    q_abs = torch.einsum("bshn,lhn->bshl", q_nope.to(torch.float32),
                         p["w_uk"]["kernel"].to(torch.float32)).to(x.dtype)
    q_eff = torch.cat([q_abs, q_rope], dim=-1)                  # (B, S, h, lora+rope)
    # the kernel scales scores by 1/sqrt(lora+rope); MLA's is 1/sqrt(nope+rope)
    comp = ((lora + rope_d) ** 0.5) / (scale_dim ** 0.5)

    kv_cache_write(cache, ("ckv", "kr"), (ckv, k_rope), view=kv_view)
    ctx = paged_decode_attention(
        q_eff * comp, cache, ("ckv", "kr"), "ckv", kv_view, kv_heads=1,
        causal=cfg.causal, impl=impl, name="mla.paged",
    )                                                           # (B, S, h, lora)
    out = torch.einsum("bshl,lhv->bshv", ctx.to(torch.float32),
                       p["w_uv"]["kernel"].to(torch.float32)).to(x.dtype)
    return dense(p["wo"], out.reshape(B, S, h * vd), backend=backend, name="mla.o", impl=impl)
