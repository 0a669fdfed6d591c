"""Attention read side: ``blockwise_attention`` over contiguous K/V (the
dense KV layout and the no-cache forward), and the dispatcher over the
paged flash-decode kernel (``kernels/flash_paged.py``).

``blockwise_attention`` is the forward of the reference's
``repro/models/flash.py``: an online softmax over ``chunk``-wide KV chunks,
or for ``Sq <= 4`` one masked product and softmax over the whole cache. GQA
repeats KV heads chunk by chunk; causal, sliding-window and valid-length
masks come from position arithmetic; ``q_offset`` / ``kv_len`` are Python
ints or (B,) tensors, so rows of one step may sit at different positions.
The reference computes it outside any Pallas kernel, so plain PyTorch is
its port. The no-cache case (``kv_len is None`` and ``q_offset == 0``: the
training and encoder forward) runs as a ``torch.autograd.Function`` whose
backward is the reference's chunked-recompute ``_bwd_scan`` (FlashAttention-2):
it saves only ``q, k, v, out`` and the log-sum-exp, and recomputes each
chunk's probabilities, so no (Sq, Skv) score tensor outlives its chunk in
either direction. The logit softcap runs in both directions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..kernels.flash_paged import flash_paged_decode

__all__ = ["blockwise_attention", "paged_decode_attention"]

NEG_INF = -1e30


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, C, KV, hd) -> (B, C, KV*n_rep, hd)."""
    if n_rep == 1:
        return x
    b, c, kv, hd = x.shape
    return x[:, :, :, None, :].expand(b, c, kv, n_rep, hd).reshape(b, c, kv * n_rep, hd)


def _per_row(v) -> bool:
    return isinstance(v, torch.Tensor) and v.ndim == 1


def _q_positions(q_offset, Sq: int, device) -> torch.Tensor:
    """(Sq,) for a scalar offset, (B, Sq) for per-row offsets."""
    cols = torch.arange(Sq, dtype=torch.int64, device=device)
    if _per_row(q_offset):
        return q_offset.long()[:, None] + cols
    return cols + q_offset


def _chunk_mask(q_pos, k_pos, valid_len, causal: bool, window):
    """Visibility over one KV chunk: (Sq, C) when ``q_pos`` is (Sq,) and
    ``valid_len`` a scalar, else (B, Sq, C)."""
    if q_pos.ndim == 1 and not _per_row(valid_len):
        mask = k_pos[None, :] < valid_len
        if causal:
            mask = mask & (k_pos[None, :] <= q_pos[:, None])
        if window is not None:
            mask = mask & (q_pos[:, None] - k_pos[None, :] < window)
        return mask
    qp = q_pos if q_pos.ndim == 2 else q_pos[None, :]
    vl = valid_len[:, None, None] if _per_row(valid_len) else valid_len
    mask = k_pos[None, None, :] < vl
    if causal:
        mask = mask & (k_pos[None, None, :] <= qp[:, :, None])
    if window is not None:
        mask = mask & (qp[:, :, None] - k_pos[None, None, :] < window)
    return mask


def _fwd_scan(q, k, v, q_offset, valid_len, causal, window, chunk, softcap):
    """Online softmax over KV chunks; returns (out (B, Sq, H, hdv) in
    q.dtype, lse (B, H, Sq) f32)."""
    B, Sq, H, _ = q.shape
    Skv, KV, hdv = v.shape[1:]
    n_rep = H // KV
    scale = 1.0 / (k.shape[-1] ** 0.5)
    pad = (-Skv) % chunk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    qf = q.to(torch.float32) * scale
    q_pos = _q_positions(q_offset, Sq, q.device)
    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Sq, hdv), dtype=torch.float32, device=q.device)
    for c0 in range(0, k.shape[1], chunk):
        k_pos = torch.arange(c0, c0 + chunk, dtype=torch.int64, device=q.device)
        k_r = _repeat_kv(k[:, c0:c0 + chunk], n_rep).to(torch.float32)
        v_r = _repeat_kv(v[:, c0:c0 + chunk], n_rep).to(torch.float32)
        s = torch.einsum("bqhd,bchd->bhqc", qf, k_r)
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        mask = _chunk_mask(q_pos, k_pos, valid_len, causal, window)
        s = torch.where(mask[None, None] if mask.ndim == 2 else mask[:, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqc,bchd->bhqd", p, v_r)
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    lse = m + torch.log(torch.clamp_min(l, 1e-30))
    return out.transpose(1, 2).to(q.dtype), lse


def _bwd_scan(q, k, v, out, lse, g, causal, window, chunk, softcap):
    """FlashAttention-2 backward: recompute each chunk's probabilities from
    the saved log-sum-exp; accumulate dq, emit each chunk's dk / dv (GQA:
    summed over the query heads that share a KV head)."""
    B, Sq, H, hd = q.shape
    Skv, KV, hdv = v.shape[1:]
    n_rep = H // KV
    scale = 1.0 / (k.shape[-1] ** 0.5)
    pad = (-Skv) % chunk
    kp = F.pad(k, (0, 0, 0, 0, 0, pad)) if pad else k
    vp = F.pad(v, (0, 0, 0, 0, 0, pad)) if pad else v
    qf = q.to(torch.float32)
    do = g.to(torch.float32).transpose(1, 2)                      # (B, H, Sq, hdv)
    delta = (do * out.to(torch.float32).transpose(1, 2)).sum(-1)  # (B, H, Sq)
    q_pos = torch.arange(Sq, dtype=torch.int64, device=q.device)
    dq = torch.zeros((B, Sq, H, hd), dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for c0 in range(0, kp.shape[1], chunk):
        k_pos = torch.arange(c0, c0 + chunk, dtype=torch.int64, device=q.device)
        k_r = _repeat_kv(kp[:, c0:c0 + chunk], n_rep).to(torch.float32)   # (B, C, H, hd)
        v_r = _repeat_kv(vp[:, c0:c0 + chunk], n_rep).to(torch.float32)
        s = torch.einsum("bqhd,bchd->bhqc", qf * scale, k_r)
        if softcap is not None:
            t = torch.tanh(s / softcap)
            s = softcap * t
        mask = _chunk_mask(q_pos, k_pos, Skv, causal, window)
        p = torch.where(mask[None, None], torch.exp(s - lse[..., None]), 0.0)
        dp = torch.einsum("bhqd,bchd->bhqc", do, v_r)
        ds = p * (dp - delta[..., None])
        if softcap is not None:
            ds = ds * (1.0 - t * t)
        dq = dq + torch.einsum("bhqc,bchd->bqhd", ds, k_r) * scale
        dk_c = torch.einsum("bhqc,bqhd->bchd", ds, qf) * scale
        dv_c = torch.einsum("bhqc,bhqd->bchd", p, do)
        dks.append(dk_c.reshape(B, chunk, KV, n_rep, hd).sum(3))
        dvs.append(dv_c.reshape(B, chunk, KV, n_rep, hdv).sum(3))
    dk = torch.cat(dks, dim=1)[:, :Skv]
    dv = torch.cat(dvs, dim=1)[:, :Skv]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _TrainableAttention(torch.autograd.Function):
    """No-cache attention with the chunked-recompute backward (the
    reference's ``_trainable_attention`` custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, chunk, softcap):
        out, lse = _fwd_scan(q, k, v, 0, k.shape[1], causal, window, chunk, softcap)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = (causal, window, chunk, softcap)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        return (*_bwd_scan(q, k, v, out, lse, g, *ctx.opts), None, None, None, None)


def _decode_direct(q, k, v, q_offset, valid_len, causal, window, softcap):
    """Sq <= 4 without the chunk scan: one masked product and softmax over
    the whole cache (q rounded to the cache's dtype, products accumulated
    in f32, as the reference's)."""
    B, Sq, H, hd = q.shape
    Skv, KV, hdv = v.shape[1:]
    n_rep = H // KV
    scale = 1.0 / (k.shape[-1] ** 0.5)
    qf = (q.to(torch.float32) * scale).reshape(B, Sq, KV, n_rep, hd)
    s = torch.einsum("bqkrd,bckd->bkrqc", qf.to(k.dtype).to(torch.float32),
                     k.to(torch.float32))
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    k_pos = torch.arange(Skv, dtype=torch.int64, device=q.device)
    mask = _chunk_mask(_q_positions(q_offset, Sq, q.device), k_pos, valid_len, causal, window)
    s = torch.where(mask[None, None, None] if mask.ndim == 2 else mask[:, None, None], s, NEG_INF)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkrqc,bckd->bqkrd", p.to(v.dtype).to(torch.float32),
                       v.to(torch.float32))
    return out.reshape(B, Sq, H, hdv).to(q.dtype)


def blockwise_attention(
    q: torch.Tensor,                    # (B, Sq, H, hd)
    k: torch.Tensor,                    # (B, Skv, KV, hd)
    v: torch.Tensor,                    # (B, Skv, KV, hdv)
    *,
    q_offset: torch.Tensor | int = 0,   # absolute position of q[:, 0]
    kv_len: torch.Tensor | int | None = None,   # valid cache length (None -> Skv)
    causal: bool = True,
    window: int | None = None,          # sliding-window width (None -> full)
    chunk: int = 1024,
    softcap: float | None = None,
) -> torch.Tensor:
    """(B, Sq, H, hdv) attention output in q.dtype."""
    Skv = k.shape[1]
    chunk = min(chunk, Skv)
    if kv_len is None and isinstance(q_offset, int) and q_offset == 0:
        return _TrainableAttention.apply(q, k, v, causal, window, chunk, softcap)
    valid_len = Skv if kv_len is None else kv_len
    if q.shape[1] <= 4:
        return _decode_direct(q, k, v, q_offset, valid_len, causal, window, softcap)
    return _fwd_scan(q, k, v, q_offset, valid_len, causal, window, chunk, softcap)[0]


def paged_decode_attention(
    q: torch.Tensor,            # (B, Sq, H, hd_tot)
    cache: dict,                # paged pools (pages+1, block_size, ...)
    k_names: tuple[str, ...],   # pool names whose feature concat forms K
    v_name: str,                # pool name read as V
    view,                       # KVView with tables (paged layout)
    *,
    kv_heads: int,
    causal: bool = True,
    window: int | None = None,
    impl: str = "auto",
    name: str = "attn.paged",
) -> torch.Tensor:
    """Fused paged read + attend. Always returns the attention output: the
    kernel's on a CUDA tensor, the plain version's on a CPU tensor or under
    ``impl="torch"``.

    Under a mesh program (the sharded serving step) the kernel stays on,
    over this rank's rows and heads, with the split plan of the
    single-device launch it is a slice of (``MeshProgram.attn_plan_dims``),
    so each head's float combine order is the single-device one. (The
    reference takes its gather path there instead.)"""
    from ..parallel.collectives import current_program

    path = ops.resolve_path(impl, q)
    ops.record_path(name, path)
    int8 = cache[k_names[0]].dtype == torch.int8
    prog = current_program()
    plan_dims = None if prog is None else prog.attn_plan_dims(
        q.shape[0], q.shape[2], kv_heads, q.shape[1])

    def pool3(n):  # (P+1, bs, kv, hd) and (P+1, bs, f) both -> (P+1, bs, kv*f)
        p = cache[n]
        return p.reshape(p.shape[0], p.shape[1], -1)

    return flash_paged_decode(
        q.contiguous(),
        tuple(pool3(n) for n in k_names),
        tuple(cache[n + "_scale"] if int8 else None for n in k_names),
        pool3(v_name),
        cache[v_name + "_scale"] if int8 else None,
        view.tables, view.pos, view.kv_len,
        kv_heads=kv_heads, causal=causal, window=window, impl=ops.kernel_impl(path),
        plan_dims=plan_dims,
    )
