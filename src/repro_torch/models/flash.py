"""Paged attention read side: the dispatcher over the paged flash-decode
kernel (``kernels/flash_paged.py``)."""

from __future__ import annotations

import torch

from ..kernels import ops
from ..kernels.flash_paged import flash_paged_decode

__all__ = ["paged_decode_attention"]


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
    ``impl="torch"``."""
    path = ops.resolve_path(impl, q)
    ops.record_path(name, path)
    int8 = cache[k_names[0]].dtype == torch.int8

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
        kv_heads=kv_heads, causal=causal, window=window, impl=path,
    )
