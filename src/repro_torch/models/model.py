"""Model entry points: parameter init at the reference's shapes and scales."""

from __future__ import annotations

import torch

from .. import resolve_device
from ..configs.base import ModelConfig, RunConfig
from .transformer import check_supported, plan_groups, torch_dtype

__all__ = ["init"]


def _block_shapes(cfg: ModelConfig) -> dict:
    """One dense GQA block's parameter shapes and init ("normal" at std 0.02,
    "ones" for norms) — the reference's ``block_spec``."""
    d, h, kv, hd, ff = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                        cfg.resolved_head_dim, cfg.d_ff)
    attn = {
        "wq": {"kernel": ((d, h * hd), "normal")},
        "wk": {"kernel": ((d, kv * hd), "normal")},
        "wv": {"kernel": ((d, kv * hd), "normal")},
        "wo": {"kernel": ((h * hd, d), "normal")},
    }
    if cfg.qk_norm:
        attn["q_norm"] = {"scale": ((hd,), "ones")}
        attn["k_norm"] = {"scale": ((hd,), "ones")}
    return {
        "norm1": {"scale": ((d,), "ones")},
        "attn": attn,
        "norm2": {"scale": ((d,), "ones")},
        "ffn": {
            "w_gate": {"kernel": ((d, ff), "normal")},
            "w_up": {"kernel": ((d, ff), "normal")},
            "w_down": {"kernel": ((ff, d), "normal")},
        },
    }


def _materialize(spec, lead: tuple, gen, dtype, device):
    if isinstance(spec, dict):
        return {k: _materialize(v, lead, gen, dtype, device) for k, v in spec.items()}
    shape, how = spec
    shape = lead + tuple(shape)
    if how == "ones":
        t = torch.ones(shape, dtype=torch.float32)
    else:
        t = torch.randn(shape, generator=gen, dtype=torch.float32) * 0.02
    return t.to(dtype=dtype, device=device)


def init(cfg: ModelConfig, rc: RunConfig, generator: torch.Generator | None = None,
         device=None) -> dict:
    """Random parameters in the reference's tree layout (``embed``,
    stacked ``groups``, ``final_norm`` [, ``head``]), drawn on the CPU from
    ``generator`` (a fresh ``torch.Generator().manual_seed(0)`` when None)
    and placed on ``device`` (default ``cuda``)."""
    check_supported(cfg, rc)
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    dtype = torch_dtype(rc.param_dtype)
    params = {"embed": _materialize({"embedding": ((cfg.vocab_size, cfg.d_model), "normal")},
                                    (), gen, dtype, dev)}
    params["groups"] = tuple(
        {f"k{j}": _materialize(_block_shapes(cfg), (g.repeats,), gen, dtype, dev)
         for j in range(len(g.kinds))}
        for g in plan_groups(cfg)
    )
    params["final_norm"] = _materialize({"scale": ((cfg.d_model,), "ones")}, (), gen, dtype, dev)
    if not cfg.tie_embeddings:
        params["head"] = _materialize({"kernel": ((cfg.d_model, cfg.vocab_size), "normal")},
                                      (), gen, dtype, dev)
    return params

