"""Shared model layers: RMS norm, RoPE, SwiGLU MLP, embedding lookup.

Functional, over plain parameter dicts in the reference's layout; every
matmul routes through ``quant.qlinear`` (the tuGEMM integration point)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..quant.qlinear import dense

__all__ = ["rms_norm", "rope_freqs", "apply_rope", "mlp", "embed_lookup"]


def rms_norm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32)).to(dt)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies, in f32 (made on ``device``: no
    host copy, so a step never waits for the stream here)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32, device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int. Rotates the two halves."""
    inv = rope_freqs(x.shape[-1], theta, device=x.device)
    angles = positions[..., None, None].to(torch.float32) * inv     # (B,S,1,hd/2)
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    cos, sin = torch.cos(angles), torch.sin(angles)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def mlp(p: dict, x: torch.Tensor, mlp_type: str = "swiglu", *, backend,
        name: str = "mlp", impl: str = "auto") -> torch.Tensor:
    if mlp_type != "swiglu":
        raise NotImplementedError(f"mlp_type {mlp_type!r} is not ported yet")
    g = dense(p["w_gate"], x, backend=backend, name=f"{name}.gate", impl=impl)
    u = dense(p["w_up"], x, backend=backend, name=f"{name}.up", impl=impl)
    return dense(p["w_down"], F.silu(g) * u, backend=backend, name=f"{name}.down", impl=impl)


def embed_lookup(p: dict, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return p["embedding"].to(dtype)[tokens]
