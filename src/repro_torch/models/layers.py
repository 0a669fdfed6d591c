"""Shared model layers: RMS norm, RoPE and M-RoPE, the SwiGLU and gelu MLPs,
embedding lookup.

Functional, over plain parameter dicts in the reference's layout; every
matmul routes through ``quant.qlinear`` (the tuGEMM integration point)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel.sharding import constrain
from ..quant.qlinear import dense

__all__ = ["rms_norm", "rope_freqs", "apply_rope", "apply_mrope", "mlp", "embed_lookup"]


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


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate the two halves of x (..., S, H, hd) by angles (..., S, 1, hd/2), in f32."""
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    cos, sin = torch.cos(angles), torch.sin(angles)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int. Rotates the two halves."""
    inv = rope_freqs(x.shape[-1], theta, device=x.device)
    angles = positions[..., None, None].to(torch.float32) * inv     # (B,S,1,hd/2)
    return _rotate(x, angles).to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: tuple[int, ...]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE. x: (B, S, H, hd); positions: (3, B, S), the
    (t, h, w) indices. Frequency slot i takes the positions of section
    ``sec_id[i]`` (the slots split into ``sections``, which sum to hd/2).
    With t = h = w every angle is the product RoPE takes, so the result
    equals :func:`apply_rope`'s bit for bit."""
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"M-RoPE sections {sections} do not sum to head_dim/2 = {hd // 2}")
    inv = rope_freqs(hd, theta, device=x.device)
    # slot i's positions: section sec_id[i]'s, built by slices (no index
    # tensor, so no host copy on the card)
    pos = torch.cat([positions[j, ..., None].expand(*positions.shape[1:], n)
                     for j, n in enumerate(sections)], dim=-1)     # (B, S, hd/2)
    angles = pos[..., None, :].to(torch.float32) * inv              # (B,S,1,hd/2)
    return _rotate(x, angles).to(x.dtype)


def mlp(p: dict, x: torch.Tensor, mlp_type: str = "swiglu", *, backend,
        name: str = "mlp", impl: str = "auto") -> torch.Tensor:
    """SwiGLU (``w_gate``, ``w_up``, ``w_down``) or, for ``mlp_type="gelu"``,
    the non-gated MLP ``down(gelu(up(x)))`` with biases (hubert). The gelu is
    the tanh form, which is ``jax.nn.gelu``'s default; the two frameworks
    evaluate it in another op order, within 2 ulp of max(|x|, 1) in f32."""
    if mlp_type == "swiglu":
        g = dense(p["w_gate"], x, backend=backend, name=f"{name}.gate", impl=impl)
        u = dense(p["w_up"], x, backend=backend, name=f"{name}.up", impl=impl)
        h = F.silu(g) * u
    elif mlp_type == "gelu":
        h = F.gelu(dense(p["w_up"], x, backend=backend, name=f"{name}.up", impl=impl),
                   approximate="tanh")
    else:
        raise ValueError(f"unknown mlp_type {mlp_type!r}")
    h = constrain(h, "batch", None, "act_mlp")
    return dense(p["w_down"], h, backend=backend, name=f"{name}.down", impl=impl)


def embed_lookup(p: dict, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return p["embedding"].to(dtype)[tokens]
