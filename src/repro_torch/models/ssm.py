"""Mamba-1 selective SSM mixer (falcon-mamba, and hymba's SSM heads), after
the reference's ``repro/models/ssm.py``.

Prefill runs the linear recurrence ``h_t = a_t * h_{t-1} + b_t`` over the
sequence as a log-depth scan in f32: the reference's
``jax.lax.associative_scan`` recursion (pairs combined, the odd prefixes
scanned recursively, the even ones filled in from them), so each element is
combined in the reference's order and a prefill issues O(log S) launches a
layer, not O(S). Decode is one O(1) update of the SSM state ``h`` and the
conv window ``conv``.

The four projections route through ``quant.qlinear.dense`` (the tuGEMM
boundary); the depthwise conv and the recurrence stay in floating point, as
in the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..parallel.sharding import constrain
from ..quant.qlinear import dense

__all__ = ["mamba_mixer", "mamba_decode_step", "init_ssm_state"]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``'s form: max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B, S, di), w: (ck, di) -> (B, S, di); the
    taps summed in the reference's order (Python ``sum``, from 0)."""
    ck, S = w.shape[0], x.shape[1]
    pad = F.pad(x.to(torch.float32), (0, 0, ck - 1, 0))
    y = sum(pad[:, j:j + S, :] * w[j].to(torch.float32) for j in range(ck))
    return (y + b.to(torch.float32)).to(x.dtype)


def _combine(a_l, b_l, a_r, b_r):
    return a_l * a_r, b_l * a_r + b_r


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even[0], odd[0], even[1], odd[1], ... along dim 1."""
    out = even.new_empty((even.shape[0], even.shape[1] + odd.shape[1]) + tuple(even.shape[2:]))
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _scan(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of (a, b) pairs under ``_combine`` along dim 1, in the
    reference's ``associative_scan`` order."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine(a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2])
    oa, ob = _scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def _ssm_inputs(cfg: ModelConfig, p: dict, x: torch.Tensor, *, backend, impl: str):
    """dt, B, C (f32) and A from the post-conv activations x (B, S, di)."""
    n, r = cfg.ssm_state, cfg.dt_rank
    dbc = dense(p["x_proj"], x, backend=backend, name="ssm.x_proj", impl=impl).to(torch.float32)
    dt_low, B_, C_ = dbc[..., :r], dbc[..., r:r + n], dbc[..., r + n:]
    dt = dense(p["dt_w"], dt_low.to(x.dtype), backend=backend, name="ssm.dt", impl=impl)
    dt = _softplus(dt.to(torch.float32) + p["dt_bias"].to(torch.float32))
    A = -torch.exp(p["A_log"].to(torch.float32))                # (di, n), always negative
    return dt, B_, C_, A


def _gate_out(p: dict, y, x_act, z, u, *, backend, impl: str, site: bool = False) -> torch.Tensor:
    """y + D·x, gated by silu(z), through ``ssm.out_proj`` (``site``: the
    full scan's, whose input is constrained as the reference's)."""
    y = y + p["D"].to(torch.float32) * x_act
    y = y * F.silu(z.to(torch.float32))
    y = y.to(u.dtype)
    if site:
        y = constrain(y, "batch", None, "act_inner")
    return dense(p["out_proj"], y, backend=backend, name="ssm.out_proj", impl=impl)


def mamba_mixer(cfg: ModelConfig, p: dict, u: torch.Tensor, *, backend,
                return_state: bool = False, impl: str = "auto"):
    """Full-sequence selective scan over u (B, S, D). Returns (out, state):
    ``state`` is None unless ``return_state``, else {"h": (B, di, n) f32,
    "conv": the last ``ssm_conv - 1`` pre-conv inputs (B, <= ck-1, di) f32}.
    As in the reference, a prompt shorter than ``ssm_conv - 1`` tokens gives
    a conv state of only its own length."""
    di = cfg.d_inner
    xz = dense(p["in_proj"], u, backend=backend, name="ssm.in_proj", impl=impl)
    x, z = xz[..., :di], xz[..., di:]
    x = constrain(x, "batch", None, "act_inner")
    x_act = F.silu(_causal_conv(x, p["conv_w"], p["conv_b"]).to(torch.float32))
    dt, B_, C_, A = _ssm_inputs(cfg, p, x_act.to(u.dtype), backend=backend, impl=impl)
    # discretize: a = exp(dt*A), b = dt * B ⊙ x, both (B, S, di, n)
    a = torch.exp(dt[..., None] * A)
    b = (dt * x_act)[..., None] * B_[:, :, None, :]
    _, hs = _scan(a, b)
    y = (hs * C_[:, :, None, :]).sum(-1)                         # (B, S, di)
    out = _gate_out(p, y, x_act, z, u, backend=backend, impl=impl, site=True)
    if not return_state:
        return out, None
    return out, {"h": hs[:, -1].to(torch.float32),
                 "conv": x[:, -(cfg.ssm_conv - 1):].to(torch.float32)}


def init_ssm_state(cfg: ModelConfig, batch: int, device) -> dict:
    return {
        "h": torch.zeros((batch, cfg.d_inner, cfg.ssm_state), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner), dtype=torch.float32,
                            device=device),
    }


def mamba_decode_step(cfg: ModelConfig, p: dict, u: torch.Tensor, state: dict, *, backend,
                      impl: str = "auto"):
    """One token u (B, 1, D) against ``state``; returns (out, new state)."""
    di = cfg.d_inner
    xz = dense(p["in_proj"], u, backend=backend, name="ssm.in_proj", impl=impl)
    x, z = xz[..., :di], xz[..., di:]                            # (B, 1, di)
    conv_in = torch.cat([state["conv"], x.to(torch.float32)], dim=1)   # (B, ck, di)
    xc = (conv_in * p["conv_w"].to(torch.float32)[None]).sum(1) + p["conv_b"].to(torch.float32)
    x_act = F.silu(xc)[:, None, :]                               # (B, 1, di)
    dt, B_, C_, A = _ssm_inputs(cfg, p, x_act.to(u.dtype), backend=backend, impl=impl)
    a = torch.exp(dt[..., None] * A)                             # (B, 1, di, n)
    b = (dt * x_act)[..., None] * B_[:, :, None, :]
    h = state["h"] * a[:, 0] + b[:, 0]                           # (B, di, n)
    y = (h * C_[:, 0, None, :]).sum(-1)[:, None, :]              # (B, 1, di)
    out = _gate_out(p, y, x_act, z, u, backend=backend, impl=impl)
    return out, {"h": h, "conv": conv_in[:, 1:]}
