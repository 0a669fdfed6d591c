"""AdamW with optional int8 block-quantized moments + the warmup-cosine
schedule: the reference's ``repro/optim/adamw.py`` op for op.

8-bit moments: m as linear int8 codes with one f32 scale per 64-wide block
along the last axis, v as geometric uint8 codes (8 decades at ~3.7% max
relative error: linear int8 zeroes a block's small second moments and
1/sqrt(v) then explodes). Only leaves with ndim >= 2 are quantized, and
only they take weight decay; norm scales and biases stay f32.

The port updates the state in place (the master weights and moments are
overwritten leaf by leaf, the step counter too) and writes the new
parameters into the parameter tensors (cast to their dtype), so a step
never holds two copies of the optimizer state. The master weights are
their own tensors: they never alias the parameters.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..configs.base import RunConfig
from ..tree import leaves, tree_map

__all__ = ["AdamWState", "init_opt_state", "adamw_update", "lr_schedule", "global_norm",
           "clip_by_global_norm"]

_BLOCK = 64
# ln(r) of the geometric codes: r^255 = 1e-8
_LOG_LN_R = math.log(1e-8) / 255.0


# ---------------------------------------------------- int8 block quantization
def _blocks(x: torch.Tensor) -> torch.Tensor:
    """x (..., K) f32, zero-padded to whole blocks: (..., nb, 64)."""
    K = x.shape[-1]
    nb = -(-K // _BLOCK)
    xp = torch.nn.functional.pad(x.to(torch.float32), (0, nb * _BLOCK - K))
    return xp.reshape(*x.shape[:-1], nb, _BLOCK)


def _unblocks(xb: torch.Tensor, K: int) -> torch.Tensor:
    return xb.reshape(*xb.shape[:-2], -1)[..., :K]


def _q8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (..., K) -> (q int8 (..., K), scales f32 (..., nb))."""
    xb = _blocks(x)
    s = xb.abs().amax(-1) / 127.0 + 1e-12
    q = torch.round(xb / s[..., None]).to(torch.int8)
    return _unblocks(q, x.shape[-1]), s


def _dq8(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    K = q.shape[-1]
    qb = torch.nn.functional.pad(q, (0, s.shape[-1] * _BLOCK - K))
    xb = qb.reshape(*q.shape[:-1], s.shape[-1], _BLOCK).to(torch.float32) * s[..., None]
    return _unblocks(xb, K)


def _q8_log(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Non-negative x (..., K) -> (codes uint8, scales f32 (..., nb)): code
    c > 0 stands for ``s * r^(255 - c)``, code 0 for zero."""
    xb = _blocks(x)
    s = xb.amax(-1) + 1e-30
    ratio = torch.clamp(xb / s[..., None], 1e-12, 1.0)
    c = 255.0 - torch.log(ratio) / _LOG_LN_R
    c = torch.where(xb <= s[..., None] * 1e-8, 0.0, torch.clamp(torch.round(c), 1, 255))
    return _unblocks(c.to(torch.uint8), x.shape[-1]), s


def _dq8_log(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    K = q.shape[-1]
    qp = torch.nn.functional.pad(q, (0, s.shape[-1] * _BLOCK - K))
    qb = qp.reshape(*q.shape[:-1], s.shape[-1], _BLOCK).to(torch.float32)
    v = torch.where(qb == 0, 0.0, torch.exp((255.0 - qb) * _LOG_LN_R)) * s[..., None]
    return _unblocks(v, K)


def _quantize_moments(leaf: torch.Tensor) -> bool:
    return leaf.ndim >= 2


# ------------------------------------------------------------------ schedule
def lr_schedule(rc: RunConfig, step) -> torch.Tensor:
    """Linear warmup -> cosine decay to 10% (``step`` a number or an f32
    tensor)."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp_max(step / max(rc.warmup_steps, 1), 1.0)
    t = torch.clamp((step - rc.warmup_steps) / max(rc.total_steps - rc.warmup_steps, 1),
                    0.0, 1.0)
    cos = 0.1 + 0.45 * (1.0 + torch.cos(math.pi * t))
    return rc.lr * warm * cos


# ---------------------------------------------------------------- state/init
@dataclass
class AdamWState:
    step: torch.Tensor  # int32 scalar
    master: dict        # f32 (or bf16) master weights
    m: dict             # f32 tensor, or {"q": int8, "s": f32} when quantized
    v: dict             # f32 tensor, or {"q": uint8, "s": f32} when quantized


def _zeros_moment(leaf: torch.Tensor, quantize: bool, log: bool = False):
    z = torch.zeros(leaf.shape, dtype=torch.float32, device=leaf.device)
    if quantize and _quantize_moments(leaf):
        q, s = (_q8_log if log else _q8)(z)
        return {"q": q, "s": s}
    return z


def init_opt_state(params: dict, rc: RunConfig) -> AdamWState:
    quant = rc.moments_dtype == "int8"
    master_dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[rc.master_dtype]
    master = tree_map(lambda p: p.detach().to(master_dt, copy=True), params)
    m = tree_map(lambda p: _zeros_moment(p, quant), params)
    v = tree_map(lambda p: _zeros_moment(p, quant, log=True), params)
    dev = leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev), master=master,
                      m=m, v=v)


# ------------------------------------------------------------------- update
def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32))) for g in leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    gn = global_norm(tree)
    scale = torch.clamp_max(max_norm / torch.clamp_min(gn, 1e-12), 1.0)
    return tree_map(lambda g: g.to(torch.float32) * scale, tree), gn


def _is_moment(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "s"}


@torch.no_grad()
def adamw_update(grads: dict, state: AdamWState, rc: RunConfig,
                 params: dict) -> tuple[dict, AdamWState, dict]:
    """One AdamW step: ``(params, state, {"lr", "grad_norm"})``, ``state``
    and ``params`` (a tree of the grads' structure) updated in place."""
    step = state.step + 1
    stepf = step.to(torch.float32)
    lr = lr_schedule(rc, stepf)
    grads, gnorm = clip_by_global_norm(grads, rc.grad_clip)
    b1, b2, eps, wd = rc.beta1, rc.beta2, rc.eps, rc.weight_decay
    bc1 = 1.0 - b1 ** stepf
    bc2 = 1.0 - b2 ** stepf

    def upd(g, master, m, v):
        mf = _dq8(m["q"], m["s"]) if _is_moment(m) else m
        vf = _dq8_log(v["q"], v["s"]) if _is_moment(v) else v
        mf = b1 * mf + (1.0 - b1) * g
        vf = b2 * vf + (1.0 - b2) * g * g
        mhat = mf / bc1
        vhat = vf / bc2
        mw = master.to(torch.float32)
        # no weight decay on 1-D leaves (norms / biases)
        decay = wd if master.ndim >= 2 else 0.0
        master.copy_(mw - lr * (mhat / (torch.sqrt(vhat) + eps) + decay * mw))
        if _is_moment(m):
            m["q"], m["s"] = _q8(mf)
            v["q"], v["s"] = _q8_log(vf)
        else:
            m.copy_(mf)
            v.copy_(vf)
        return master

    tree_map(upd, grads, state.master, state.m, state.v)
    state.step.copy_(step)
    tree_map(lambda p, x: p.copy_(x), params, state.master)
    return params, state, {"lr": lr, "grad_norm": gnorm}
