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
from ..tree import leaves, leaves_with_paths, tree_map

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


def _lin_codes(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """int8 codes of x at scale s (s broadcast against x)."""
    return torch.round(x / s).to(torch.int8)


def _log_codes(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """uint8 geometric codes of non-negative x at scale s: code c > 0
    stands for ``s * r^(255 - c)``, code 0 for zero."""
    ratio = torch.clamp(x / s, 1e-12, 1.0)
    c = 255.0 - torch.log(ratio) / _LOG_LN_R
    return torch.where(x <= s * 1e-8, 0.0, torch.clamp(torch.round(c), 1, 255)).to(torch.uint8)


def _lin_values(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * s


def _log_values(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    qf = q.to(torch.float32)
    return torch.where(qf == 0, 0.0, torch.exp((255.0 - qf) * _LOG_LN_R)) * s


def _q8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (..., K) -> (q int8 (..., K), scales f32 (..., nb))."""
    xb = _blocks(x)
    s = xb.abs().amax(-1) / 127.0 + 1e-12
    return _unblocks(_lin_codes(xb, s[..., None]), x.shape[-1]), s


def _dq8(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    K = q.shape[-1]
    qb = torch.nn.functional.pad(q, (0, s.shape[-1] * _BLOCK - K))
    return _unblocks(_lin_values(qb.reshape(*q.shape[:-1], s.shape[-1], _BLOCK), s[..., None]), K)


def _q8_log(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Non-negative x (..., K) -> (codes uint8, scales f32 (..., nb))."""
    xb = _blocks(x)
    s = xb.amax(-1) + 1e-30
    return _unblocks(_log_codes(xb, s[..., None]), x.shape[-1]), s


def _dq8_log(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    K = q.shape[-1]
    qp = torch.nn.functional.pad(q, (0, s.shape[-1] * _BLOCK - K))
    return _unblocks(_log_values(qp.reshape(*q.shape[:-1], s.shape[-1], _BLOCK), s[..., None]), K)


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


def clip_by_global_norm(tree, max_norm: float, gn: torch.Tensor | None = None):
    """``tree`` scaled to at most ``max_norm`` in global norm (``gn``, its
    norm where the caller has it: a sharded tree's is the mesh's)."""
    gn = global_norm(tree) if gn is None else gn
    scale = torch.clamp_max(max_norm / torch.clamp_min(gn, 1e-12), 1.0)
    return tree_map(lambda g: g.to(torch.float32) * scale, tree), gn


def _is_moment(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "s"}


class _Local:
    """The block quantizers of a whole (unsharded) leaf."""

    @staticmethod
    def q8(name: str, x: torch.Tensor, log: bool):
        return (_q8_log if log else _q8)(x)

    @staticmethod
    def dq8(name: str, q: torch.Tensor, s: torch.Tensor, log: bool):
        return (_dq8_log if log else _dq8)(q, s)


@torch.no_grad()
def adamw_update(grads: dict, state: AdamWState, rc: RunConfig,
                 params: dict, *, mesh=None) -> tuple[dict, AdamWState, dict]:
    """One AdamW step: ``(params, state, {"lr", "grad_norm"})``, ``state``
    and ``params`` (a tree of the grads' structure) updated in place.

    ``mesh``: a rank's parts of a sharded state (``parallel/train_mesh.py``)
    supply the global norm over every rank's parts (``global_norm(grads)``)
    and the int8 moments' block quantizers over the global leaf's blocks
    (``q8(name, x, log)`` / ``dq8(name, q, s, log)``, ``name`` the leaf's
    path in ``grads``); everything else is elementwise on the parts."""
    step = state.step + 1
    stepf = step.to(torch.float32)
    lr = lr_schedule(rc, stepf)
    quant = _Local if mesh is None else mesh
    grads, gnorm = clip_by_global_norm(grads, rc.grad_clip,
                                       None if mesh is None else mesh.global_norm(grads))
    b1, b2, eps, wd = rc.beta1, rc.beta2, rc.eps, rc.weight_decay
    bc1 = 1.0 - b1 ** stepf
    bc2 = 1.0 - b2 ** stepf
    names = iter([n for n, _ in leaves_with_paths(grads)])

    def upd(g, master, m, v):
        name = next(names)
        mf = quant.dq8(name, m["q"], m["s"], False) if _is_moment(m) else m
        vf = quant.dq8(name, v["q"], v["s"], True) if _is_moment(v) else v
        mf = b1 * mf + (1.0 - b1) * g
        vf = b2 * vf + (1.0 - b2) * g * g
        mhat = mf / bc1
        vhat = vf / bc2
        mw = master.to(torch.float32)
        # no weight decay on 1-D leaves (norms / biases)
        decay = wd if master.ndim >= 2 else 0.0
        master.copy_(mw - lr * (mhat / (torch.sqrt(vhat) + eps) + decay * mw))
        if _is_moment(m):
            m["q"], m["s"] = quant.q8(name, mf, False)
            v["q"], v["s"] = quant.q8(name, vf, True)
        else:
            m.copy_(mf)
            v.copy_(vf)
        return master

    tree_map(upd, grads, state.master, state.m, state.v)
    state.step.copy_(step)
    tree_map(lambda p, x: p.copy_(x), params, state.master)
    return params, state, {"lr": lr, "grad_norm": gnorm}
