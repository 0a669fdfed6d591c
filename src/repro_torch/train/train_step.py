"""train_step builder: loss -> grads -> (compression) -> AdamW, with
optional microbatched gradient accumulation (the reference's
``repro/train/train_step.py``).

Gradients come from autograd. Microbatching splits the step's batch k ways
along its batch axis (M-RoPE positions (3, B, S) along axis 1) and
accumulates f32 gradients, divided by k: the activation working set
shrinks k-fold. The step updates the state in place (the optimizer's
master weights and moments, the EF residuals and the parameters) and
returns it.
"""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig, RunConfig
from ..models import loss_fn
from ..optim import adamw_update, ef_compress, init_ef_state, init_opt_state
from ..tree import leaves, unflatten_like

__all__ = ["TrainState", "build_train_step", "init_train_state"]

# the state is a plain dict {"params", "opt" [, "ef"]}, so checkpointing
# stays tree-generic
TrainState = dict


def init_train_state(cfg: ModelConfig, rc: RunConfig, params: dict) -> dict:
    """``{"params", "opt" [, "ef"]}``; the parameters are set to require
    grad (leaf tensors the step updates in place)."""
    for p in leaves(params):
        p.requires_grad_(True)
    state = {"params": params, "opt": init_opt_state(params, rc)}
    if rc.grad_compression == "int8_ef":
        state["ef"] = init_ef_state(params)
    return state


def _split(x: torch.Tensor, k: int) -> list:
    """k microbatches of x along its batch axis (axis 1 for M-RoPE
    positions (3, B, S), as the reference's ``split`` decides)."""
    if x.ndim >= 2 and x.shape[0] == 3 and x.shape[1] % k == 0:
        return list(x.chunk(k, dim=1))
    return list(x.reshape(k, x.shape[0] // k, *x.shape[1:]).unbind(0))


def build_train_step(cfg: ModelConfig, rc: RunConfig):
    """Returns ``train_step(state, batch) -> (state, metrics)``; metrics
    are device scalars (``loss``, ``aux``, ``lr``, ``grad_norm``: the last
    microbatch's loss and aux, as the reference's scan carries them)."""

    def grads_of(params, batch):
        flat = leaves(params)
        total, metrics = loss_fn(cfg, rc, params, batch)
        grads = torch.autograd.grad(total, flat, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)], metrics

    def accumulate(params, batch):
        k = rc.microbatches
        if k <= 1:
            grads, metrics = grads_of(params, batch)
            return [g.to(torch.float32) for g in grads], metrics
        parts = {n: _split(x, k) for n, x in batch.items()}
        acc = None
        for i in range(k):
            g, metrics = grads_of(params, {n: v[i] for n, v in parts.items()})
            if acc is None:
                acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in g]
            for a, b in zip(acc, g):
                a.add_(b.to(torch.float32))
        return [a / k for a in acc], metrics

    def train_step(state: dict, batch: dict):
        params = state["params"]
        flat, metrics = accumulate(params, batch)
        grads = unflatten_like(params, flat)
        metrics = {n: v.detach() for n, v in metrics.items()}
        if rc.grad_compression == "int8_ef":
            grads, state["ef"] = ef_compress(grads, state["ef"])
        _, state["opt"], opt_metrics = adamw_update(grads, state["opt"], rc, params)
        return state, {**metrics, **opt_metrics}

    return train_step
