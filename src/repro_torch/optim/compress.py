"""int8 gradient compression with error feedback (the reference's
``repro/optim/compress.py``).

:func:`ef_compress` quantizes each gradient leaf to int8 (one per-tensor
scale) and carries the quantization residual into the next step, so the
accumulated error stays bounded by one step's (Karimireddy et al., 2019).
It wraps the optimizer when ``rc.grad_compression == "int8_ef"``.

:func:`compressed_psum`, the int8-on-the-wire all-reduce over the data
axis, is a collective: it comes with the dp×tp mesh (ROADMAP A8).
"""

from __future__ import annotations

import torch

from ..tree import tree_map

__all__ = ["init_ef_state", "ef_compress", "compressed_psum"]


def _q(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    s = x.abs().amax() / 127.0 + 1e-12
    return torch.round(x / s).to(torch.int8), s


def _dq(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * s


def init_ef_state(params) -> dict:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


@torch.no_grad()
def ef_compress(grads, ef_state):
    """(compressed-then-decompressed grads, new EF residuals)."""
    def one(g, e):
        t = g.to(torch.float32) + e
        d = _dq(*_q(t))
        return d, t - d

    pairs = tree_map(one, grads, ef_state)
    return (tree_map(lambda _, pr: pr[0], grads, pairs),
            tree_map(lambda _, pr: pr[1], grads, pairs))


def compressed_psum(grads, axis_name: str):
    raise NotImplementedError("compressed_psum is a collective over the data axis: it comes "
                              "with the dp x tp mesh (ROADMAP A8)")
