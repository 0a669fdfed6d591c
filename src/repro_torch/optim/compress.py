"""int8 gradient compression with error feedback (the reference's
``repro/optim/compress.py``).

:func:`ef_compress` quantizes each gradient leaf to int8 (one per-tensor
scale) and carries the quantization residual into the next step, so the
accumulated error stays bounded by one step's (Karimireddy et al., 2019).
It wraps the optimizer when ``rc.grad_compression == "int8_ef"``.

:func:`compressed_psum` is the int8-on-the-wire all-reduce mean over a
``torch.distributed`` group: each rank quantizes its gradient leaf to int8
with one f32 scale, the group all-gathers the int8 payloads and the scales
(8 bits a value on the wire instead of 32), and every rank returns the mean
of the dequantized shards, as the reference's ``psum`` of ``q·s`` over
the axis divided by its size. As in the reference, the train step does not
call it: the sharded step reduces gradients in full precision and EF wraps
the optimizer (``parallel/train_mesh.py``).
"""

from __future__ import annotations

import torch

from ..tree import leaves, tree_map

__all__ = ["init_ef_state", "ef_compress", "compressed_psum"]


def _q(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    s = x.abs().amax() / 127.0 + 1e-12
    return torch.round(x / s).to(torch.int8), s


def _dq(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * s


def init_ef_state(params) -> dict:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


@torch.no_grad()
def ef_compress(grads, ef_state, *, amax=None):
    """(compressed-then-decompressed grads, new EF residuals). ``amax``
    (a sharded state's parts: ``parallel/train_mesh.py``) maps the list of
    every leaf's local absmax to the global ones, so each leaf's scale is
    its whole tensor's."""
    tops = [(g.to(torch.float32) + e).abs().amax()
            for g, e in zip(leaves(grads), leaves(ef_state))]
    top = iter(tops if amax is None else amax(tops))

    def one(g, e):
        t = g.to(torch.float32) + e
        s = next(top) / 127.0 + 1e-12       # _q's scale, of the whole leaf
        d = _dq(torch.round(t / s).to(torch.int8), s)
        return d, t - d

    pairs = tree_map(one, grads, ef_state)
    return (tree_map(lambda _, pr: pr[0], grads, pairs),
            tree_map(lambda _, pr: pr[1], grads, pairs))


@torch.no_grad()
def compressed_psum(grads, group=None, *, meter: dict | None = None):
    """The mean over ``group``'s ranks of each leaf's int8-dequantized
    shard: every rank all-gathers the int8 payloads and f32 scales and sums
    the dequantized shards in rank order. A CUDA leaf under gloo goes
    through host memory. ``meter`` (a dict) accumulates ``payload_bytes``
    (the int8 values this rank receives), ``scale_bytes`` and ``f32_bytes``
    (what an f32 all-gather of the same leaves would move)."""
    import torch.distributed as tdist

    n = tdist.get_world_size(group)
    host = tdist.get_backend(group) == "gloo"

    def one(g):
        q, s = _q(g.to(torch.float32))
        qh, sh = (q.cpu(), s.reshape(1).cpu()) if host else (q, s.reshape(1))
        qs = [torch.empty_like(qh) for _ in range(n)]
        ss = [torch.empty_like(sh) for _ in range(n)]
        tdist.all_gather(qs, qh, group=group)
        tdist.all_gather(ss, sh, group=group)
        if meter is not None:
            for k, v in (("payload_bytes", q.numel() * (n - 1)), ("scale_bytes", 4 * (n - 1)),
                         ("f32_bytes", 4 * q.numel() * (n - 1))):
                meter[k] = meter.get(k, 0) + v
        total = sum(_dq(a.to(g.device), b.to(g.device)[0]) for a, b in zip(qs, ss))
        return total / float(n)

    return tree_map(one, grads)
