"""Mixture-of-Experts FFN: top-k router + capacity-bounded grouped dispatch.

The reference's ``repro/models/moe.py`` on one device. Tokens are grouped by
batch row; each group computes every (token, choice) pair's slot within its
expert by a cumsum, drops the pairs past ``capacity`` to a trash slot
(``E·cap``) and gathers its token rows into a local ``(E·cap, D)`` buffer
through the slot -> token inverse map (only that int map is scattered). In a
mixed serving step every row has the step's full width: a row's padding
columns and idle rows are routed and take capacity exactly as the
reference's do.

The three expert GEMMs run through ``quant.qlinear.dense`` on the expert
stacks: each is **one** launch over all experts, not a loop — the fused
kernel (``ops.matmul_fused``), or under an ``unfused`` rule the int8 or
packed GEMM (``ops.matmul_int8`` / ``ops.matmul_packed``), with a leading
expert axis; each expert has its own scales, a per-tensor activation scale
taken over its own ``cap`` rows, as the reference's ``vmap`` of ``dense``
takes it. Their stats carry a leading (E,) axis, pushed once per GEMM as
the reference re-pushes them after its ``vmap`` (the unfused prequant
route has none, as the reference's has none). The router is a bf16 ``dense`` named ``moe.router`` (outside the
hardware boundary); shared experts run as an always-on MLP named
``moe.shared.*``. The drop count rides the capture as ``moe.dropped_tokens``.

``routing()`` is a hook on the router's choices: within it every
``moe_ffn`` call records its top-k expert ids, or, given the ids another
run recorded, routes by them instead (teacher forcing: two numerically
different paths then dispatch the same tokens to the same experts).

Under a mesh program (the sharded serving step) the groups are the rank's
dp-local rows, and the expert stacks arrive tp-sharded on the experts axis
(detected by shape: a stack's leading dim ``E_local < E``): the dispatched
buffer is sliced to this rank's experts ``[t·E_local, (t+1)·E_local)``, and
the down-projection's outputs are all-gathered back to every expert at full
precision (the gate-weighted combine stays bit-exact). The drop count is
pushed per rank; the mesh merge counts it once per dp group. (The
reference's sequence-sharded dispatch groups belong to its training mesh.)

Under a training mesh (``parallel/train_mesh.py``) the router runs on the
replicated tokens; the dispatch enters the tensor-parallel region, the
rank's ``E/tp`` experts run on their slots, the others' stay zero, the
combine (its gates entering the region too) and the shared experts give
this rank's partial sum, which leaves the region summed over tp. The aux
loss's token fractions and mean probabilities are over the global batch.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..parallel.collectives import current_program, current_train
from ..parallel.sharding import constrain
from ..quant import capture as stats_capture
from ..quant.qlinear import GemmBackend, dense
from .layers import mlp

__all__ = ["moe_ffn", "moe_capacity", "router_probs", "routing"]

# the active routing() hook: (the ids recorded so far, the ids to route by | None)
_ROUTING: tuple[list, list | None] | None = None


def moe_capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    cap = int(cfg.capacity_factor * cfg.num_experts_per_tok * tokens_per_group / cfg.num_experts)
    return max(4, min(cap, tokens_per_group))


def router_probs(logits: torch.Tensor) -> torch.Tensor:
    """f32 softmax over the experts in the form XLA lowers
    ``jax.nn.softmax`` to: ``exp(x - max)`` divided by its sum."""
    lf = logits.to(torch.float32)
    e = torch.exp(lf - lf.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


@contextlib.contextmanager
def routing(forced: list | None = None):
    """Record the top-k expert ids (B, S, k) of every ``moe_ffn`` call in
    the block, in call order, into the list it yields. Given ``forced``
    (such a list from another run), call i routes by ``forced[i]`` instead
    of its own top-k: its gates are its own probabilities at those experts,
    renormalised, and the list records the ids it routed by."""
    global _ROUTING
    prev, _ROUTING = _ROUTING, ([], forced)
    try:
        yield _ROUTING[0]
    finally:
        _ROUTING = prev


def _route(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k (gate values, expert ids) of (B, S, E) probs, or the ids the
    active ``routing`` hook forces with the probs' values at them."""
    if _ROUTING is None:
        return torch.topk(probs, k, dim=-1)
    seen, forced = _ROUTING
    if forced is None:
        vals, idx = torch.topk(probs, k, dim=-1)
    else:
        idx = forced[len(seen)].to(probs.device)
        vals = torch.gather(probs, -1, idx)
    seen.append(idx)
    return vals, idx


def _dispatch_group(xg: torch.Tensor, idx: torch.Tensor, E: int, cap: int):
    """Every group's dispatch at once, gather-formulated (the reference
    vmaps its one-group function over the groups).

    xg: (G, gs, D) tokens; idx: (G, gs, k) expert ids. Returns (xin (G,
    E·cap, D), dest (G, gs·k)), ``dest == E·cap`` marking a dropped pair.
    Token-major order: pair j = token j // k, choice j % k. Only the int
    slot -> pair map is scattered; the token rows move by a gather."""
    G, gs, k = idx.shape
    D = xg.shape[-1]
    flat_e = idx.reshape(G, gs * k)
    onehot = F.one_hot(flat_e, E).to(torch.int32)                   # (G, gs*k, E)
    slot = (torch.cumsum(onehot, dim=1) * onehot).sum(-1) - 1       # slot within expert
    dest = torch.where(slot < cap, flat_e * cap + slot, E * cap)    # E*cap = trash slot
    inv = torch.full((G, E * cap + 1), gs * k, dtype=torch.int64, device=xg.device)
    pairs = torch.arange(gs * k, device=xg.device).expand(G, gs * k)
    inv.scatter_(1, dest, pairs)                                     # slot -> pair
    x_rep = torch.repeat_interleave(xg, k, dim=1)                    # (G, gs*k, D)
    xpad = torch.cat([x_rep, x_rep.new_zeros((G, 1, D))], 1)
    xin = torch.gather(xpad, 1, inv[:, : E * cap, None].expand(G, E * cap, D))
    return xin, dest                                                 # empty slot -> 0


def _expert_mm(w, xs: torch.Tensor, backend, name: str, impl: str) -> torch.Tensor:
    """The batched expert GEMM ``xs (E, G·cap, K) · w[e]``: a raw stacked
    kernel (E, K, N) or its surgered ``{"qkernel", "qscale", "qbits"}``
    leaf, in one launch of the pipeline its rule picks. Under an active
    capture the (E,)-leading stats are pushed with M = G·cap, empty slots
    included."""
    leaf = w if isinstance(w, dict) else {"kernel": w}
    return dense(leaf, xs, backend=backend, name=name, impl=impl)


def moe_ffn(cfg: ModelConfig, p: dict, x: torch.Tensor, *, backend,
            impl: str = "auto") -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (output (B, S, D), Switch aux load-balance loss)."""
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok

    logits = dense(p["router"], x, backend=GemmBackend("bf16"), name="moe.router", impl=impl)
    probs = router_probs(logits)                                    # (B, S, E)
    gate_vals, gate_idx = _route(probs, k)                          # (B, S, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # Switch aux loss: E * sum_e (token fraction)_e * (mean prob)_e
    tr = current_train()
    if tr is None:
        me = probs.mean((0, 1))
        ce = F.one_hot(gate_idx[..., 0], E).to(torch.float32).mean((0, 1))
        aux = E * torch.sum(me * ce)
    else:
        # a training mesh: both means are over the global batch, so the
        # counts and the token total are summed over the batch's ranks
        # first; this rank's share of the loss is its own rows' probability
        # sums against the global fractions (the shares sum to the loss)
        counts = torch.cat([F.one_hot(gate_idx[..., 0], E).to(torch.float32).sum((0, 1)),
                            probs.new_full((1,), float(B * S))])
        counts = tr.sum_dp(counts, "dp_all_reduce:moe_aux")
        n = counts[-1]
        aux = E * torch.sum(probs.sum((0, 1)) / n * (counts[:E] / n))
        x_tp = tr.enter(x)

    # one dispatch group per batch row
    cap = moe_capacity(cfg, S)
    xg = constrain(x if tr is None else x_tp, "batch", None, None)
    xin, dest = _dispatch_group(xg, gate_idx, E, cap)                         # (B, E*cap, D)
    if stats_capture.capturing():
        stats_capture.push_scalar("moe.dropped_tokens",
                                  (dest == E * cap).sum().to(torch.int32))

    # groups -> experts: (E, B*cap, D)
    xin = constrain(xin.reshape(B, E, cap, D).transpose(0, 1).reshape(E, B * cap, D),
                    "experts", "group_data", None)
    ex = p["experts"]
    # expert parallelism on a mesh: this rank's slice of the experts
    prog = current_program()
    wg = ex["w_gate"]
    E_w = (wg["qkernel"] if isinstance(wg, dict) else wg).shape[0]
    ep = prog is not None and E_w != E
    t_ep = prog.t if ep else tr.t if tr is not None and E_w != E else None
    if t_ep is not None:
        xin = xin[t_ep * E_w:(t_ep + 1) * E_w]
    g = _expert_mm(ex["w_gate"], xin, backend, "moe.gate", impl)
    u = _expert_mm(ex["w_up"], xin, backend, "moe.up", impl)
    h = (F.silu(g.to(torch.float32)) * u.to(torch.float32)).to(x.dtype)
    h = constrain(h, "experts", "group_data", None)
    yout = _expert_mm(ex["w_down"], h, backend, "moe.down", impl)   # (E, B*cap, D)
    if ep:
        yout = prog.gather_experts(yout, "moe.down")
    elif t_ep is not None:
        # training: the other experts' slots stay zero here; the combine
        # below is this rank's partial sum, added up over tp at the end
        z = yout.new_zeros
        yout = torch.cat([z((t_ep * E_w,) + yout.shape[1:]), yout,
                          z(((E // E_w - t_ep - 1) * E_w,) + yout.shape[1:])])
        gate_vals = tr.enter(gate_vals)

    # experts -> groups, then each group's gate-weighted combine
    yg = constrain(yout.reshape(E, B, cap, D).transpose(0, 1).reshape(B, E * cap, D),
                   "batch", None, None)
    ypad = torch.cat([yg, yg.new_zeros((B, 1, D))], dim=1)          # dropped -> 0
    got = torch.gather(ypad, 1, dest.long().unsqueeze(-1).expand(B, S * k, D))
    got = got.reshape(B, S, k, D) * gate_vals[..., None].to(yg.dtype)
    y = got.sum(2)
    if cfg.num_shared_experts:
        y = y + mlp(p["shared"], x if tr is None else x_tp, backend=backend, name="moe.shared",
                    impl=impl)
    if tr is not None:
        y = tr.exit(y)
    return y, aux
