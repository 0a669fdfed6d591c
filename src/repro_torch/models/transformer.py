"""Decoder backbone over stacked layer groups: dense GQA and MLA + MoE.

Layers are partitioned into groups exactly as the reference plans them
(``plan_groups``), and each group's parameters and caches are stacked along
a leading ``layers`` axis — the reference's tree layout, so weights carry
across by a plain tree map. Where the reference scans a group with
``lax.scan`` (and rematerializes blocks with ``jax.checkpoint``), the port
runs a Python loop over the stacked weights and updates the cache pools in
place.

Block layout (pre-norm, residual): ``x += attn(norm(x)); x += mlp|moe(norm(x))``.
The port serves GQA and MLA attention with dense MLP or MoE FFNs on the
paged KV layout, with float or offline-packed
(``quant.surgery.apply_surgery``) linear weights.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from .. import resolve_device
from ..configs.base import ModelConfig, RunConfig
from ..quant.policy import QuantPolicy, effective_policy
from ..quant.surgery import _check_stack_consistency, gemm_name_targets
from ..quant.qlinear import refuse_unfused_experts
from .attention import KVView, gqa_attention, init_kv_cache, mla_attention
from .layers import embed_lookup, mlp, rms_norm
from .moe import moe_ffn

__all__ = [
    "LayerKind",
    "layer_kind",
    "plan_groups",
    "forward",
    "lm_logits",
    "step_backend",
    "init_caches",
    "backend_from",
    "check_supported",
    "torch_dtype",
]


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16, "int8": torch.int8}[name]


# --------------------------------------------------------------- layer plan
@dataclass(frozen=True)
class LayerKind:
    mixer: str          # gqa | mla | ssm | hybrid
    moe: bool
    is_global: bool     # full attention (vs sliding window)


def layer_kind(cfg: ModelConfig, i: int) -> LayerKind:
    if cfg.family == "ssm":
        mixer = "ssm"
    elif cfg.family == "hybrid":
        mixer = "hybrid"
    else:
        mixer = cfg.attn_type
    return LayerKind(mixer=mixer, moe=cfg.is_moe_layer(i), is_global=cfg.is_global_attn(i))


@dataclass(frozen=True)
class Group:
    kinds: tuple[LayerKind, ...]   # super-block structure (usually length 1)
    repeats: int


def plan_groups(cfg: ModelConfig) -> tuple[Group, ...]:
    kinds = [layer_kind(cfg, i) for i in range(cfg.num_layers)]
    # periodic pattern (e.g. llama4 dense/MoE alternation)
    for p in (1, 2, 3, 4):
        if cfg.num_layers % p == 0 and all(
            kinds[i] == kinds[i % p] for i in range(cfg.num_layers)
        ):
            return (Group(tuple(kinds[:p]), cfg.num_layers // p),)
    # contiguous uniform segments
    groups: list[Group] = []
    i = 0
    while i < cfg.num_layers:
        j = i
        while j < cfg.num_layers and kinds[j] == kinds[i]:
            j += 1
        groups.append(Group((kinds[i],), j - i))
        i = j
    return tuple(groups)


_MOE_GEMMS = ("moe.gate", "moe.up", "moe.down")


def check_supported(cfg: ModelConfig, rc: RunConfig) -> None:
    """Raise for what the port does not serve yet: SSM and hybrid mixers,
    frontends and encoders, the dense KV layout, and an ``unfused`` rule on
    a quantized MoE expert GEMM."""
    moe = False
    for g in plan_groups(cfg):
        for kind in g.kinds:
            if kind.mixer not in ("gqa", "mla"):
                raise NotImplementedError(
                    f"{cfg.name}: {kind.mixer} layers are not ported yet (the port serves "
                    "GQA and MLA attention with dense or MoE FFNs)")
            moe = moe or kind.moe
    if cfg.frontend is not None or cfg.is_encoder:
        raise NotImplementedError(f"{cfg.name}: frontends/encoders are not ported yet")
    if rc.kv_layout != "paged":
        raise NotImplementedError("dense KV layout is not ported yet; use kv_layout='paged'")
    if moe:
        resolved = effective_policy(rc).resolved()
        for name in _MOE_GEMMS:
            refuse_unfused_experts(resolved.for_gemm(name), f"{cfg.name}: {name}")


# ------------------------------------------------------------ policy check
@functools.lru_cache(maxsize=64)
def _validate_policy(policy: QuantPolicy, targets: tuple, packed: frozenset) -> None:
    """Reject typo'd or shadowed rules, and path-level rules that make one
    stacked layer diverge from its runtime name where the params do not
    carry the divergence (only packed prequant leaves can: their ``qbits``
    decide their width). ``targets``/``packed`` come from
    ``quant.surgery.gemm_name_targets`` on the live params."""
    if not policy.rules:
        return
    policy.validate(targets)
    _check_stack_consistency(policy, targets, packed=set(packed))


def step_backend(cfg: ModelConfig, rc: RunConfig, params: dict):
    """Resolve and check the RunConfig's policy against the live params:
    the per-GEMM table a forward runs with. Raises ``NotImplementedError``
    for what the port does not serve and ``ValueError`` (``PolicyError``)
    for a policy that does not resolve on these params."""
    check_supported(cfg, rc)
    policy = effective_policy(rc)
    packed: set = set()
    targets = gemm_name_targets(cfg, params, packed=packed)
    _validate_policy(policy, tuple(targets), frozenset(packed))
    return policy.resolved()


def backend_from(rc: RunConfig):
    """The RunConfig's QuantPolicy as a memoized per-GEMM resolution table."""
    return effective_policy(rc).resolved()


# -------------------------------------------------------------------- cache
def init_caches(cfg: ModelConfig, rc: RunConfig, batch: int, capacity: int, *,
                num_pages: int | None = None, device=None):
    """Stacked per-group paged KV pools: leaves (layers, num_pages+1,
    block_size, ...) shared by all slots and indexed through block tables;
    the trailing page swallows masked writes. ``num_pages`` defaults to the
    dense equivalent batch*ceil(capacity/block_size). The pools live on
    ``device`` (``cuda`` unless the caller passes ``"cpu"``)."""
    check_supported(cfg, rc)
    device = resolve_device(device)
    kv_dtype = torch.int8 if rc.kv_cache_dtype == "int8" else torch_dtype(rc.dtype)
    bs = rc.block_size
    pages = num_pages if num_pages is not None else batch * (-(-capacity // bs))
    out = []
    for g in plan_groups(cfg):
        blocks = {}
        for j in range(len(g.kinds)):
            one = init_kv_cache(cfg, pages + 1, bs, kv_dtype, device)
            blocks[f"k{j}"] = {
                n: t.unsqueeze(0).repeat((g.repeats,) + (1,) * t.ndim) for n, t in one.items()
            }
        out.append(blocks)
    return tuple(out)


# ------------------------------------------------------------------ forward
def _select(tree, i: int):
    """Layer ``i`` of a stacked tree (views: in-place writes land in the
    stacked tensors); non-tensor leaves (a packed leaf's ``QBits``) are
    shared by every layer."""
    if isinstance(tree, dict):
        return {k: _select(v, i) for k, v in tree.items()}
    return tree[i] if isinstance(tree, torch.Tensor) else tree


def _apply_block(cfg, kind, p, x, positions, *, backend, cache, kv_view, impl):
    """One block: returns (x, the block's aux loss)."""
    h = rms_norm(p["norm1"], x, cfg.rms_eps)
    attn = mla_attention if kind.mixer == "mla" else gqa_attention
    x = x + attn(cfg, p["attn"], h, positions, backend=backend, cache=cache,
                 kv_view=kv_view, is_global=kind.is_global, impl=impl)
    h2 = rms_norm(p["norm2"], x, cfg.rms_eps)
    if kind.moe:
        y2, aux = moe_ffn(cfg, p["ffn"], h2, backend=backend, impl=impl)
        return x + y2, aux
    return x + mlp(p["ffn"], h2, cfg.mlp_type, backend=backend, impl=impl), None


def forward(
    cfg: ModelConfig,
    rc: RunConfig,
    params: dict,
    batch: dict,
    *,
    caches,
    cache_pos: torch.Tensor,
    kv_view: KVView,
    impl: str = "auto",
):
    """Returns (hidden (B,S,D), caches, aux_loss). ``caches`` (the stacked
    paged pools of :func:`init_caches`) are updated in place and returned.

    batch: {"tokens": (B,S) int}. cache_pos: (B,) per-row write offsets.
    ``impl`` selects every kernel's path (``auto`` | ``torch`` | ``cuda``,
    ``kernels/ops.py``); a policy rule's own impl overrides it."""
    backend = step_backend(cfg, rc, params)
    x = embed_lookup(params["embed"], batch["tokens"], torch_dtype(rc.dtype))
    B, S = x.shape[:2]
    positions = cache_pos.long()[:, None] + torch.arange(S, device=x.device)[None, :]
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for gi, g in enumerate(plan_groups(cfg)):
        gp, gc = params["groups"][gi], caches[gi]
        for i in range(g.repeats):
            p_i, c_i = _select(gp, i), _select(gc, i)
            for j, kind in enumerate(g.kinds):
                x, aux = _apply_block(cfg, kind, p_i[f"k{j}"], x, positions, backend=backend,
                                      cache=c_i[f"k{j}"], kv_view=kv_view, impl=impl)
                if aux is not None:
                    aux_total = aux_total + aux
    x = rms_norm(params["final_norm"], x, cfg.rms_eps)
    return x, caches, aux_total


def lm_logits(cfg: ModelConfig, rc: RunConfig, params: dict, h: torch.Tensor,
              *, impl: str = "auto") -> torch.Tensor:
    """(B, S, D) -> (B, S, V) in h.dtype."""
    if cfg.tie_embeddings:
        return torch.matmul(h, params["embed"]["embedding"].to(h.dtype).t())
    from ..quant.qlinear import dense

    return dense(params["head"], h, backend=backend_from(rc), name="lm_head", impl=impl)
