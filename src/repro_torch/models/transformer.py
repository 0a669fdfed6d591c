"""Backbone over stacked layer groups: dense GQA (M-RoPE for qwen2-vl) and
MLA + MoE (llama4's dense/MoE alternation is one group of two-layer
super-blocks), the Mamba-1 SSM stack, the hybrid (Hymba) block and the
non-causal audio encoder (hubert: a 512-wide stub frontend projected to
d_model, the gelu MLP).

Layers are partitioned into groups exactly as the reference plans them
(``plan_groups``), and each group's parameters and caches are stacked along
a leading ``layers`` axis — the reference's tree layout, so weights carry
across by a plain tree map. Where the reference scans a group with
``lax.scan`` (and rematerializes blocks with ``jax.checkpoint``), the port
runs a Python loop over the stacked weights and updates the KV caches in
place; the SSM state comes back as new stacked leaves, as the reference
returns it. With grad on and no caches, ``rc.remat`` wraps each block in
``torch.utils.checkpoint``: ``full`` saves nothing inside it, ``block``
saves the linear layers' matmul outputs (selective checkpointing), and the
recompute records no path, dispatch or stats entry a second time.

Block layouts (pre-norm, residual):

- dense/MoE/encoder: ``x += attn(norm(x)); x += mlp|moe(norm(x))``
- ssm: ``x += mamba(norm(x))`` (no MLP)
- hybrid: ``x += 0.5·(rms(attn(norm(x))) + rms(mamba(norm(x)))); x += mlp(norm(x))``

The KV cache is the dense per-slot layout or the paged pool
(``rc.kv_layout``), with float or offline-packed
(``quant.surgery.apply_surgery``) linear weights.

Under a training mesh (``parallel/train_mesh.py``) the embedding is
vocab-parallel and each sub-block of a block (attention, the Mamba mixer,
the dense MLP) runs on the rank's heads, channels or columns between
``TrainProgram.block_in`` and ``block_out``, or whole on every rank where
tp does not divide its width; under sequence parallelism the residual
stream holds the rank's columns of the sequence.
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass

import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from .. import resolve_device
from ..configs.base import ModelConfig, RunConfig
from ..kernels import ops
from ..parallel.collectives import current_train
from ..parallel.sharding import at_layer, constrain
from ..quant.policy import QuantPolicy, effective_policy
from ..quant.qlinear import dense
from ..quant.surgery import _check_stack_consistency, gemm_name_targets
from .attention import KVView, gqa_attention, init_kv_cache, mla_attention
from .layers import embed_lookup, mlp, rms_norm
from .moe import moe_ffn
from .ssm import init_ssm_state, mamba_decode_step, mamba_mixer

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


def check_supported(cfg: ModelConfig, rc: RunConfig, *, caches: bool = False) -> None:
    """Raise for what the port does not run: the attention logit softcap
    with a KV cache (the reference drops it there; the port refuses, ROADMAP
    C13; the no-cache forward applies it), and an unknown KV layout."""
    if caches and cfg.attn_logit_softcap is not None:
        raise NotImplementedError(f"{cfg.name}: the attention logit softcap with a KV cache "
                                  "is refused (ROADMAP C13)")
    if rc.kv_layout not in ("dense", "paged"):
        raise ValueError(f"unknown kv_layout {rc.kv_layout!r}")


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
    """Stacked per-group cache trees on ``device`` (``cuda`` unless the
    caller passes ``"cpu"``).

    ``rc.kv_layout="dense"``: KV leaves (layers, batch, capacity, ...).
    ``rc.kv_layout="paged"``: KV leaves are page pools (layers,
    num_pages+1, block_size, ...) shared by all slots and indexed through
    block tables; the trailing page swallows masked writes. ``num_pages``
    defaults to the dense equivalent batch*ceil(capacity/block_size).
    SSM and hybrid blocks add their state per slot in either layout: ``h``
    (layers, batch, d_inner, ssm_state) and ``conv`` (layers, batch,
    ssm_conv-1, d_inner), both f32."""
    check_supported(cfg, rc, caches=True)
    device = resolve_device(device)
    kv_dtype = torch.int8 if rc.kv_cache_dtype == "int8" else torch_dtype(rc.dtype)
    if rc.kv_layout == "paged":
        bs = rc.block_size
        rows, width = (num_pages if num_pages is not None
                       else batch * (-(-capacity // bs))) + 1, bs
    else:
        rows, width = batch, capacity
    out = []
    for g in plan_groups(cfg):
        blocks = {}
        for j, kind in enumerate(g.kinds):
            one = {}
            if kind.mixer in ("gqa", "mla", "hybrid"):
                one.update(init_kv_cache(cfg, rows, width, kv_dtype, "meta"))
            if kind.mixer in ("ssm", "hybrid"):
                one.update(init_ssm_state(cfg, batch, "meta"))
            blocks[f"k{j}"] = {n: torch.zeros((g.repeats,) + tuple(t.shape), dtype=t.dtype,
                                              device=device) for n, t in one.items()}
        out.append(blocks)
    return tuple(out)


# -------------------------------------------------------------------- remat
# the reference's ``dots_with_no_batch_dims_saveable``: keep the outputs of
# the 2-D products (every linear layer: a (tokens, K) x (K, N) matmul
# lowers to ``mm`` / ``addmm``); attention's batched einsums (``bmm``) and
# everything elementwise are recomputed
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


@contextlib.contextmanager
def _quiet(ctx):
    """``ctx`` with the path, dispatch and stats records off: the recompute
    repeats calls the forward recorded."""
    with ctx, ops.quiet_records():
        yield


def _remat_contexts(remat: str):
    """torch.utils.checkpoint's (forward, recompute) contexts for ``remat``:
    ``full`` saves nothing inside the block, ``block`` saves the 2-D
    matmul outputs (selective checkpointing)."""
    if remat == "full":
        return contextlib.nullcontext(), _quiet(contextlib.nullcontext())
    fwd, rec = create_selective_checkpoint_contexts(_save_dots)
    return fwd, _quiet(_gemms_saved(rec))


@contextlib.contextmanager
def _gemms_saved(ctx):
    """``ctx`` with the GEMM kernels' outputs counted as saved: a dry-run's
    recompute (meta tensors) charges no GEMM kernel again, as ``mm`` /
    ``addmm`` are not run again (``roofline.kernel_cost.gemms_saved``)."""
    from ..roofline.kernel_cost import gemms_saved

    with ctx, gemms_saved():
        yield


def _block(rc: RunConfig, remat: bool, **kw):
    """One ``_apply_block``, rematerialized per ``rc.remat`` when ``remat``."""
    if not remat or rc.remat == "none":
        return _apply_block(**kw)
    if rc.remat not in ("block", "full"):
        raise ValueError(f"unknown remat {rc.remat!r}")
    return checkpoint(functools.partial(_apply_block, **kw), use_reentrant=False,
                      context_fn=functools.partial(_remat_contexts, rc.remat))


# ------------------------------------------------------------------ forward
def _select(tree, i: int):
    """Layer ``i`` of a stacked tree (views: in-place writes land in the
    stacked tensors); non-tensor leaves (a packed leaf's ``QBits``) are
    shared by every layer."""
    if isinstance(tree, dict):
        return {k: _select(v, i) for k, v in tree.items()}
    return tree[i] if isinstance(tree, torch.Tensor) else tree


class _SubBlocks:
    """A block's sub-blocks' inputs from one normed ``h`` and their outputs
    under a training mesh (``TrainProgram.block_in`` / ``block_out``: cut
    over tp, or whole on every rank; one gather of the sequence serves the
    hybrid's two branches); without one, ``h`` and the output as they
    are."""

    def __init__(self, tr, h: torch.Tensor):
        self.tr, self.h, self.ins = tr, h, {}

    def input(self, kind: str) -> torch.Tensor:
        if self.tr is None:
            return self.h
        cut = self.tr.cut(kind)
        key = "seq" if self.tr.sp else cut
        if key not in self.ins:
            self.ins[key] = self.tr.block_in(self.h, cut)
        return self.ins[key]

    def output(self, y: torch.Tensor, kind: str) -> torch.Tensor:
        return y if self.tr is None else self.tr.block_out(y, self.tr.cut(kind))


def _dense_mlp(cfg, p: dict, h2: torch.Tensor, tr, *, backend, impl: str) -> torch.Tensor:
    """The dense MLP sub-block; cut over tp, the row-parallel down
    projection's bias is added once, after the sum."""
    sub, bias = _SubBlocks(tr, h2), None
    if tr is not None and tr.cut("mlp") and "bias" in p["w_down"]:
        bias = p["w_down"]["bias"]
        p = {**p, "w_down": {k: v for k, v in p["w_down"].items() if k != "bias"}}
    y = sub.output(mlp(p, sub.input("mlp"), cfg.mlp_type, backend=backend, impl=impl), "mlp")
    return y if bias is None else y + bias.to(y.dtype)


def _apply_block(*, cfg, kind, p, x, positions, backend, cache, cache_pos, kv_view, chunk,
                 want_state, impl):
    """One block: returns (x, the block's new SSM state or None, its aux
    loss or None). An SSM step of one token with a state decodes from it;
    any longer step runs the full scan from a zero state, as the
    reference's does."""
    h = rms_norm(p["norm1"], x, cfg.rms_eps)
    # a training mesh (parallel/train_mesh.py): each sub-block runs on this
    # rank's heads / channels / columns, or whole, between block_in and block_out
    tr = current_train()
    sub = _SubBlocks(tr, h)
    state = None
    if kind.mixer in ("gqa", "mla", "hybrid"):
        attn = mla_attention if kind.mixer == "mla" else gqa_attention
        kv_cache = None
        if cache is not None and ("k" in cache or "ckv" in cache):
            kv_cache = {n: t for n, t in cache.items() if n not in ("h", "conv")}
        y = y_attn = sub.output(
            attn(cfg, p["attn"], sub.input("attn"), positions, backend=backend, cache=kv_cache,
                 cache_pos=cache_pos, kv_view=kv_view, is_global=kind.is_global, chunk=chunk,
                 impl=impl), "attn")
    if kind.mixer in ("ssm", "hybrid"):
        if cache is not None and "h" in cache and x.shape[1] == 1:
            y_ssm, state = mamba_decode_step(cfg, p["ssm"], h,
                                             {"h": cache["h"], "conv": cache["conv"]},
                                             backend=backend, impl=impl)
        else:
            y_ssm, state = mamba_mixer(cfg, p["ssm"], sub.input("ssm"), backend=backend,
                                       impl=impl, return_state=want_state)
            y_ssm = sub.output(y_ssm, "ssm")
        y = y_ssm
    if kind.mixer == "hybrid":
        # both branches are whole here (a norm is not linear in a partial sum)
        y = 0.5 * (rms_norm(p["fuse_attn_norm"], y_attn, cfg.rms_eps)
                   + rms_norm(p["fuse_ssm_norm"], y_ssm, cfg.rms_eps))
    x = x + constrain(y, "batch", "seq", "act_embed")
    if kind.mixer == "ssm":
        return x, state, None
    h2 = rms_norm(p["norm2"], x, cfg.rms_eps)
    if kind.moe:
        y2, aux = moe_ffn(cfg, p["ffn"], h2, backend=backend, impl=impl)
        return x + constrain(y2, "batch", "seq", "act_embed"), state, aux
    y2 = _dense_mlp(cfg, p["ffn"], h2, tr, backend=backend, impl=impl)
    return x + constrain(y2, "batch", "seq", "act_embed"), state, None


def forward(
    cfg: ModelConfig,
    rc: RunConfig,
    params: dict,
    batch: dict,
    *,
    caches=None,
    cache_pos: torch.Tensor | int | None = None,
    kv_view: KVView | None = None,
    impl: str = "auto",
):
    """Returns (hidden (B,S,D), caches, aux_loss).

    batch: {"tokens": (B,S) int} or, for an audio frontend, {"embeds": (B,S,512)}
    (projected to d_model by the biased ``frontend`` GEMM); optional
    "positions", (B,S) or (3,B,S) for M-RoPE, else each row's columns
    counted from its write offset. ``caches`` (from :func:`init_caches`, or
    None for the no-cache forward) have their KV leaves updated in place;
    the returned tree holds them and, for SSM and hybrid blocks, the new
    state as new stacked ``h`` / ``conv`` leaves. cache_pos: a Python int
    (every row writes there: the legacy lock step) or (B,) per-row write
    offsets; ``kv_view`` addresses the rows of a mixed step (with block
    tables: the paged pool; without: the dense layout). ``impl`` selects
    every kernel's path (``auto`` | ``torch`` | ``cuda``,
    ``kernels/ops.py``); a policy rule's own impl overrides it."""
    backend = step_backend(cfg, rc, params)
    dtype = torch_dtype(rc.dtype)
    tr = current_train()
    # the step's whole width (under sequence parallelism x holds this
    # rank's columns; positions stay global)
    B, S = (batch["tokens"] if "tokens" in batch else batch["embeds"]).shape[:2]
    if "tokens" in batch and tr is not None:
        x = tr.embed(params["embed"]["embedding"], batch["tokens"], dtype)
    elif "tokens" in batch:
        x = embed_lookup(params["embed"], batch["tokens"], dtype)
    else:
        embeds = batch["embeds"]
        if tr is not None and tr.sp:
            embeds = tr.seq_shard(embeds)
        x = dense(params["frontend_proj"], embeds.to(dtype), backend=backend, name="frontend",
                  impl=impl)
    if "positions" in batch:
        positions = batch["positions"]
    else:
        cols = torch.arange(S, device=x.device)[None, :]
        if isinstance(cache_pos, torch.Tensor):
            positions = cache_pos.long()[:, None] + cols
        else:
            positions = (cols + (cache_pos or 0)).expand(B, S)
    at_layer(None, step=tuple(x.shape[:2]))
    x = constrain(x, "batch", "seq", "act_embed")
    want_state = caches is not None
    # remat (rc.remat) only where a backward will run: grad on, no caches
    remat = torch.is_grad_enabled() and caches is None
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches = []
    for gi, g in enumerate(plan_groups(cfg)):
        gp = params["groups"][gi]
        gc = caches[gi] if caches is not None else None
        states = {f"k{j}": [] for j in range(len(g.kinds))}
        for i in range(g.repeats):
            p_i = _select(gp, i)
            c_i = _select(gc, i) if gc is not None else None
            at_layer((gi, i))
            x = constrain(x, "batch", "seq", "act_embed")
            for j, kind in enumerate(g.kinds):
                at_layer((gi, i, j))
                x, st, aux = _block(
                    rc, remat, cfg=cfg, kind=kind, p=p_i[f"k{j}"], x=x, positions=positions,
                    backend=backend, cache=c_i[f"k{j}"] if c_i is not None else None,
                    cache_pos=cache_pos, kv_view=kv_view, chunk=rc.attn_chunk,
                    want_state=want_state, impl=impl)
                if st is not None:
                    states[f"k{j}"].append(st)
                if aux is not None:
                    aux_total = aux_total + aux
        if gc is not None:
            new_caches.append({
                kj: {**gc[kj], **({n: torch.stack([st[n] for st in states[kj]])
                                   for n in ("h", "conv")} if states[kj] else {})}
                for kj in gc})
    at_layer(None)
    x = constrain(rms_norm(params["final_norm"], x, cfg.rms_eps), "batch", "seq", "act_embed")
    return x, (tuple(new_caches) if caches is not None else None), aux_total


def lm_logits(cfg: ModelConfig, rc: RunConfig, params: dict, h: torch.Tensor,
              *, impl: str = "auto") -> torch.Tensor:
    """(B, S, D) -> (B, S, V) in h.dtype. On a mesh the tied head runs at
    the single-device batch (``MeshProgram.at_full``), as the untied one
    does in ``qlinear``."""
    if cfg.tie_embeddings:
        from ..parallel.collectives import current_program

        emb = params["embed"]["embedding"].to(h.dtype).t()
        prog = current_program()
        if prog is None:
            logits = torch.matmul(h, emb)
        else:
            logits = prog.at_full("head.tied", torch.matmul, (h, {0: prog.dp}), (emb, {}))
    else:
        logits = dense(params["head"], h, backend=backend_from(rc), name="lm_head", impl=impl)
    return constrain(logits, "batch", None, "act_vocab")
