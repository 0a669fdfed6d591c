"""Model entry points: parameter init at the reference's shapes and scales,
a forward's batch in the reference's input forms, the training loss
(``loss_fn``: chunked LM cross-entropy + 0.01 · the MoE aux loss) and the
parameter and FLOP counts (``count_params``, ``active_params``,
``model_flops``: 6·N·D with N the active parameters)."""

from __future__ import annotations

import contextlib
import math

import torch
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..configs.base import ModelConfig, RunConfig, ShapeConfig
from ..kernels import ops
from ..parallel.collectives import current_train
from .transformer import LayerKind, check_supported, forward, lm_logits, plan_groups, torch_dtype

# the audio frontend stub's frame width (the conv feature extractor's output)
FRONTEND_DIM = 512
# the loss's sequence chunk: logits exist for this many columns at a time
LOSS_CHUNK = 512

__all__ = ["init", "input_batch", "loss_fn", "count_params", "active_params", "model_flops",
           "param_axes", "abstract_params"]


# A leaf's spec: (shape, logical axes, init kind[, scale]); the axes are the
# reference's ParamSpec axes (``parallel/sharding.py`` maps them to a mesh)
def _linear(d_in: int, d_out: int, axes: tuple, scale: float = 0.02,
            bias: bool = False) -> dict:
    out = {"kernel": ((d_in, d_out), axes, "normal", scale)}
    if bias:
        out["bias"] = ((d_out,), (axes[1],), "zeros")
    return out


def _norm(dim: int) -> dict:
    return {"scale": ((dim,), (None,), "ones")}


def _mlp(d: int, ff: int, mlp_type: str = "swiglu") -> dict:
    """The reference's ``mlp_spec``: SwiGLU, or the non-gated gelu MLP with
    zero-initialised biases (hubert)."""
    if mlp_type == "gelu":
        return {"w_up": _linear(d, ff, ("embed", "mlp"), bias=True),
                "w_down": _linear(ff, d, ("mlp", "embed"), bias=True)}
    return {"w_gate": _linear(d, ff, ("embed", "mlp")), "w_up": _linear(d, ff, ("embed", "mlp")),
            "w_down": _linear(ff, d, ("mlp", "embed"))}


def _gqa_shapes(cfg: ModelConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    attn = {"wq": _linear(d, h * hd, ("embed", "heads")),
            "wk": _linear(d, kv * hd, ("embed", "kv_heads")),
            "wv": _linear(d, kv * hd, ("embed", "kv_heads")),
            "wo": _linear(h * hd, d, ("heads", "embed"))}
    if cfg.qk_norm:
        attn["q_norm"] = _norm(hd)
        attn["k_norm"] = _norm(hd)
    return attn


def _mla_shapes(cfg: ModelConfig) -> dict:
    """The reference's ``mla_spec``: w_uk / w_uv are 3-D einsum factors."""
    d, h = cfg.d_model, cfg.num_heads
    nope, rope_d = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    vd, lora = cfg.v_head_dim, cfg.kv_lora_rank
    return {
        "wq": _linear(d, h * (nope + rope_d), ("embed", "heads")),
        "w_dkv": _linear(d, lora + rope_d, ("embed", "kv_lora")),
        "kv_norm": _norm(lora),
        "w_uk": {"kernel": ((lora, h, nope), ("kv_lora", "heads", "qk_dim"), "normal", 0.02)},
        "w_uv": {"kernel": ((lora, h, vd), ("kv_lora", "heads", "qk_dim"), "normal", 0.02)},
        "wo": _linear(h * vd, d, ("heads", "embed")),
    }


def _moe_shapes(cfg: ModelConfig) -> dict:
    """The reference's ``moe_spec``: a router at std 0.02/sqrt(d), raw
    (E, K, N) expert stacks, and the shared experts as one wide MLP."""
    d, e, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff or cfg.d_ff
    spec = {
        "router": _linear(d, e, ("embed", None), scale=0.02 / d ** 0.5),
        "experts": {
            "w_gate": ((e, d, ff), ("experts", "embed", "mlp"), "normal", 0.02),
            "w_up": ((e, d, ff), ("experts", "embed", "mlp"), "normal", 0.02),
            "w_down": ((e, ff, d), ("experts", "mlp", "embed"), "normal", 0.02),
        },
    }
    if cfg.num_shared_experts:
        spec["shared"] = _mlp(d, ff * cfg.num_shared_experts)
    return spec


def _mamba_shapes(cfg: ModelConfig) -> dict:
    """The reference's ``mamba_spec``: the four projections, the depthwise
    conv (``zeros`` bias), ``dt_bias`` (inverse softplus of a log-uniform
    dt), ``A_log`` (``hippo``: log(n+1) along the state axis) and ``D``."""
    d, di, n, r, ck = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank, cfg.ssm_conv
    return {
        "in_proj": _linear(d, 2 * di, ("embed", "inner")),
        "conv_w": ((ck, di), ("conv", "inner"), "normal", 0.1),
        "conv_b": ((di,), ("inner",), "zeros"),
        "x_proj": _linear(di, r + 2 * n, ("inner", "dt")),
        "dt_w": _linear(r, di, ("dt", "inner")),
        "dt_bias": ((di,), ("inner",), "dt_bias"),
        "A_log": ((di, n), ("inner", "state"), "hippo"),
        "D": ((di,), ("inner",), "ones"),
        "out_proj": _linear(di, d, ("inner", "embed")),
    }


def _block_shapes(cfg: ModelConfig, kind: LayerKind) -> dict:
    """One block's parameter shapes and init — the reference's
    ``block_spec``: an SSM block is its norm and mixer alone; a hybrid block
    runs attention and the SSM side by side with a norm on each branch's
    output."""
    d = cfg.d_model
    if kind.mixer == "ssm":
        return {"norm1": _norm(d), "ssm": _mamba_shapes(cfg)}
    spec = {"norm1": _norm(d),
            "attn": _mla_shapes(cfg) if kind.mixer == "mla" else _gqa_shapes(cfg)}
    if kind.mixer == "hybrid":
        spec.update(ssm=_mamba_shapes(cfg), fuse_attn_norm=_norm(d), fuse_ssm_norm=_norm(d))
    spec.update(norm2=_norm(d),
                ffn=_moe_shapes(cfg) if kind.moe else _mlp(d, cfg.d_ff, cfg.mlp_type))
    return spec


def _special(how: str, shape: tuple, gen, device) -> torch.Tensor:
    """The reference's non-normal init kinds, in f32 on ``device``:
    ``zeros``; ``hippo`` (log(n+1) along the last axis); ``dt_bias``
    (dt log-uniform in [1e-3, 1e-1], then its inverse softplus: the only
    one of the three that draws from ``gen``)."""
    if how == "zeros":
        return torch.zeros(shape, dtype=torch.float32, device=device)
    if how == "hippo":
        row = torch.log(torch.arange(1, shape[-1] + 1, dtype=torch.float32, device=device))
        return row.expand(shape).clone()
    if how == "dt_bias":
        u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
        lo, hi = math.log(1e-3), math.log(0.1)
        dt = torch.exp(u * (hi - lo) + lo)
        return dt + torch.log(-torch.expm1(-dt))
    raise ValueError(f"unknown init kind {how!r}")


def _stack(spec, repeats: int):
    """A block's spec tree stacked ``repeats`` deep: a leading ``layers``
    axis of that size on every leaf (the reference's ``_stack_spec``)."""
    if isinstance(spec, dict):
        return {k: _stack(v, repeats) for k, v in spec.items()}
    shape, axes, *rest = spec
    return ((repeats,) + tuple(shape), ("layers",) + tuple(axes), *rest)


def _spec_tree(cfg: ModelConfig) -> dict:
    """Every leaf's spec in ``init``'s layout and draw order (the
    reference's ``model_spec``): ``embed`` or ``frontend_proj``, the stacked
    ``groups``, ``final_norm`` [, ``head``]."""
    d = cfg.d_model
    if cfg.frontend == "audio":
        tree = {"frontend_proj": _linear(FRONTEND_DIM, d, (None, "embed"), bias=True)}
    else:
        tree = {"embed": {"embedding": ((cfg.vocab_size, d), ("vocab", "embed"), "normal", 0.02)}}
    tree["groups"] = tuple({f"k{j}": _stack(_block_shapes(cfg, kind), g.repeats)
                            for j, kind in enumerate(g.kinds)} for g in plan_groups(cfg))
    tree["final_norm"] = _norm(d)
    if not cfg.tie_embeddings:
        tree["head"] = _linear(d, cfg.vocab_size, ("embed", "vocab"))
    return tree


def _spec_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _spec_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and tree and isinstance(tree[0], dict):
        return tuple(_spec_map(fn, v) for v in tree)
    return fn(tree)


def param_axes(cfg: ModelConfig) -> dict:
    """Every parameter leaf's logical axes, in ``init``'s layout (the
    reference's ``tree_axes(model_spec(cfg))``)."""
    return _spec_map(lambda spec: tuple(spec[1]), _spec_tree(cfg))


def abstract_params(cfg: ModelConfig, rc: RunConfig) -> dict:
    """``init``'s tree as ``meta`` tensors: every leaf's shape and dtype,
    no storage."""
    dtype = torch_dtype(rc.param_dtype)
    return _spec_map(lambda spec: torch.empty(spec[0], dtype=dtype, device="meta"),
                     _spec_tree(cfg))


def _materialize(spec, gen, dtype, device, keep=None, path: tuple = ()):
    """Draw one tree of leaves, leaf by leaf. A CPU generator draws in f32
    and casts (these values are fixed: tests and the card's qwen3-0.6b
    weights depend on them); a generator on the card draws each leaf there
    in ``dtype``, so a 16 B-parameter model never passes through the host.
    The SSM leaves' ``zeros`` / ``hippo`` / ``dt_bias`` kinds are made in
    f32 on the generator's device and cast; only ``dt_bias`` draws, and
    only SSM blocks have these leaves, so the other archs' draws are as
    they were. ``keep(path, leaf)``, where given, cuts each drawn leaf
    before it is placed (a mesh rank's shard: ``parallel/serve_mesh.py``,
    ``parallel/train_mesh.py``)."""
    if isinstance(spec, dict):
        return {k: _materialize(v, gen, dtype, device, keep, path + (k,))
                for k, v in spec.items()}
    shape, _, how, *scale = spec
    shape = tuple(shape)
    if how in ("zeros", "hippo", "dt_bias"):
        t = _special(how, shape, gen, gen.device)
    elif gen.device.type == "cpu":
        if how == "ones":
            t = torch.ones(shape, dtype=torch.float32)
        else:
            t = torch.randn(shape, generator=gen, dtype=torch.float32) * scale[0]
    elif how == "ones":
        t = torch.ones(shape, dtype=dtype, device=gen.device)
    else:
        t = torch.randn(shape, generator=gen, dtype=dtype, device=gen.device).mul_(scale[0])
    if keep is not None:
        t = keep(path, t)
    return t.to(dtype=dtype, device=device)


def init(cfg: ModelConfig, rc: RunConfig, generator: torch.Generator | None = None,
         device=None, *, keep=None) -> dict:
    """Random parameters in the reference's tree layout (``embed``, or
    ``frontend_proj`` (512 -> d_model, biased) for an audio frontend;
    stacked ``groups``, ``final_norm`` [, ``head``]), drawn from
    ``generator`` (a fresh ``torch.Generator().manual_seed(0)`` when None)
    on its own device, leaf by leaf, and placed on ``device`` (default
    ``cuda``). ``keep(path, leaf)`` cuts each leaf as it is drawn (path:
    the leaf's keys as strings, e.g. ``("groups", "0", "k0", "attn",
    "wq", "kernel")``); the draws are the same with or without it."""
    check_supported(cfg, rc)
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    dtype = torch_dtype(rc.param_dtype)
    params = {}
    for key, spec in _spec_tree(cfg).items():
        if key == "groups":
            params[key] = tuple({kj: _materialize(b, gen, dtype, dev, keep, (key, str(gi), kj))
                                 for kj, b in grp.items()} for gi, grp in enumerate(spec))
        else:
            params[key] = _materialize(spec, gen, dtype, dev, keep, (key,))
    return params


def input_batch(cfg: ModelConfig, inputs: torch.Tensor, pos=0) -> dict:
    """A forward's batch in the reference's forms (its ``input_specs``):
    ``{"embeds": inputs}`` for an audio frontend (inputs (B, S, 512)
    frames), else ``{"tokens": inputs}`` (B, S); with M-RoPE also
    ``"positions"`` (3, B, S): a text stream's t = h = w = ``pos`` plus the
    column, ``pos`` an int or per-row (B,) offsets."""
    if cfg.frontend == "audio":
        return {"embeds": inputs}
    batch = {"tokens": inputs}
    if cfg.mrope_sections is not None:
        B, S = inputs.shape[:2]
        cols = torch.arange(S, device=inputs.device)[None, :]
        p = (pos.long()[:, None] + cols if isinstance(pos, torch.Tensor)
             else (cols + pos).expand(B, S))
        batch["positions"] = torch.stack([p, p, p])
    return batch


# --------------------------------------------------------------------- loss
def _xent_chunk(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor):
    """Token cross-entropy over one chunk, reduced in f32: (sum of masked
    NLL, sum of the mask). logits (B, C, V)."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    nll = (lse - gold) * mask
    return nll.sum(), mask.sum()


def _chunk_nll(cfg, rc, params, h, labels, mask):
    tr = current_train()
    logits = lm_logits(cfg, rc, params, h)
    if tr is not None and tr.tp > 1:
        return tr.xent(logits, labels, mask)
    return _xent_chunk(logits, labels, mask)


def _quiet_recompute():
    """A loss chunk's checkpoint contexts: the backward's recompute of a
    quantized head records no path, dispatch or stats entry a second time."""
    return contextlib.nullcontext(), ops.quiet_records()


def loss_fn(cfg: ModelConfig, rc: RunConfig, params: dict, batch: dict):
    """Mean token loss + 0.01 · aux, and {"loss", "aux"}: the reference's
    ``loss_fn``. The logits are computed ``LOSS_CHUNK`` columns at a time
    when the sequence splits into more than one whole chunk (the
    reference's scan branch; each chunk is checkpointed, so its logits are
    recomputed in the backward and one chunk's (B, 512, V) logits exist at
    a time in either direction), else in one piece. ``batch`` holds the
    forward's inputs, ``labels`` (B, S) and optionally ``loss_mask``.
    Under a training mesh the head and the cross-entropy are
    vocab-parallel, and the mean is over the global batch."""
    h, _, aux = forward(cfg, rc, params, batch)
    tr = current_train()
    if tr is not None:
        h = tr.enter(h)         # the head is vocab-parallel on a training mesh
    labels = batch["labels"]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32, device=h.device)
    S = h.shape[1]
    chunk = min(LOSS_CHUNK, S)
    n_chunks = max(1, S // chunk)
    if S % chunk == 0 and n_chunks > 1:
        nll = torch.zeros((), dtype=torch.float32, device=h.device)
        cnt = torch.zeros((), dtype=torch.float32, device=h.device)
        for c in range(n_chunks):
            cols = slice(c * chunk, (c + 1) * chunk)
            args = (cfg, rc, params, h[:, cols], labels[:, cols], mask[:, cols])
            n, m = (checkpoint(_chunk_nll, *args, use_reentrant=False,
                               context_fn=_quiet_recompute)
                    if torch.is_grad_enabled() else _chunk_nll(*args))
            nll, cnt = nll + n, cnt + m
    else:
        nll, cnt = _chunk_nll(cfg, rc, params, h, labels, mask)
    if tr is not None:
        # a training mesh: the mean over the global batch's tokens (this
        # rank's rows' NLL over the global count: the ranks' objectives sum
        # to the loss); the metrics are the global ones
        cnt = torch.clamp_min(tr.sum_dp(cnt, "dp_all_reduce:loss_count"), 1.0)
        sums = tr.sum_dp(torch.stack([nll.detach(), aux.detach()]), "dp_all_reduce:metrics")
        return nll / cnt + 0.01 * aux, {"loss": sums[0] / cnt, "aux": sums[1]}
    loss = nll / torch.clamp_min(cnt, 1.0)
    return loss + 0.01 * aux, {"loss": loss, "aux": aux}


# --------------------------------------------------------------- accounting
def count_params(cfg: ModelConfig) -> int:
    """Every parameter of ``init``'s tree, counted from the shapes alone."""
    n = 0

    def add(spec):
        nonlocal n
        n += math.prod(spec[0])

    _spec_map(add, _spec_tree(cfg))
    return n


def active_params(cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE: top-k routed + shared experts)."""
    total = count_params(cfg)
    if cfg.num_experts == 0:
        return total
    per_expert = 3 * cfg.d_model * (cfg.moe_d_ff or cfg.d_ff)
    n_moe_layers = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
    return total - n_moe_layers * (cfg.num_experts - cfg.num_experts_per_tok) * per_expert


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6·N·D for training (2·N·D otherwise) with N the active parameters and
    D the step's tokens (decode: one a sequence)."""
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    return (6.0 if shape.kind == "train" else 2.0) * active_params(cfg) * tokens
