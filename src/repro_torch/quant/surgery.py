"""Model surgery: pack a float model's linear layers offline for its policy.

- :func:`plan_surgery` resolves every linear leaf of a param tree to the
  GEMM name its ``forward`` uses ("attn.q", "mlp.down", "lm_head") and to
  the backend the RunConfig's QuantPolicy gives it, validating the policy
  against the model's real GEMM names (a typo'd or shadowed rule raises).
- :func:`apply_surgery` replaces every leaf whose rule says
  ``mode="prequant"`` with ``{"qkernel", "qscale", "qbits"}``: the weight
  quantized per out-channel and plane-packed at *that leaf's* bitwidth
  (``kernels.ops.pack_weights`` layout), stacked along the layer axis like
  the float kernel (``qkernel (L, Kp, N)``, ``qscale (L, N)``), with a
  :class:`~repro_torch.quant.qlinear.QBits` marker pinning the width.
  Dynamic-mode leaves stay float: the fused kernel quantizes on load.
- :func:`validate_runtime_policy` gives the runtime entry points the same
  policy checks on live (possibly surgered) params.
- :func:`draft_quant_view` builds the speculative draft's RunConfig and
  weight view (``serve/spec.py``), and :func:`forward_with_stats` runs a
  forward inside a stats capture.

It covers every linear leaf the reference's does: GQA and MLA attention,
dense MLPs (SwiGLU, and the biased gelu MLP's ``up`` / ``down``), MoE
expert stacks (raw ``(L, E, K, N)`` kernels, packed to ``(L, E, Kp, N)``
leaves) and their shared experts, the SSM projections, the audio
frontend's ``frontend_proj`` and an untied head. MLA's 3-D ``w_uk`` /
``w_uv`` factors and the MoE router stay outside the tuGEMM hardware
boundary and are never rewritten.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..configs.base import ModelConfig, RunConfig
from ..kernels import ops
from .policy import PolicyError, QuantPolicy, effective_policy
from .qlinear import QBits
from .quantize import compute_scale, quantize

__all__ = [
    "SurgeryEntry",
    "SurgeryPlan",
    "plan_surgery",
    "apply_surgery",
    "gemm_name_targets",
    "validate_runtime_policy",
    "draft_quant_view",
    "forward_with_stats",
]

# param-tree key -> runtime GEMM name, per enclosing module; every other
# key (norms, embeddings) is outside the tuGEMM hardware boundary
_ATTN = {"wq": "q", "wk": "k", "wv": "v", "wo": "o", "w_dkv": "dkv"}
_SSM = {"in_proj": "ssm.in_proj", "x_proj": "ssm.x_proj",
        "dt_w": "ssm.dt", "out_proj": "ssm.out_proj"}
_MLP = {"w_gate": "gate", "w_up": "up", "w_down": "down"}
_TOP = {"head": "lm_head", "frontend_proj": "frontend"}


def _gemm_name(cfg: ModelConfig, path: tuple) -> str | None:
    """Runtime GEMM name of the linear leaf at ``path`` (None = not one)."""
    key = path[-1]
    if key in _TOP and len(path) == 1:
        return _TOP[key]
    if "attn" in path and key in _ATTN:
        prefix = "mla" if cfg.attn_type == "mla" else "attn"
        return f"{prefix}.{_ATTN[key]}"
    if "ssm" in path and key in _SSM:
        return _SSM[key]
    if "ffn" in path and key in _MLP:
        if "experts" in path:
            return f"moe.{_MLP[key]}"
        if "shared" in path:
            return f"moe.shared.{_MLP[key]}"
        return f"mlp.{_MLP[key]}"
    return None


@dataclass(frozen=True)
class SurgeryEntry:
    path: tuple          # keys into the param tree (ints for group tuples)
    gemm_name: str       # runtime qlinear name
    selected: bool       # resolved to a quant backend by the policy
    shape: tuple         # kernel shape incl. the leading layer axis
    bits: int = 16       # resolved bitwidth for this leaf (16 = bf16)
    mode: str = "dynamic"  # resolved mode (dynamic | prequant)


@dataclass(frozen=True)
class SurgeryPlan:
    policy: QuantPolicy
    entries: tuple[SurgeryEntry, ...]

    @property
    def selected(self) -> tuple[SurgeryEntry, ...]:
        return tuple(e for e in self.entries if e.selected)

    @property
    def bits_used(self) -> tuple[int, ...]:
        """Distinct quant bitwidths actually assigned (sorted desc)."""
        return tuple(sorted({e.bits for e in self.selected}, reverse=True))


def _dotted(path: tuple) -> str:
    return ".".join(str(k) for k in path)


def _check_stack_consistency(policy: QuantPolicy, targets, packed: set | None = None) -> None:
    """Layers stacked in one group share one runtime GEMM name, so a
    path-pattern rule that resolves one of them differently from its name
    can only take effect in ``prequant`` mode, where the packed leaf's own
    ``qbits`` overrides the name. A dynamic-mode divergence would run at
    the wrong precision and raises. ``packed`` is the set of dotted paths
    whose leaves carry a ``qkernel`` (live params); None means surgery
    itself is about to pack them. A prequant divergence on a leaf that is
    not packed raises too."""
    for name, path in targets:
        run = policy.resolve(name)
        surg = policy.resolve(name, path)
        if surg == run:
            continue
        if surg.kind != "bf16" and surg.mode == "prequant":
            if packed is None or path in packed:
                continue  # leaf-level override via packed qbits
            raise PolicyError(
                f"policy resolves {name!r} to {surg.kind}:prequant via param path "
                f"{path!r} but the leaf is not packed (no qkernel): run "
                f"quant.surgery.apply_surgery on the params first — on float params "
                f"the layer would run at the name-level resolution ({run.kind})"
            )
        raise PolicyError(
            f"policy resolves {name!r} to {run.kind} by name but {surg.kind}:{surg.mode} "
            f"via param path {path!r}: layers stacked in one group share a single "
            f"runtime GEMM name, so per-stack divergence needs mode=prequant "
            f"(per-leaf packed bits) or name-distinct patterns"
        )


def _walk(cfg: ModelConfig, node, path: tuple, visit):
    """Visit every qlinear-executed linear (``{'kernel'}`` leaf-dicts, their
    surgered ``{'qkernel'}`` form, and raw MoE expert kernel stacks, which
    visit as ``{'kernel': stack}``). ``visit(path, leaf, name)`` returns a
    replacement for the entry or None to keep it."""
    if isinstance(node, dict):
        if "qkernel" in node or ("kernel" in node and getattr(node["kernel"], "ndim", 0) >= 2):
            name = _gemm_name(cfg, path)
            if name is None:
                return node
            rep = visit(path, node, name)
            return node if rep is None else rep
        out = {}
        for k, v in node.items():
            if path and path[-1] == "experts" and k in _MLP and getattr(v, "ndim", 0) >= 2:
                # raw expert kernel stack (L, E, K, N)
                rep = visit(path + (k,), {"kernel": v}, _gemm_name(cfg, path + (k,)))
                out[k] = v if rep is None else rep
            else:
                out[k] = _walk(cfg, v, path + (k,), visit)
        return out
    if isinstance(node, (tuple, list)):
        return type(node)(_walk(cfg, v, path + (i,), visit) for i, v in enumerate(node))
    return node


def gemm_name_targets(cfg: ModelConfig, params, *, packed: set | None = None
                      ) -> list[tuple[str, str]]:
    """Every qlinear-executed GEMM of a param tree as (runtime name, dotted
    path), float or surgered. With a ``packed`` set, also collect the
    dotted paths whose leaves carry a packed ``qkernel``."""
    out: list[tuple[str, str]] = []

    def visit(path, leaf, name):
        d = _dotted(path)
        out.append((name, d))
        if packed is not None and "qkernel" in leaf:
            packed.add(d)
        return None

    _walk(cfg, params, (), visit)
    return out


def validate_runtime_policy(cfg: ModelConfig, policy: QuantPolicy, params: dict) -> None:
    """Policy checks for the runtime entry points on live params: a typo'd
    or shadowed rule raises PolicyError, and so does a stacked-layer
    divergence that the params' packed leaves do not carry."""
    if not policy.rules:
        return
    packed: set = set()
    targets = gemm_name_targets(cfg, params, packed=packed)
    policy.validate(targets)
    _check_stack_consistency(policy, targets, packed=packed)


def plan_surgery(cfg: ModelConfig, rc: RunConfig, params: dict) -> SurgeryPlan:
    """Every linear leaf, its runtime GEMM name and the backend the
    RunConfig's QuantPolicy resolves it to; validates the policy."""
    policy = effective_policy(rc)
    entries: list[SurgeryEntry] = []

    def visit(path, leaf, name):
        be = policy.resolve(name, _dotted(path))
        kern = leaf["kernel"] if "kernel" in leaf else leaf["qkernel"]
        entries.append(SurgeryEntry(tuple(path), name, be.kind != "bf16", tuple(kern.shape),
                                    bits=be.bits, mode=be.mode))
        return None

    _walk(cfg, params, (), visit)
    targets = [(e.gemm_name, _dotted(e.path)) for e in entries]
    if policy.rules:
        policy.validate(targets)
    _check_stack_consistency(policy, targets)
    return SurgeryPlan(policy=policy, entries=tuple(entries))


def _prequant_leaf(w: torch.Tensor, bits: int) -> dict:
    """Offline PTQ of one kernel, for each slice along its leading stack
    axes: (..., K, N) float -> {'qkernel': (..., Kp, N) packed int8,
    'qscale': (..., N) f32}."""

    def one(wi):
        sw = compute_scale(wi, bits, axis=1)
        wq = quantize(wi, sw.reshape(1, -1), bits)
        return ops.pack_weights(wq, bits), sw

    lead = tuple(w.shape[:-2])
    if not lead:
        qk, qs = one(w)
        return {"qkernel": qk, "qscale": qs}
    parts = [one(wi) for wi in w.reshape((-1,) + tuple(w.shape[-2:]))]
    qk = torch.stack([p[0] for p in parts])
    qs = torch.stack([p[1] for p in parts])
    return {"qkernel": qk.reshape(lead + tuple(qk.shape[1:])),
            "qscale": qs.reshape(lead + tuple(qs.shape[1:]))}


def apply_surgery(cfg: ModelConfig, rc: RunConfig, params: dict) -> dict:
    """Rewrite the param tree for the RunConfig's QuantPolicy: every leaf
    whose rule says ``mode="prequant"`` is quantized and plane-packed
    offline at its own bitwidth (biases ride along); dynamic and bf16 leaves
    are left as they are. Returns a new tree; the input is not modified."""
    policy = effective_policy(rc)
    if not policy.is_quant:
        return params
    entries_seen: list[tuple[str, str]] = []

    def visit(path, leaf, name):
        entries_seen.append((name, _dotted(path)))
        be = policy.resolve(name, _dotted(path))
        if "qkernel" in leaf:
            # already packed: idempotent only at the same width
            qb = leaf.get("qbits")
            want = be.bits if (be.kind != "bf16" and be.mode == "prequant") else None
            if qb is not None and qb.bits != want:
                raise PolicyError(
                    f"param leaf {_dotted(path)} ({name!r}) is packed at {qb.bits} bits "
                    f"but the policy resolves it to {be.kind}:{be.mode}; re-run "
                    f"apply_surgery on the original float params")
            return None
        if be.kind == "bf16" or be.mode != "prequant":
            return None
        new = _prequant_leaf(leaf["kernel"], be.bits)
        new["qbits"] = QBits(be.bits)
        if "bias" in leaf:
            new["bias"] = leaf["bias"]
        return new

    out = _walk(cfg, params, (), visit)
    if policy.rules:
        policy.validate(entries_seen)
    _check_stack_consistency(policy, entries_seen)
    return out


def draft_quant_view(cfg: ModelConfig, rc: RunConfig, params: dict) -> tuple[RunConfig, dict]:
    """The speculative *draft* side of a RunConfig: ``(rc_draft, weight view)``.

    ``rc.draft_policy`` (QuantPolicy | grammar string | to_json dict;
    default ``"*=int2"``, the paper's cheapest Table-I point) becomes a
    standalone RunConfig: the target's dtypes, KV layout and chunking, so the
    draft's mixed step shares block tables with the target pool, with the
    draft policy as its only quantization knob (the legacy single-backend
    fields cleared, or effective_policy's both-set guard would trip).

    The weight view is the *same float tree* under a dynamic draft policy
    (the fused kernel quantizes on load at the draft width) and an
    offline-packed second tree under a prequant one. A base tree that
    target-policy surgery already packed is refused: packed leaves pin
    their own bitwidth (``qbits``), so the draft would silently run at the
    target's precision; build the draft view from the float params first."""
    draft = getattr(rc, "draft_policy", None)
    if draft is None:
        draft = "*=int2"
    rc_draft = dataclasses.replace(
        rc,
        quant_policy=draft,
        gemm_backend="bf16", gemm_mode="dynamic",
        collect_gemm_stats=False, quant_layers=(),
        spec_gamma=0, draft_policy=None,
    )
    policy = effective_policy(rc_draft)
    packed: set = set()
    gemm_name_targets(cfg, params, packed=packed)
    if packed:
        raise PolicyError(
            "draft_quant_view needs the original float params: leaves "
            f"{sorted(packed)[:3]}... are already prequant-packed and would pin the "
            "target bitwidth under the draft policy — build the draft view before "
            "running target-policy apply_surgery")
    view = apply_surgery(cfg, rc_draft, params) if policy.any_prequant else params
    return rc_draft, view


def forward_with_stats(cfg: ModelConfig, rc: RunConfig, params: dict, batch: dict, *,
                       caches, cache_pos, kv_view, impl: str = "auto"):
    """``models.forward`` inside a stats capture: returns ``(hidden,
    caches, aux_loss, capture)``, the capture holding every quantized GEMM's
    :class:`~repro_torch.quant.capture.CapturedGemm` in execution order
    (``capture.tree_totals_by_bits`` sums them per bitwidth). The reference
    returns its stats as a tree stacked along each group's layers axis; the
    port's forward runs eagerly, so its capture is a flat list."""
    from ..models import forward  # lazy: models imports this module
    from . import capture

    with capture.capture_stats() as cap:
        h, new_caches, aux = forward(cfg, rc, params, batch, caches=caches,
                                     cache_pos=cache_pos, kv_view=kv_view, impl=impl)
    return h, new_caches, aux, cap
