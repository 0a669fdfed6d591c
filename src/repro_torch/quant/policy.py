"""Declarative per-layer mixed-precision policy (copy of
``repro/quant/policy.py``; the reference's ``to_json`` loads here).

An ordered list of :class:`LayerRule` entries (first-match-wins) plus a
default, resolved per GEMM *name* ("attn.q", "mlp.down", "lm_head", ...)
into a concrete :class:`~repro_torch.quant.qlinear.GemmBackend`. Rule
grammar (CLI / serving configs)::

    attn.*=int8,mlp.*=int2,*=bf16          # pattern=kind[:mode][:flags]
    attn.*=int8:per_token                  # per-row activation scales

The kernel impl flag takes the port's values (``auto``, ``torch``,
``cuda``; see ``kernels/ops.py``). ``prequant`` rules take effect once
``quant.surgery.apply_surgery`` has packed their leaves; ``unfused`` rules
select the legacy pipeline of separate passes (``quant/qlinear.py``).
"""

from __future__ import annotations

import json
import warnings
from dataclasses import dataclass, field
from fnmatch import fnmatchcase
from typing import Iterable

from .qlinear import BF16, GemmBackend

__all__ = [
    "KIND_BITS",
    "BITS_KIND",
    "PolicyError",
    "LayerRule",
    "QuantPolicy",
    "ResolvedPolicy",
    "effective_policy",
    "load_policy",
]

KIND_BITS = {"bf16": 16, "int8": 8, "int4": 4, "int2": 2}
BITS_KIND = {v: k for k, v in KIND_BITS.items()}
_MODES = ("dynamic", "prequant")
_FLAGS = ("unfused", "fused", "stats", "per_token")
_IMPLS = ("auto", "torch", "cuda")  # kernels/ops.resolve_path
_ACT_SCALES = ("tensor", "token")


class PolicyError(ValueError):
    """A QuantPolicy is malformed or cannot apply to the target model."""


def _coerce_bits(bits) -> int:
    """Accept 16/8/4/2 or "bf16"/"int8"/"int4"/"int2" (or "8"...)."""
    if isinstance(bits, str):
        if bits in KIND_BITS:
            return KIND_BITS[bits]
        if bits.isdigit() and int(bits) in BITS_KIND:
            return int(bits)
        raise PolicyError(f"unknown precision {bits!r}; use {sorted(KIND_BITS)}")
    if bits in BITS_KIND:
        return int(bits)
    raise PolicyError(f"unknown bitwidth {bits!r}; use {sorted(BITS_KIND)}")


@dataclass(frozen=True)
class LayerRule:
    """One policy entry: GEMMs whose name matches ``pattern`` (fnmatch) run
    at ``bits`` with the given mode/kernel knobs. ``bits`` accepts 16|8|4|2
    or a kind string ("bf16"|"int8"|"int4"|"int2")."""

    pattern: str
    bits: int = 16
    mode: str = "dynamic"        # dynamic | prequant (ignored at 16 bits)
    fused: bool = True           # one-pass pipeline (False = legacy unfused)
    impl: str = "auto"           # kernel dispatch (kernels/ops.py)
    collect_stats: bool = False  # emit tuGEMM cycle stats per GEMM
    # dynamic activation-scale granularity: "tensor" (batch-wide absmax) or
    # "token" (per-row — outputs independent of co-batched content; grammar
    # flag ``per_token``, see DESIGN.md §9)
    act_scale: str = "tensor"

    def __post_init__(self):
        object.__setattr__(self, "bits", _coerce_bits(self.bits))
        if self.mode not in _MODES:
            raise PolicyError(f"unknown mode {self.mode!r}; use {_MODES}")
        if self.act_scale not in _ACT_SCALES:
            raise PolicyError(
                f"unknown act_scale {self.act_scale!r}; use {_ACT_SCALES}"
            )

    @property
    def kind(self) -> str:
        return BITS_KIND[self.bits]

    @property
    def is_quant(self) -> bool:
        return self.bits < 16

    def matches(self, name: str, path: str | None = None) -> bool:
        """Does this rule claim the GEMM called ``name``? ``path`` (the
        dotted param-tree path) is consulted too at surgery time, matching
        the old ``quant_layers`` semantics."""
        return fnmatchcase(name, self.pattern) or (
            path is not None and fnmatchcase(path, self.pattern)
        )

    def backend(self) -> GemmBackend:
        """The resolved per-layer spec this rule lowers to."""
        if not self.is_quant:
            return BF16
        return GemmBackend(
            self.kind, self.mode, self.collect_stats, self.impl, self.fused,
            act_scale=self.act_scale,
        )

    def to_json(self) -> dict:
        return {
            "pattern": self.pattern, "bits": self.bits, "mode": self.mode,
            "fused": self.fused, "impl": self.impl,
            "collect_stats": self.collect_stats, "act_scale": self.act_scale,
        }

    @classmethod
    def from_json(cls, obj: dict) -> "LayerRule":
        return cls(**obj)


_DEFAULT_RULE = LayerRule("*", 16)


def _parse_spec(pattern: str, spec: str) -> LayerRule:
    """``kind[:mode][:flags]`` → LayerRule."""
    parts = [p.strip() for p in spec.split(":") if p.strip()]
    if not parts:
        raise PolicyError(f"empty spec for pattern {pattern!r}")
    kw: dict = {}
    for p in parts[1:]:
        if p in _MODES:
            kw["mode"] = p
        elif p == "unfused":
            kw["fused"] = False
        elif p == "fused":
            kw["fused"] = True
        elif p == "stats":
            kw["collect_stats"] = True
        elif p == "per_token":
            kw["act_scale"] = "token"
        elif p in _IMPLS:
            kw["impl"] = p
        else:
            raise PolicyError(
                f"unknown token {p!r} in spec {spec!r} for pattern "
                f"{pattern!r}; expected a mode {_MODES}, flag {_FLAGS}, or "
                f"kernel impl {_IMPLS}"
            )
    return LayerRule(pattern, _coerce_bits(parts[0]), **kw)


@dataclass(frozen=True)
class QuantPolicy:
    """Ordered first-match-wins rules + a default. Immutable and hashable —
    safe to hang off a frozen RunConfig and to key jit caches on."""

    rules: tuple[LayerRule, ...] = ()
    default: LayerRule = field(default_factory=lambda: _DEFAULT_RULE)

    def __post_init__(self):
        object.__setattr__(self, "rules", tuple(self.rules))

    # ------------------------------------------------------------ resolution
    def rule_for(self, name: str, path: str | None = None) -> tuple[LayerRule, int | None]:
        """First matching rule (and its index; None = the default)."""
        for i, r in enumerate(self.rules):
            if r.matches(name, path):
                return r, i
        return self.default, None

    def resolve(self, name: str, path: str | None = None) -> GemmBackend:
        """Per-GEMM resolved backend (uncached — :meth:`resolved` memoizes)."""
        return self.rule_for(name, path)[0].backend()

    @property
    def is_quant(self) -> bool:
        return self.default.is_quant or any(r.is_quant for r in self.rules)

    @property
    def any_prequant(self) -> bool:
        return any(r.is_quant and r.mode == "prequant" for r in (*self.rules, self.default))

    def bits_used(self) -> tuple[int, ...]:
        """Distinct quant bitwidths this policy can assign (sorted desc)."""
        return tuple(sorted({r.bits for r in (*self.rules, self.default) if r.is_quant},
                            reverse=True))

    def resolved(self) -> "ResolvedPolicy":
        """A lazily-memoizing resolution table (trace-time cache)."""
        return ResolvedPolicy(self)

    def compile(self, names: Iterable) -> "ResolvedPolicy":
        """Validate against the model's GEMM-name universe and build the
        full name -> backend table (the hot path then never pattern-matches).
        ``names``: strings or (name, dotted_path) pairs (surgery plans); the
        paths feed validation only, the table resolves by *name*, as the
        runtime does."""
        targets = [(t, None) if isinstance(t, str) else tuple(t) for t in names]
        self.validate(targets)
        return ResolvedPolicy(self, {n: self.resolve(n) for n, _ in targets})

    # ------------------------------------------------------------ validation
    def validate(self, names: Iterable) -> None:
        """Reject silent no-ops: every rule must be the *first* match of at
        least one GEMM in ``names`` — a rule that matches nothing is a typo,
        a rule only reachable behind an earlier rule is shadowed. Raises
        :class:`PolicyError` (the old ``quant_layers`` silently ignored
        both)."""
        targets = [(t, None) if isinstance(t, str) else tuple(t) for t in names]
        if not targets:
            raise PolicyError("cannot validate a policy against zero GEMMs")
        first_hits: set[int] = set()
        any_hits: set[int] = set()
        for n, p in targets:
            for i, r in enumerate(self.rules):
                if r.matches(n, p):
                    any_hits.add(i)
            fm = self.rule_for(n, p)[1]
            if fm is not None:
                first_hits.add(fm)
        for i, r in enumerate(self.rules):
            if i in first_hits:
                continue
            if i in any_hits:
                raise PolicyError(
                    f"rule {i} ({r.pattern!r}={r.kind}) is unreachable: every "
                    f"GEMM it matches is claimed by an earlier rule "
                    f"(first-match-wins)"
                )
            raise PolicyError(
                f"rule {i} ({r.pattern!r}={r.kind}) matches zero GEMMs; "
                f"known names: {sorted({n for n, _ in targets})}"
            )

    # --------------------------------------------------------- serialization
    def to_json(self) -> str:
        return json.dumps({
            "rules": [r.to_json() for r in self.rules],
            "default": self.default.to_json(),
        })

    @classmethod
    def from_json(cls, obj) -> "QuantPolicy":
        if isinstance(obj, (str, bytes)):
            obj = json.loads(obj)
        return cls(
            rules=tuple(LayerRule.from_json(r) for r in obj.get("rules", ())),
            default=LayerRule.from_json(obj["default"]) if "default" in obj
            else _DEFAULT_RULE,
        )

    @classmethod
    def parse(cls, text: str) -> "QuantPolicy":
        """CLI grammar: ``pattern=kind[:mode][:flags],...``. JSON text (from
        :meth:`to_json` / a policy file) is accepted too. A trailing
        ``*=<spec>`` entry becomes the default."""
        text = text.strip()
        if text.startswith("{"):
            return cls.from_json(text)
        rules: list[LayerRule] = []
        for entry in text.split(","):
            entry = entry.strip()
            if not entry:
                continue
            if "=" not in entry:
                raise PolicyError(
                    f"bad policy entry {entry!r}; expected pattern=kind[:mode]"
                )
            pat, spec = entry.split("=", 1)
            rules.append(_parse_spec(pat.strip(), spec))
        if not rules:
            raise PolicyError(f"empty policy {text!r}")
        default = _DEFAULT_RULE
        if rules and rules[-1].pattern == "*":
            default = rules.pop()
        return cls(rules=tuple(rules), default=default)

    @classmethod
    def uniform(cls, kind_or_bits, mode: str = "dynamic", **kw) -> "QuantPolicy":
        """Every GEMM at one precision (the old single-backend world)."""
        bits = _coerce_bits(kind_or_bits)
        if bits == 16:
            return cls()
        return cls(default=LayerRule("*", bits, mode, **kw))

    @classmethod
    def from_legacy(
        cls,
        kind: str,
        mode: str = "dynamic",
        collect_stats: bool = False,
        impl: str = "auto",
        fused: bool = True,
        layers: tuple[str, ...] = (),
    ) -> "QuantPolicy":
        """Lower the deprecated global-GemmBackend knobs into an equivalent
        policy: ``layers`` patterns become ordered rules over a bf16 default
        (empty = everything quantized), exactly the old gating semantics."""
        bits = _coerce_bits(kind)
        if bits == 16:
            return cls()
        kw = dict(mode=mode, collect_stats=collect_stats, impl=impl, fused=fused)
        if layers:
            return cls(rules=tuple(LayerRule(p, bits, **kw) for p in layers))
        return cls(default=LayerRule("*", bits, **kw))

    def describe(self) -> str:
        """Round-trippable grammar form: every non-default token of a quant
        rule is emitted, so ``parse(describe(p))`` resolves identically
        (flags on bf16 rules are inert and omitted)."""

        def spec(r: LayerRule) -> str:
            parts = [r.kind]
            if r.is_quant:
                if r.mode != "dynamic":
                    parts.append(r.mode)
                if not r.fused:
                    parts.append("unfused")
                if r.collect_stats:
                    parts.append("stats")
                if r.act_scale == "token":
                    parts.append("per_token")
                if r.impl != "auto":
                    parts.append(r.impl)
            return ":".join(parts)

        ents = [f"{r.pattern}={spec(r)}" for r in self.rules]
        ents.append(f"*={spec(self.default)}")
        return ",".join(ents)


class ResolvedPolicy:
    """Per-GEMM-name → resolved :class:`GemmBackend` table.

    Built by :meth:`QuantPolicy.compile` (the full table, validated) or
    lazily by :meth:`QuantPolicy.resolved`: the first lookup of a name runs
    the pattern match and memoizes, so every later layer and tick sees only
    a dict hit. Quacks like a backend for ``qlinear.gemm/dense``
    (``for_gemm``)."""

    __slots__ = ("policy", "_table")

    def __init__(self, policy: QuantPolicy, table: dict | None = None):
        self.policy = policy
        self._table: dict[str, GemmBackend] = dict(table or {})

    def for_gemm(self, name: str) -> GemmBackend:
        be = self._table.get(name)
        if be is None:
            be = self.policy.resolve(name)
            self._table[name] = be
        return be

    def bits_for(self, name: str) -> int:
        return self.for_gemm(name).bits

    def __repr__(self) -> str:
        return f"ResolvedPolicy({self.policy.describe()!r}, {len(self._table)} names)"


_LEGACY_MSG = (
    "RunConfig.gemm_backend/gemm_mode/quant_layers are deprecated; use the "
    "declarative RunConfig.quant_policy (QuantPolicy / 'attn.*=int8,*=bf16' "
    "grammar) instead — the legacy knobs are lowered to a one-rule policy."
)


def load_policy(text: str | None) -> QuantPolicy | None:
    """CLI ``--policy`` value -> QuantPolicy: grammar string, inline JSON, or
    a policy file (``@path``, or any value ending in ``.json``)."""
    if text is None:
        return None
    if text.startswith("@"):
        with open(text[1:]) as f:
            text = f.read()
    elif text.endswith(".json"):
        with open(text) as f:
            text = f.read()
    return QuantPolicy.parse(text)


def effective_policy(rc) -> QuantPolicy:
    """The canonical policy for a RunConfig: ``rc.quant_policy`` if set
    (QuantPolicy | grammar/JSON string | parsed-JSON dict), else the
    deprecated single-backend knobs lowered to a one-rule policy (with a
    DeprecationWarning when they are actually in use). Setting *both* is
    ambiguous and rejected loudly — the legacy knobs would otherwise be
    silently ignored."""
    qp = getattr(rc, "quant_policy", None)
    if qp is not None:
        if (rc.gemm_backend != "bf16" or rc.gemm_mode != "dynamic"
                or rc.collect_gemm_stats or tuple(rc.quant_layers)):
            raise PolicyError(
                "RunConfig sets both quant_policy and the deprecated "
                "gemm_backend/gemm_mode/collect_gemm_stats/quant_layers "
                "knobs; the legacy knobs would be ignored — express "
                "everything in quant_policy (e.g. '*=int4:prequant:stats') "
                "or drop it to use the legacy knobs"
            )
        if isinstance(qp, QuantPolicy):
            return qp
        if isinstance(qp, str):
            return QuantPolicy.parse(qp)
        if isinstance(qp, dict):
            return QuantPolicy.from_json(qp)
        raise PolicyError(f"unsupported quant_policy {type(qp).__name__}")
    if rc.gemm_backend != "bf16" or tuple(rc.quant_layers):
        warnings.warn(_LEGACY_MSG, DeprecationWarning, stacklevel=3)
    return QuantPolicy.from_legacy(
        rc.gemm_backend, rc.gemm_mode, rc.collect_gemm_stats,
        layers=tuple(rc.quant_layers),
    )
