"""Deterministic fault injection for the serving engine (a copy of the
reference's ``repro/serve/faults.py``; DESIGN.md §10).

A :class:`FaultPlan` is a fixed, seed-keyed schedule of induced faults over
the scheduler's *logical clock* (``Scheduler.clock``) — never wall time, and
never live randomness — so a chaos run replays bit-for-bit and a failure
shrinks to a seed. Four fault kinds cover the engine's real failure surface:

- ``alloc_fail`` — :class:`~repro_torch.serve.cache.BlockManager` page allocation
  refuses a specific slot this tick (the hook fires inside ``extend``, before
  any mutation). Models pool exhaustion / fragmentation; exercises the stall
  accounting, γ-degrade, and preemption paths.
- ``preempt_storm`` — force ``arg`` recompute-preemptions at tick start.
  Models an external reclaim (e.g. a higher-priority tenant burst); exercises
  release/readmit and the re-prefill path.
- ``draft_stale`` — mark one slot's speculative draft pool stale. Models a
  draft view falling behind; exercises the plain-decode fallback and the
  draft resync. Inert without speculative decoding, as in the reference.
- ``nan_logits`` — overwrite one scheduled row's step logits with NaN on the
  host. Models a low-bit numerical fault (overflowed int2/int4 accumulation);
  exercises the quarantine/retry/bf16-fallback guard. Generated plans space
  these ≥ ``nan_spacing`` ticks apart per row so a *transient* fault always
  clears within the scheduler's clean-retry window (persistent faults are a
  deliberate, separately-tested escalation).

The invariant the chaos tests pin: faults may change
*scheduling* — tick counts, preemptions, ladder level, γ — but never
*results*: greedy tokens stay bit-exact vs the fault-free run and the page
allocator's free ⊎ allocated partition always holds.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["FAULT_KINDS", "DEFAULT_RATES", "FaultEvent", "FaultPlan"]

FAULT_KINDS = ("alloc_fail", "preempt_storm", "draft_stale", "nan_logits")

# default per-tick, per-kind firing probabilities for generated plans
DEFAULT_RATES = {
    "alloc_fail": 0.12,
    "preempt_storm": 0.04,
    "draft_stale": 0.05,
    "nan_logits": 0.06,
}


@dataclass(frozen=True)
class FaultEvent:
    """One induced fault: fires at logical ``tick``; ``arg`` is the target
    slot/row for row-scoped kinds, the preemption count for storms."""

    tick: int
    kind: str
    arg: int = 0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; one of {FAULT_KINDS}")


class FaultPlan:
    """An immutable schedule of :class:`FaultEvent`. Build explicitly from
    events (targeted tests) or via :meth:`generate` (seed-keyed chaos)."""

    def __init__(self, events=()):
        self.events = tuple(sorted(events, key=lambda e: (e.tick, e.kind, e.arg)))
        self._by_tick: dict[int, list[FaultEvent]] = {}
        for e in self.events:
            self._by_tick.setdefault(e.tick, []).append(e)

    @classmethod
    def generate(
        cls,
        seed: int,
        *,
        horizon: int,
        max_batch: int,
        rates: dict | None = None,
        nan_spacing: int = 6,
    ) -> "FaultPlan":
        """Seed-keyed random plan over ``horizon`` ticks. Row-scoped faults
        target a uniform slot; ``nan_logits`` events on the same row are kept
        ``nan_spacing`` ticks apart (see module docstring). Same seed ==
        same plan, independent of how the engine consumes it."""
        rng = np.random.default_rng(seed)
        use = dict(DEFAULT_RATES)
        if rates:
            use.update(rates)
        events: list[FaultEvent] = []
        last_nan: dict[int, int] = {}
        for t in range(1, horizon + 1):
            for kind in FAULT_KINDS:          # fixed order: deterministic draws
                r = use.get(kind, 0.0)
                if r <= 0.0 or rng.random() >= r:
                    continue
                if kind == "preempt_storm":
                    events.append(FaultEvent(t, kind, int(rng.integers(1, max_batch + 1))))
                    continue
                row = int(rng.integers(0, max_batch))
                if kind == "nan_logits":
                    if t - last_nan.get(row, -(1 << 30)) < nan_spacing:
                        continue
                    last_nan[row] = t
                events.append(FaultEvent(t, kind, row))
        return cls(events)

    # -------------------------------------------------------------- queries
    def at(self, tick: int, kind: str | None = None) -> list[FaultEvent]:
        evs = self._by_tick.get(tick, [])
        return evs if kind is None else [e for e in evs if e.kind == kind]

    def fires(self, tick: int, kind: str, arg: int) -> bool:
        return any(e.kind == kind and e.arg == arg for e in self._by_tick.get(tick, ()))

    @property
    def horizon(self) -> int:
        return self.events[-1].tick if self.events else 0

    def __len__(self) -> int:
        return len(self.events)

    def describe(self) -> dict:
        by_kind: dict[str, int] = {}
        for e in self.events:
            by_kind[e.kind] = by_kind.get(e.kind, 0) + 1
        return {"events": len(self.events), "horizon": self.horizon,
                "by_kind": by_kind}
