"""Overload response of the serving loop: the degradation ladder (copy of
``repro/serve/admission.py``'s ``DegradationLadder``).

The scheduler reports pool pressure to the ladder (a preemption, a row
whose page allocation stalled) and reads back how much prefill it may
schedule per tick; the ladder never touches engine state, so its
transition log is a faithful record of the run. Admission classes, queue
bounds and shedding (the ladder's top levels) belong to the admission
slice and are not ported yet.
"""

from __future__ import annotations

__all__ = ["LADDER_LEVELS", "DegradationLadder"]

LADDER_LEVELS = ("healthy", "degrade_gamma", "shrink_chunk", "preempt",
                 "shed", "reject")


class DegradationLadder:
    """Ordered overload response: escalate one level per pressure tick,
    relax one level after ``relax_after`` consecutive clean ticks."""

    def __init__(self, relax_after: int = 4):
        self.relax_after = max(int(relax_after), 1)
        self.level = 0
        self.transitions: list[dict] = []
        self.occupancy = [0] * len(LADDER_LEVELS)
        self._clean = 0
        self._last_escalation = -1
        self._pressure_at = -1   # clock of the last pressure event

    def _move(self, now: int, new: int, reason: str) -> None:
        if new == self.level:
            return
        self.transitions.append({
            "tick": now, "from": LADDER_LEVELS[self.level],
            "to": LADDER_LEVELS[new], "reason": reason,
        })
        self.level = new

    def note_pressure(self, now: int, reason: str, floor: int = 0,
                      ceil: int | None = None) -> None:
        """One pressure event. Escalates at most one level per tick; a
        ``floor`` (3 once preemption actually ran) applies even if this tick
        already escalated, so the level never understates the remedies in
        use. ``ceil`` bounds how far this kind of pressure can push:
        allocation stalls stop at ``preempt``."""
        self._clean = 0
        self._pressure_at = now
        target = max(self.level, floor)
        if self._last_escalation != now and self.level < len(LADDER_LEVELS) - 1:
            target = max(target, self.level + 1)
            self._last_escalation = now
        if ceil is not None:
            target = min(target, max(ceil, self.level))
        self._move(now, min(target, len(LADDER_LEVELS) - 1), reason)

    def escalate_to(self, now: int, floor: int, reason: str) -> None:
        self.note_pressure(now, reason, floor=floor)

    def note_clean(self, now: int) -> None:
        """End-of-tick relax signal; a no-op if pressure was noted at this
        same clock (the scheduler calls it every tick)."""
        if self._pressure_at == now:
            return
        self._clean += 1
        if self.level > 0 and self._clean >= self.relax_after:
            self._move(now, self.level - 1, f"{self._clean} clean ticks")
            self._clean = 0

    def tick(self) -> None:
        """Record one tick spent at the current level (occupancy)."""
        self.occupancy[self.level] += 1

    def prefill_budget(self, token_budget: int, chunk: int) -> int:
        """Per-tick prefill token cap: the full budget below level 2, then
        halved per level with a one-chunk floor (admitted work must keep
        making progress or it can never release its pages)."""
        if self.level < 2:
            return token_budget
        return max(chunk, token_budget >> (self.level - 1))

    def snapshot(self) -> dict:
        return {
            "level": self.level,
            "name": LADDER_LEVELS[self.level],
            "transitions": list(self.transitions),
            "occupancy": {LADDER_LEVELS[i]: n for i, n in enumerate(self.occupancy)},
        }
