"""Admission control + the overload degradation ladder (a copy of the
reference's ``repro/serve/admission.py``; DESIGN.md §10).

The source paper's regime — always-on, power-constrained edge serving — is
exactly where a serving engine must degrade *predictably* under overload
instead of stalling or OOMing: temporal-unary latency is data-dependent, so
worst-case provisioning is the thing tuGEMM exists to avoid paying for.
This module makes the pressure handling that used to be scattered through
serve/scheduler.py (silent row stalls, youngest-victim preemption, inline
spec-γ degrade) explicit and testable:

- :class:`AdmissionController` — priority classes (``realtime`` >
  ``interactive`` > ``batch``), bounded per-class FIFO queues with
  backpressure, per-tenant token budgets, and per-request deadlines/TTLs in
  *scheduler clock ticks* (a logical clock, so fault-injected runs stay
  deterministic). Expired or over-budget work is shed **before** it consumes
  a prefill chunk, and every refusal is a structured :class:`Rejection`
  (``req.rejected``) instead of an unbounded silent queue.
- :class:`DegradationLadder` — ONE ordered escalation path under
  pool/budget pressure::

      0 healthy
      1 degrade_gamma   halve speculative γ (spec work is optimistic)
      2 shrink_chunk    shrink the per-tick prefill token budget
      3 preempt         recompute-preempt lowest-priority-youngest
      4 shed            drop expired + batch-class queued work; γ -> 0
      5 reject          pause admissions (structured backpressure)

  Effects are cumulative with level. The ladder escalates at most one level
  per tick and relaxes one level after ``relax_after`` consecutive clean
  ticks; every transition is recorded and the per-level tick occupancy is
  part of ``Scheduler.health()``.

Both are pure host-side bookkeeping — no torch, no wall clock — which is
what lets a fault-injected run replay the same schedule every time.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

from ..obs.metrics import MetricsRegistry

__all__ = [
    "PRIORITIES",
    "LADDER_LEVELS",
    "RejectReason",
    "Rejection",
    "AdmissionController",
    "DegradationLadder",
]

# admission order: realtime drains before interactive drains before batch
PRIORITIES = ("realtime", "interactive", "batch")
PRIORITY_RANK = {p: i for i, p in enumerate(PRIORITIES)}


class RejectReason:
    """Structured refusal reasons — every non-completed request carries one."""

    QUEUE_FULL = "queue_full"              # class queue at its bound (backpressure)
    OVER_BUDGET = "over_budget"            # tenant token budget exhausted
    DEADLINE_EXPIRED = "deadline_expired"  # TTL passed before the work could run
    ADMISSION_PAUSED = "admission_paused"  # ladder level 5: engine refusing load
    SHED_OVERLOAD = "shed_overload"        # ladder level 4: batch-class shed
    SHUTTING_DOWN = "shutting_down"        # graceful drain: no new admissions
    NUMERICAL_FAULT = "numerical_fault"    # non-finite logits, no fallback path

    ALL = (QUEUE_FULL, OVER_BUDGET, DEADLINE_EXPIRED, ADMISSION_PAUSED,
           SHED_OVERLOAD, SHUTTING_DOWN, NUMERICAL_FAULT)


@dataclass(frozen=True)
class Rejection:
    """Terminal structured refusal: why + when (scheduler clock)."""

    rid: int
    reason: str
    detail: str = ""
    tick: int = 0


class AdmissionController:
    """Bounded multi-class admission queues with tenant budgets and TTLs.

    Time is the scheduler's logical clock (``Scheduler.clock``), passed into
    every mutating call — never wall time, so replays are deterministic.

    ``max_queue`` bounds each class queue (int = same bound for all classes,
    dict = per-class, None = unbounded, preserving pre-admission behavior).
    ``tenant_budgets`` maps tenant -> lifetime token budget; a request is
    charged ``len(prompt) + max_new`` at admission and *settled* exactly once
    when it reaches a terminal state: the unconsumed remainder
    ``charged - consumed`` is refunded, where consumed counts prompt tokens
    actually prefilled plus tokens actually generated. A request shed
    straight out of the queue consumed nothing and gets the full charge
    back; one that stops early at EOS gets its unused ``max_new`` back; a
    preemption requeue that later expires keeps only what it truly burned.
    ``default_ttl`` supplies a per-class TTL (in ticks) for requests that do
    not set ``ttl_ticks`` themselves.
    """

    def __init__(
        self,
        *,
        max_queue: int | dict | None = None,
        tenant_budgets: dict | None = None,
        default_ttl: int | dict | None = None,
    ):
        if isinstance(max_queue, int):
            max_queue = {p: max_queue for p in PRIORITIES}
        self.max_queue = max_queue or {}
        self.tenant_budgets = dict(tenant_budgets or {})
        if isinstance(default_ttl, int):
            default_ttl = {p: default_ttl for p in PRIORITIES}
        self.default_ttl = default_ttl or {}
        self.queues: dict[str, deque] = {p: deque() for p in PRIORITIES}
        self.tenant_spent: dict[str, int] = {}
        self.rejections: list[Rejection] = []
        # registry-backed counters (obs/metrics.py): ``submitted`` /
        # ``admitted`` / ``sheds`` are class-level properties over these, so
        # the historical int-attribute write sites keep working while the
        # numbers export through Prometheus/JSONL. A standalone controller
        # owns its own registry until a Scheduler re-homes it (bind_registry).
        self.metrics = MetricsRegistry()
        self._init_metric_handles()
        self.submitted = 0
        self.admitted = 0
        self.sheds = 0                    # rejections of previously-queued work
        self.paused = False               # ladder level 5
        self.draining = False             # graceful shutdown

    def _init_metric_handles(self) -> None:
        m = self.metrics
        self._ctr = {
            "submitted": m.counter("admission_submitted_total",
                                   "requests offered to the controller"),
            "admitted": m.counter("admission_admitted_total",
                                  "requests that first entered a slot"),
            "sheds": m.counter("admission_sheds_total",
                               "rejections of previously-queued work"),
        }
        self._c_rejections = m.counter(
            "admission_rejections_total",
            "structured rejections by reason", labels=("reason",))

    def bind_registry(self, registry: MetricsRegistry) -> None:
        """Re-home this controller's metrics onto ``registry`` (the owning
        Scheduler's): families merge in (counters add on collision), then
        local handles are re-fetched so both objects write one store."""
        registry.adopt(self.metrics)
        self.metrics = registry
        self._init_metric_handles()

    # ------------------------------------------------------------- helpers
    @staticmethod
    def _cost(req) -> int:
        return len(req.prompt) + req.max_new

    def _reject(self, req, reason: str, now: int, detail: str = "") -> Rejection:
        r = Rejection(rid=req.rid, reason=reason, detail=detail, tick=now)
        req.rejected = r
        self.rejections.append(r)
        self._c_rejections.labels(reason).inc()
        return r

    def _shed(self, req, reason: str, now: int, detail: str = "") -> Rejection:
        """Reject already-queued work: settle its tenant charge. A request
        that never ran consumed nothing and gets the full charge back; a
        preemption requeue keeps the prefill chunks and generated tokens it
        already burned (the old full-cost refund here let repeated
        preempt-then-expire cycles drive ``tenant_spent`` below true
        consumption)."""
        self.sheds += 1
        self.settle(req)
        return self._reject(req, reason, now, detail)

    def settle(self, req) -> None:
        """Refund the unconsumed remainder of ``req``'s tenant charge,
        exactly once per request (terminal states can be reached from both
        the scheduler's finish/shed paths and the queue's expiry paths).
        Consumption can exceed the charge under repeated recompute-
        preemption — recomputed prefill chunks are real work — so the
        refund clamps at zero rather than charging beyond the quote."""
        charged = getattr(req, "charged", 0)
        if not charged or getattr(req, "settled", False):
            return
        req.settled = True
        refund = max(charged - req.consumed_tokens(), 0)
        tenant = getattr(req, "tenant", "default")
        if tenant in self.tenant_spent:
            self.tenant_spent[tenant] -= refund

    # -------------------------------------------------------------- submit
    def submit(self, req, now: int) -> Rejection | None:
        """Admit ``req`` into its class queue or refuse it with a structured
        reason. Returns None on success (the request is queued), else the
        :class:`Rejection` (also stored on ``req.rejected``)."""
        self.submitted += 1
        pri = getattr(req, "priority", "interactive")
        if pri not in PRIORITY_RANK:
            raise ValueError(f"request {req.rid}: unknown priority {pri!r}; "
                             f"one of {PRIORITIES}")
        if self.draining:
            return self._reject(req, RejectReason.SHUTTING_DOWN, now)
        if self.paused:
            return self._reject(req, RejectReason.ADMISSION_PAUSED, now,
                                "degradation ladder at level 5")
        ttl = req.ttl_ticks if req.ttl_ticks is not None else self.default_ttl.get(pri)
        if ttl is not None:
            if ttl <= 0:
                return self._reject(req, RejectReason.DEADLINE_EXPIRED, now,
                                    f"ttl {ttl} <= 0 at submit")
            req.deadline = now + int(ttl)
        bound = self.max_queue.get(pri)
        if bound is not None and len(self.queues[pri]) >= bound:
            return self._reject(req, RejectReason.QUEUE_FULL, now,
                                f"{pri} queue at bound {bound}")
        tenant = getattr(req, "tenant", "default")
        budget = self.tenant_budgets.get(tenant)
        if budget is not None:
            cost = self._cost(req)
            spent = self.tenant_spent.get(tenant, 0)
            if spent + cost > budget:
                return self._reject(
                    req, RejectReason.OVER_BUDGET, now,
                    f"tenant {tenant!r}: {spent}+{cost} tokens > budget {budget}")
            self.tenant_spent[tenant] = spent + cost
            req.charged = cost
        req.submitted_tick = now
        self.queues[pri].append(req)
        return None

    # ----------------------------------------------------------------- pop
    def pop(self, now: int, *, readmit_only: bool = False) -> "object | None":
        """Next admissible request: highest class first, FIFO within a class.
        Expired work is shed (with :data:`RejectReason.DEADLINE_EXPIRED`) as
        it is encountered — it never consumes a prefill chunk. With
        ``readmit_only`` (graceful drain) only previously-admitted requests
        (preemption requeues) are eligible; fresh ones stay queued for the
        shutdown flush."""
        for pri in PRIORITIES:
            q = self.queues[pri]
            skipped = []
            got = None
            while q:
                req = q.popleft()
                if req.deadline is not None and now >= req.deadline:
                    self._shed(req, RejectReason.DEADLINE_EXPIRED, now,
                               f"deadline {req.deadline} <= clock {now}")
                    continue
                if readmit_only and not req.admitted:
                    skipped.append(req)
                    continue
                got = req
                break
            for r in reversed(skipped):
                q.appendleft(r)
            if got is not None:
                self.admitted += not got.admitted
                got.admitted = True
                return got
        return None

    def requeue_front(self, req) -> None:
        """Preemption path: an admitted request goes back to the *front* of
        its class queue (it resumes before anything behind it)."""
        self.queues[getattr(req, "priority", "interactive")].appendleft(req)

    # ---------------------------------------------------------------- shed
    def shed_expired(self, now: int) -> int:
        """Drop every queued request whose deadline already passed."""
        n = 0
        for pri in PRIORITIES:
            keep = deque()
            for req in self.queues[pri]:
                if req.deadline is not None and now >= req.deadline:
                    self._shed(req, RejectReason.DEADLINE_EXPIRED, now)
                    n += 1
                else:
                    keep.append(req)
            self.queues[pri] = keep
        return n

    def shed_class(self, pri: str, now: int,
                   reason: str = RejectReason.SHED_OVERLOAD) -> int:
        """Ladder level 4: drop every queued request of one class."""
        q = self.queues[pri]
        n = len(q)
        for req in q:
            self._shed(req, reason, now)
        q.clear()
        return n

    def flush_pending(self, reason: str, now: int) -> int:
        """Terminal flush (graceful shutdown): reject everything still
        queued so no request is silently dropped."""
        n = 0
        for pri in PRIORITIES:
            n += self.shed_class(pri, now, reason)
        return n

    # ------------------------------------------------------------- queries
    def pending(self, *, admitted_only: bool = False) -> int:
        if admitted_only:
            return sum(1 for q in self.queues.values() for r in q if r.admitted)
        return sum(len(q) for q in self.queues.values())

    def pending_list(self) -> list:
        """Pop-order view of the queues (back-compat ``Scheduler.queue``)."""
        return [r for pri in PRIORITIES for r in self.queues[pri]]

    def queue_pressure(self) -> bool:
        """True when any *bounded* class queue is at its bound — the signal
        that drives the ladder past ``preempt`` into ``shed``/``reject``.
        Unbounded queues (the default) never report pressure here, which
        keeps the pre-admission engine behavior: pure pool pressure is
        absorbed by γ-degrade/chunk-shrink/preemption, never by refusing
        work."""
        return any(
            bound is not None and len(self.queues[pri]) >= bound
            for pri in PRIORITIES
            for bound in (self.max_queue.get(pri),)
        )

    def depths(self) -> dict[str, int]:
        return {pri: len(q) for pri, q in self.queues.items()}

    def rejections_by_reason(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for r in self.rejections:
            out[r.reason] = out.get(r.reason, 0) + 1
        return out


def _adm_counter_property(attr: str):
    def fget(self):
        return int(self._ctr[attr].value)

    def fset(self, v):
        self._ctr[attr].value = v

    return property(fget, fset)


# Registry-backed views over the legacy counter attributes — instance
# assignment (``self.sheds += 1``, including the Scheduler's own writes to
# ``self.admission.sheds``) routes through the property setter.
for _a in ("submitted", "admitted", "sheds"):
    setattr(AdmissionController, _a, _adm_counter_property(_a))
del _a


# ------------------------------------------------------------------ ladder
LADDER_LEVELS = ("healthy", "degrade_gamma", "shrink_chunk", "preempt",
                 "shed", "reject")


class DegradationLadder:
    """Ordered overload response: escalate one level per pressure tick,
    relax one level after ``relax_after`` consecutive clean ticks.

    The scheduler *reports* pressure (:meth:`note_pressure`,
    :meth:`escalate_to`) and *reads* effects (:meth:`gamma_cap`,
    :meth:`prefill_budget`, :attr:`level`); the ladder itself never touches
    engine state, so its transition log is a faithful record of the run.
    """

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
        ``floor`` (e.g. 3 once preemption actually ran) is applied even if
        this tick already escalated — the ladder level may never understate
        the remedies in use. ``ceil`` bounds how far this *kind* of pressure
        can push: pool-allocation stalls cap at ``preempt`` (they are fully
        remediable inside the engine); only queue pressure — bounded
        admission queues at their limit — reaches ``shed``/``reject``."""
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
        same clock (the scheduler calls this unconditionally)."""
        if self._pressure_at == now:
            return
        self._clean += 1
        if self.level > 0 and self._clean >= self.relax_after:
            self._move(now, self.level - 1, f"{self._clean} clean ticks")
            self._clean = 0

    def tick(self) -> None:
        """Record one tick spent at the current level (occupancy)."""
        self.occupancy[self.level] += 1

    # ------------------------------------------------------------- effects
    def gamma_cap(self, gamma: int) -> int:
        """Speculative γ under the current level: full when healthy, halved
        per level from 1 (optimistic draft work is the first thing to go),
        zero at shed/reject — every page goes to committed tokens."""
        if self.level == 0:
            return gamma
        if self.level >= 4:
            return 0
        return max(1, gamma >> self.level)

    def prefill_budget(self, token_budget: int, chunk: int) -> int:
        """Per-tick prefill token cap: full budget below level 2, then
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
            "occupancy": {LADDER_LEVELS[i]: n
                          for i, n in enumerate(self.occupancy)},
        }
