"""Request-lifecycle + tick-phase tracer with Chrome trace-event export
(Perfetto-loadable), and the schema checker the emitted JSON is gated on (a
copy of the reference's ``repro/obs/trace.py``).

Span taxonomy (DESIGN.md §14):

- **Request tracks** (pid :data:`PID_REQUESTS`, one tid per rid): a
  ``queued`` span from submit to admission, then one span per scheduled
  tick the row took part in — ``prefill`` / ``decode`` / ``draft`` /
  ``verify`` — each stamped with the device-step interval it rode, plus
  instant markers ``submit`` / ``admit`` / ``finish`` / ``shed`` /
  ``reject`` (reason in args).
- **Scheduler track** (pid :data:`PID_SCHED`, tid 0): one ``tick`` span per
  :meth:`Scheduler.tick` with nested phase spans — ``admit``, ``plan``,
  ``cow_drain``, ``device_step`` (ends at the host-side logits
  materialization, i.e. the device sync), ``commit`` — and for spec ticks
  ``draft`` / ``verify`` phases.
- **Counter tracks** (pid :data:`PID_SCHED`): ``pool_pages`` (in_use/live),
  ``queue_depth`` (per priority class), ``ladder_level``, and under
  ``track_energy`` ``modeled_power_mw`` + ``modeled_energy_mj`` — the
  SlotMeter cycle model priced on the paper's 16×16 unit, on the same
  wall-clock axis as the spans, which is the whole point: "why was this
  request slow" and "what did it cost in modeled mW" in one Perfetto view.

Timestamps are host ``perf_counter_ns`` relative to tracer construction, in
microseconds (the trace-event unit). The tracer is append-only host-side
bookkeeping: when disabled (:data:`NULL_TRACER`) every call is a no-op and
the scheduler additionally skips arg-dict construction, so the disabled
cost is one attribute test per site. Tracing never changes a token.

Export is the Chrome trace-event "JSON object format"::

    {"traceEvents": [...], "displayTimeUnit": "ms"}

loadable at https://ui.perfetto.dev (or chrome://tracing). Process/thread
labels ride ``ph: "M"`` metadata events.
"""

from __future__ import annotations

import json
import time
from contextlib import nullcontext

__all__ = [
    "Tracer",
    "NullTracer",
    "NULL_TRACER",
    "PID_SCHED",
    "PID_REQUESTS",
    "TID_TICK",
    "validate_chrome_trace",
    "trace_summary",
]

PID_SCHED = 1      # scheduler process: tick/phase spans + counter tracks
PID_REQUESTS = 2   # request process: one thread (tid) per rid
TID_TICK = 0

_NULL_CTX = nullcontext()


class _Span:
    """Hand-rolled context manager for :meth:`Tracer.span` — a plain class
    beats ``@contextmanager`` ~3x on enter/exit, and span() sits on the
    per-tick hot path."""

    __slots__ = ("_tr", "_name", "_pid", "_tid", "_cat", "_args", "_t0")

    def __init__(self, tr, name, pid, tid, cat, args):
        self._tr, self._name, self._pid, self._tid = tr, name, pid, tid
        self._cat, self._args = cat, args

    def __enter__(self):
        self._t0 = self._tr.ts()
        return self

    def __exit__(self, *exc):
        tr = self._tr
        tr._raw.append(("X", self._name, self._pid, self._tid, self._t0,
                        tr.ts() - self._t0, self._cat, self._args))
        return False


class Tracer:
    """Append-only trace-event recorder.

    The recording methods append compact tuples to ``_raw`` (~0.2µs each);
    trace-event dicts are materialized once, at :meth:`to_dict` /
    :meth:`export` time. ``args`` / ``values`` payloads are kept by
    reference — callers must pass freshly built (never re-mutated) dicts,
    which every scheduler call site does."""

    enabled = True

    def __init__(self):
        self._t0 = time.perf_counter_ns()
        # ("X", name, pid, tid, ts, dur, cat, args) | ("i", name, pid, tid,
        # ts, cat, args) | ("C", name, pid, ts, values) | ("M", kind, pid,
        # tid, label)
        self._raw: list[tuple] = []
        self._named: set[tuple] = set()
        self._proc_named: set[int] = set()

    # ---------------------------------------------------------------- time
    def ts(self) -> float:
        """Microseconds since tracer construction (trace-event clock)."""
        return (time.perf_counter_ns() - self._t0) / 1e3

    # ------------------------------------------------------------- labeling
    def name_process(self, pid: int, name: str) -> None:
        if pid in self._proc_named:
            return
        self._proc_named.add(pid)
        self._raw.append(("M", "process_name", pid, 0, name))

    def name_thread(self, pid: int, tid: int, name: str) -> None:
        key = (pid, tid)
        if key in self._named:
            return
        self._named.add(key)
        self._raw.append(("M", "thread_name", pid, tid, name))

    # ---------------------------------------------------------------- spans
    def complete(self, name, pid, tid, ts, dur, cat="serve", args=None):
        """One ``ph: "X"`` complete span with explicit start/duration (µs)."""
        self._raw.append(("X", name, pid, tid, ts, dur, cat, args))

    def span(self, name, pid=PID_SCHED, tid=TID_TICK, cat="serve", args=None):
        return _Span(self, name, pid, tid, cat, args)

    def instant(self, name, pid, tid, cat="serve", args=None, ts=None):
        self._raw.append(("i", name, pid, tid,
                          self.ts() if ts is None else ts, cat, args))

    def counter(self, name, values: dict, pid=PID_SCHED, ts=None):
        """One ``ph: "C"`` sample; each key of ``values`` is a series."""
        self._raw.append(("C", name, pid,
                          self.ts() if ts is None else ts, values))

    # --------------------------------------------------------------- export
    def to_dict(self) -> dict:
        """Materialize the Chrome trace-event envelope (cold path: float
        coercion, negative-duration clamping, and dict building all happen
        here, not per event at record time)."""
        out = []
        for t in self._raw:
            ph = t[0]
            if ph == "X":
                _, name, pid, tid, ts, dur, cat, args = t
                ev = {"ph": "X", "name": name, "cat": cat, "pid": pid,
                      "tid": tid, "ts": ts, "dur": max(dur, 0.0)}
                if args:
                    ev["args"] = args
            elif ph == "i":
                _, name, pid, tid, ts, cat, args = t
                ev = {"ph": "i", "name": name, "cat": cat, "pid": pid,
                      "tid": tid, "ts": ts, "s": "t"}
                if args:
                    ev["args"] = args
            elif ph == "C":
                _, name, pid, ts, values = t
                ev = {"ph": "C", "name": name, "cat": "serve", "pid": pid,
                      "tid": 0, "ts": ts,
                      "args": {k: float(v) for k, v in values.items()}}
            else:  # "M"
                _, kind, pid, tid, label = t
                ev = {"ph": "M", "name": kind, "pid": pid, "tid": tid,
                      "args": {"name": label}}
            out.append(ev)
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def export(self, path: str) -> dict:
        """Write the Chrome trace JSON; returns the event-count summary."""
        obj = self.to_dict()
        with open(path, "w") as f:
            json.dump(obj, f)
        return trace_summary(obj)


class NullTracer:
    """Disabled tracer: every method a no-op, ``span`` a shared nullcontext.

    Call sites additionally guard arg-dict construction on ``.enabled`` so
    the disabled path costs one attribute read."""

    enabled = False

    def ts(self) -> float:
        return 0.0

    def name_process(self, *a, **k) -> None:
        pass

    def name_thread(self, *a, **k) -> None:
        pass

    def complete(self, *a, **k) -> None:
        pass

    def span(self, *a, **k):
        return _NULL_CTX

    def instant(self, *a, **k) -> None:
        pass

    def counter(self, *a, **k) -> None:
        pass

    def to_dict(self) -> dict:
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    def export(self, path: str) -> dict:  # pragma: no cover - never wired
        raise ValueError("cannot export a disabled tracer")


NULL_TRACER = NullTracer()

_PHASES = {"X", "B", "E", "i", "I", "C", "M", "b", "e", "n"}


def validate_chrome_trace(obj) -> None:
    """Schema-check a Chrome trace-event JSON object (the CI gate).

    Raises ``ValueError`` naming the first offending event. Checks the
    envelope, per-event required keys, phase-specific fields (``X`` needs
    numeric ts+dur, ``C`` needs a numeric args dict), and monotone
    non-negative timestamps."""
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("trace: expected {'traceEvents': [...]} envelope")
    evs = obj["traceEvents"]
    if not isinstance(evs, list):
        raise ValueError("trace: traceEvents must be a list")
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            raise ValueError(f"trace[{i}]: event is not an object")
        for k in ("ph", "name", "pid", "tid"):
            if k not in ev:
                raise ValueError(f"trace[{i}]: missing required key {k!r}")
        ph = ev["ph"]
        if ph not in _PHASES:
            raise ValueError(f"trace[{i}]: unknown phase {ph!r}")
        if ph != "M":
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)) or ts < 0:
                raise ValueError(f"trace[{i}]: bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"trace[{i}]: X event bad dur {dur!r}")
        if ph == "C":
            args = ev.get("args")
            if not isinstance(args, dict) or not args or not all(
                    isinstance(v, (int, float)) for v in args.values()):
                raise ValueError(f"trace[{i}]: C event needs numeric args")
        if ph == "M" and ev["name"] in ("process_name", "thread_name"):
            if "name" not in ev.get("args", {}):
                raise ValueError(f"trace[{i}]: metadata missing args.name")


def trace_summary(obj) -> dict:
    """Counts by phase/name-prefix for gating: how many request spans, tick
    phase spans, counter samples, distinct request tracks."""
    spans: dict[str, int] = {}
    counters: dict[str, int] = {}
    instants: dict[str, int] = {}
    req_tids = set()
    for ev in obj.get("traceEvents", ()):
        if ev.get("pid") == PID_REQUESTS and ev["ph"] != "M":
            req_tids.add(ev["tid"])
        if ev["ph"] == "X":
            spans[ev["name"]] = spans.get(ev["name"], 0) + 1
        elif ev["ph"] == "C":
            counters[ev["name"]] = counters.get(ev["name"], 0) + 1
        elif ev["ph"] in ("i", "I"):
            instants[ev["name"]] = instants.get(ev["name"], 0) + 1
    return {"events": len(obj.get("traceEvents", ())), "spans": spans,
            "counters": counters, "instants": instants,
            "request_tracks": len(req_tids)}
