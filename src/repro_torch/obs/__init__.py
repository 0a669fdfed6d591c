"""Serving observability layer (the port of the reference's ``repro/obs``;
DESIGN.md §14).

- obs.trace: request-lifecycle + tick-phase Tracer, Chrome trace-event
  (Perfetto) export, and the schema checker CI gates traces on
- obs.metrics: labeled counter/gauge/histogram registry with snapshot/diff,
  Prometheus text exposition, and a JSONL emitter
- obs.profile: ``torch.profiler.record_function`` (and, on the card, NVTX)
  ranges around the serve steps + optional ``torch.profiler`` device-trace
  wiring
- obs.logs: the ``kv()`` structured-log formatter (``rid=/tenant=/tick=``)

Everything here is host-side bookkeeping that must never change tokens:
greedy tokens and cycle totals are the same with tracing on and off.
"""

from .logs import kv
from .metrics import (
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricFamily,
    MetricsRegistry,
    family_percentile,
)
from .profile import device_trace, named_scope
from .trace import (
    NULL_TRACER,
    PID_REQUESTS,
    PID_SCHED,
    TID_TICK,
    NullTracer,
    Tracer,
    trace_summary,
    validate_chrome_trace,
)

__all__ = [
    "Counter",
    "DEFAULT_BUCKETS",
    "Gauge",
    "Histogram",
    "MetricFamily",
    "MetricsRegistry",
    "NULL_TRACER",
    "NullTracer",
    "PID_REQUESTS",
    "PID_SCHED",
    "TID_TICK",
    "Tracer",
    "device_trace",
    "family_percentile",
    "kv",
    "named_scope",
    "trace_summary",
    "validate_chrome_trace",
]
