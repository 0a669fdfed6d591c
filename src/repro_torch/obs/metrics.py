"""Labeled metrics registry: counters, gauges, histograms with snapshot/diff
semantics and Prometheus-text + JSONL emitters (a copy of the reference's
``repro/obs/metrics.py``; DESIGN.md §14).

The serving stack's counters live here: the Scheduler's, the
AdmissionController's and the BlockManager's, exported through
``health()``, Prometheus text and JSONL:

- :class:`Counter` — monotone float/int with ``inc``; labeled families via
  :meth:`MetricsRegistry.counter`.
- :class:`Gauge` — settable level (``set``/``inc``/``dec``); also callback
  gauges (:meth:`MetricsRegistry.gauge_fn`) collected lazily at snapshot
  time, so structural state (pool occupancy, queue depths) need not be
  pushed on every mutation.
- :class:`Histogram` — fixed upper-bound buckets plus a capped raw-sample
  reservoir, so ``percentile(p)`` is exact until the cap and
  bucket-interpolated after; powers the p50/p95/p99 TTFT, inter-token and
  tick latencies of ``Scheduler.health()``.

Everything is pure host-side Python — no torch, no wall-clock reads inside
the registry itself — so metric bookkeeping can never perturb scheduling
decisions or device numerics (tracing on or off gives the same tokens).

Snapshot shape::

    {metric_name: {"type": "counter"|"gauge"|"histogram", "help": str,
                   "values": {label_key: number | hist_dict}}}

where ``label_key`` is ``"a=1,b=x"`` (sorted by labelname order, ``""`` for
unlabeled) — stable, grep-able, JSON-safe. ``diff(prev)`` subtracts
counters/histograms and passes gauges through, which is what lets one
process host several engines without cross-talk (each holds its own
baseline snapshot — see ``kernels.ops.kernel_counters_since``).
"""

from __future__ import annotations

import json
import math
import time

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricFamily",
    "MetricsRegistry",
    "DEFAULT_BUCKETS",
    "family_percentile",
]

# Latency-ish default buckets (seconds): 100us .. ~2min, roughly log-spaced.
DEFAULT_BUCKETS = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)

_RAW_CAP = 65536  # raw-sample reservoir bound per histogram child


class Counter:
    """Monotone counter. ``value`` is directly readable (the serve layer
    exposes its legacy int attributes as views over these)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: float = 1) -> None:
        self.value += n


class Gauge:
    """Settable level."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def set(self, v: float) -> None:
        self.value = v

    def inc(self, n: float = 1) -> None:
        self.value += n

    def dec(self, n: float = 1) -> None:
        self.value -= n


class Histogram:
    """Fixed-bucket histogram with a capped exact-sample reservoir.

    ``bucket_counts[i]`` counts observations <= ``buckets[i]`` (cumulative at
    export time, non-cumulative internally); the ``+Inf`` bucket is implicit
    (``count``). Until ``_RAW_CAP`` observations the raw samples are kept and
    ``percentile`` is exact; past the cap it falls back to linear
    interpolation inside the bucket bounds."""

    __slots__ = ("buckets", "bucket_counts", "count", "sum", "raw")

    def __init__(self, buckets=DEFAULT_BUCKETS):
        self.buckets = tuple(sorted(buckets))
        self.bucket_counts = [0] * len(self.buckets)
        self.count = 0
        self.sum = 0.0
        self.raw: list[float] = []

    def observe(self, v: float) -> None:
        self.count += 1
        self.sum += v
        for i, ub in enumerate(self.buckets):
            if v <= ub:
                self.bucket_counts[i] += 1
                break
        if len(self.raw) < _RAW_CAP:
            self.raw.append(v)

    def percentile(self, p: float) -> float:
        """p in [0, 100]. Exact while the reservoir holds every sample."""
        if self.count == 0:
            return 0.0
        if self.raw and len(self.raw) == self.count:
            s = sorted(self.raw)
            k = (len(s) - 1) * (p / 100.0)
            lo, hi = int(math.floor(k)), int(math.ceil(k))
            if lo == hi:
                return s[lo]
            return s[lo] + (s[hi] - s[lo]) * (k - lo)
        # bucket interpolation: find the bucket holding the p-th sample
        target = self.count * (p / 100.0)
        seen = 0
        prev_ub = 0.0
        for i, ub in enumerate(self.buckets):
            c = self.bucket_counts[i]
            if seen + c >= target and c > 0:
                frac = (target - seen) / c
                return prev_ub + (ub - prev_ub) * frac
            seen += c
            prev_ub = ub
        return self.buckets[-1] if self.buckets else 0.0

    def to_dict(self) -> dict:
        cum = []
        run = 0
        for c in self.bucket_counts:
            run += c
            cum.append(run)
        return {
            "count": self.count,
            "sum": self.sum,
            "buckets": {str(ub): cum[i] for i, ub in enumerate(self.buckets)},
        }


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricFamily:
    """One named metric with 0+ labelnames; children keyed by label values."""

    __slots__ = ("name", "help", "kind", "labelnames", "children", "_kw")

    def __init__(self, name, help="", kind="counter", labelnames=(), **kw):
        self.name = name
        self.help = help
        self.kind = kind
        self.labelnames = tuple(labelnames)
        self.children: dict[tuple, object] = {}
        self._kw = kw  # e.g. histogram buckets

    def labels(self, *values, **kv) -> object:
        if kv:
            values = tuple(kv[n] for n in self.labelnames)
        key = tuple(str(v) for v in values)
        if len(key) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, got {key}")
        child = self.children.get(key)
        if child is None:
            child = _KINDS[self.kind](**self._kw)
            self.children[key] = child
        return child

    # unlabeled families act like their single child
    def _solo(self):
        return self.labels()

    def inc(self, n: float = 1) -> None:
        self._solo().inc(n)

    def set(self, v: float) -> None:
        self._solo().set(v)

    def dec(self, n: float = 1) -> None:
        self._solo().dec(n)

    def observe(self, v: float) -> None:
        self._solo().observe(v)

    def percentile(self, p: float) -> float:
        return self._solo().percentile(p)

    @property
    def value(self):
        return self._solo().value

    @value.setter
    def value(self, v):
        self._solo().value = v

    def label_key(self, key: tuple) -> str:
        return ",".join(f"{n}={v}" for n, v in zip(self.labelnames, key))


class MetricsRegistry:
    """Named metric families + lazy callback gauges; snapshot/diff/export."""

    def __init__(self):
        self.families: dict[str, MetricFamily] = {}
        self._callbacks: dict[str, tuple] = {}  # name -> (help, fn)

    # ------------------------------------------------------------ creation
    def _family(self, name, help, kind, labels, **kw) -> MetricFamily:
        fam = self.families.get(name)
        if fam is not None:
            if fam.kind != kind or fam.labelnames != tuple(labels):
                raise ValueError(
                    f"metric {name!r} re-registered as {kind}{tuple(labels)} "
                    f"(was {fam.kind}{fam.labelnames})")
            return fam
        fam = MetricFamily(name, help, kind, labels, **kw)
        self.families[name] = fam
        return fam

    def counter(self, name, help="", labels=()) -> MetricFamily:
        return self._family(name, help, "counter", labels)

    def gauge(self, name, help="", labels=()) -> MetricFamily:
        return self._family(name, help, "gauge", labels)

    def histogram(self, name, help="", labels=(), buckets=DEFAULT_BUCKETS):
        return self._family(name, help, "histogram", labels, buckets=buckets)

    def gauge_fn(self, name, fn, help="") -> None:
        """Register a callback gauge: ``fn()`` -> number or {label_key: number},
        read at snapshot time. The lazy form for structural state that would
        be wasteful to push on every mutation (pool occupancy, queue depth)."""
        self._callbacks[name] = (help, fn)

    def adopt(self, other: "MetricsRegistry") -> None:
        """Move ``other``'s families and callbacks into this registry (the
        serve layer re-homes an AdmissionController's standalone registry
        onto the owning Scheduler's). Existing handles into the moved
        families stay valid — the family objects move wholesale. Name
        collisions merge child-by-child (counters add; gauges/histograms
        take the adoptee's children)."""
        if other is self:
            return
        for name, fam in other.families.items():
            mine = self.families.get(name)
            if mine is None:
                self.families[name] = fam
                continue
            for key, child in fam.children.items():
                if key in mine.children and fam.kind == "counter":
                    mine.children[key].inc(child.value)
                else:
                    mine.children[key] = child
        self._callbacks.update(other._callbacks)
        other.families = self.families
        other._callbacks = self._callbacks

    # ------------------------------------------------------------ snapshot
    def snapshot(self) -> dict:
        out = {}
        for name, fam in self.families.items():
            vals = {}
            for key, child in fam.children.items():
                k = fam.label_key(key)
                vals[k] = (child.to_dict() if fam.kind == "histogram"
                           else child.value)
            out[name] = {"type": fam.kind, "help": fam.help, "values": vals}
        for name, (help, fn) in self._callbacks.items():
            v = fn()
            vals = dict(v) if isinstance(v, dict) else {"": v}
            out[name] = {"type": "gauge", "help": help, "values": vals}
        return out

    @staticmethod
    def diff(cur: dict, prev: dict) -> dict:
        """Per-label-key deltas of ``cur`` relative to ``prev``: counters and
        histogram counts subtract, gauges pass through unchanged. Label keys
        absent from ``prev`` diff against zero."""
        out = {}
        for name, m in cur.items():
            pm = prev.get(name, {}).get("values", {})
            if m["type"] == "gauge":
                out[name] = dict(m, values=dict(m["values"]))
                continue
            vals = {}
            for k, v in m["values"].items():
                pv = pm.get(k)
                if m["type"] == "histogram":
                    pc = pv["count"] if pv else 0
                    ps = pv["sum"] if pv else 0.0
                    pb = pv["buckets"] if pv else {}
                    vals[k] = {
                        "count": v["count"] - pc,
                        "sum": v["sum"] - ps,
                        "buckets": {ub: c - pb.get(ub, 0)
                                    for ub, c in v["buckets"].items()},
                    }
                else:
                    vals[k] = v - (pv or 0)
            out[name] = dict(m, values=vals)
        return out

    # -------------------------------------------------------------- export
    def to_prometheus(self) -> str:
        """Prometheus text exposition (v0.0.4) of the current snapshot."""
        lines = []
        snap = self.snapshot()
        for name, m in sorted(snap.items()):
            if m["help"]:
                lines.append(f"# HELP {name} {m['help']}")
            lines.append(f"# TYPE {name} {m['type']}")
            for k, v in m["values"].items():
                lbl = ""
                if k:
                    parts = [p.split("=", 1) for p in k.split(",")]
                    lbl = "{" + ",".join(
                        f'{n}="{_esc(val)}"' for n, val in parts) + "}"
                if m["type"] == "histogram":
                    base = lbl[1:-1] if lbl else ""
                    for ub, c in v["buckets"].items():
                        sep = "," if base else ""
                        lines.append(
                            f'{name}_bucket{{{base}{sep}le="{ub}"}} {c}')
                    sep = "," if base else ""
                    lines.append(
                        f'{name}_bucket{{{base}{sep}le="+Inf"}} {v["count"]}')
                    lines.append(f"{name}_sum{lbl} {_num(v['sum'])}")
                    lines.append(f"{name}_count{lbl} {v['count']}")
                else:
                    lines.append(f"{name}{lbl} {_num(v)}")
        return "\n".join(lines) + "\n"

    def emit_jsonl(self, path: str, extra: dict | None = None) -> None:
        """Append one JSON line ``{"ts": epoch_s, "metrics": snapshot()}``
        (+``extra`` keys) — the scrape-less export for batch runs."""
        rec = {"ts": time.time(), "metrics": self.snapshot()}
        if extra:
            rec.update(extra)
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")


def family_percentile(fam: MetricFamily, p: float) -> float:
    """Percentile across ALL children of a labeled histogram family (e.g.
    TTFT over every priority class at once). Exact while every child's
    reservoir is complete; bucket-interpolated otherwise."""
    kids = list(fam.children.values())
    if not kids:
        return 0.0
    if len(kids) == 1:
        return kids[0].percentile(p)
    merged = Histogram(kids[0].buckets)
    for k in kids:
        merged.count += k.count
        merged.sum += k.sum
        for j, c in enumerate(k.bucket_counts):
            merged.bucket_counts[j] += c
        merged.raw.extend(k.raw)
    if len(merged.raw) != merged.count:
        merged.raw = []
    return merged.percentile(p)


def _esc(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _num(v) -> str:
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)
