"""CUDA graphs of the serving steps (the reference compiles its mixed,
verify and draft steps with ``jax.jit``: ``repro/serve/scheduler.py``,
``repro/serve/spec.py``).

A :class:`StepGraphs` runs one step function (``build_mixed_step``'s) at
any width and keeps one graph a width, as ``jax.jit`` keeps one executable
a shape:

- **Static inputs.** A width has one int32 device buffer holding the step's
  tokens (B, W), positions (B,), lengths (B,) and block tables (B, MB).
  A call's host arrays are written into a pinned staging buffer and copied
  to the device in one copy; a device tensor (the verify step's tokens, the
  draft loop's candidates) goes in with ``copy_``. An eager runner
  (``backend=None``) stages its inputs the same way.
- **Warm, then capture.** The first call at a width runs the step eagerly
  on those buffers: it is the real step, and it warms what a capture must
  not do (the kernels' function attributes, ``sm_count``, the libraries'
  handles, the allocator). It must hand back the caches it was given,
  updated in place: a graph replays into the caches of its capture, so a
  step that returns new cache tensors raises here. The second call
  captures the step under ``torch.cuda.graph`` (nothing runs, so no KV
  page is written) and replays it; every later call replays.
- **Outputs.** The graphs of one Scheduler share one memory pool. A graph
  captured later may hold its outputs where an earlier one keeps its
  temporaries, so a graph's logits last until the next replay of any graph
  of the pool: a caller reads them (or takes what it needs of them) before
  it calls another step. Its totals are copied on every replay and last.
- **Stats.** Under ``track_energy`` the captured region also reduces the
  step's stats capture to one small int64 tensor (``quant.capture.
  stack_totals``); a replay costs one device copy and one host copy for its
  cycles. The eager path makes the same reduction.
- **Kernel counters.** ``kernels/ops.py`` counts in Python, so a replay
  would move no counter: a graph keeps the counter delta of its capture,
  takes it back out (nothing ran) and adds it again on every replay. These
  credited counts are held against the kernels the profiler sees the
  replays run (``chip_smoke.py``'s ``serve_traced``, the card tests).
  :meth:`StepGraphs.counts` counts eager calls and replays a width.
- **No fallback.** A capture or replay error raises; a step whose caches
  moved since its capture raises.

What stays eager: the fallback-policy step, the copy-on-write page copies,
the mesh ranks' steps (their collectives meet on the host between layers),
the legacy Engine and the Trainer. A replay has no host profiler ranges
(``serve/step`` ...): a per-scope device breakdown needs the eager step.

:class:`RerunGraph` stands in for the CUDA graph in the CPU tests only: its
capture runs the step on a copy of the caches, its replay reruns the step
on the caches with the counters held still and copies the results into the
captured outputs. No serving path builds one.
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..kernels import ops as _kops
from ..quant.capture import StepTotals
from ..tree import leaves, tree_map

__all__ = ["CudaGraph", "RerunGraph", "StepGraphs", "StepInputs", "resolve_graphs", "upload"]


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A copy of host array ``a`` as a tensor on ``device``: later writes to
    ``a`` do not reach it. To a card it goes through pinned memory without
    waiting for the stream, so a tick queues its inputs behind work already
    on the card."""
    t = torch.from_numpy(np.array(a))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def resolve_graphs(graphs: bool | None, device: torch.device, mesh) -> bool:
    """Whether a Scheduler replays graphs: ``None`` means on a CUDA device
    without a mesh; ``True`` elsewhere raises."""
    on_card = device.type == "cuda" and mesh is None
    if graphs is None:
        return on_card
    if graphs and not on_card:
        raise ValueError(
            "graphs=True needs a CUDA device and no mesh: a CUDA graph replays card "
            "work, and a mesh rank's collectives meet on the host between layers")
    return bool(graphs)


@dataclass
class StepInputs:
    """A step's device inputs: tokens (B, W), pos (B,), lens (B,), tables
    (B, MB) or None (the dense layout)."""

    tokens: torch.Tensor
    pos: torch.Tensor
    lens: torch.Tensor
    tables: torch.Tensor | None


class CudaGraph:
    """One ``torch.cuda.CUDAGraph`` in a shared memory pool."""

    def __init__(self, pool):
        self.pool = pool
        self.graph = torch.cuda.CUDAGraph()

    def capture(self, fn, caches):
        with torch.cuda.graph(self.graph, pool=self.pool):
            return fn(caches)

    def replay(self) -> None:
        self.graph.replay()


class RerunGraph:
    """The CPU tests' stand-in for :class:`CudaGraph` (see the module
    docstring): the bookkeeping around a graph, with the step rerun."""

    def __init__(self, pool):
        self.fn = self.caches = self.outs = None

    def capture(self, fn, caches):
        self.fn, self.caches = fn, caches
        self.outs = fn(tree_map(lambda t: t.clone(), caches))
        return self.outs

    def replay(self) -> None:
        base = _kops.kernel_counters()
        outs = self.fn(self.caches)
        _kops.add_counters(_kops.kernel_counters_since(base), -1)
        for got, out in zip(outs, self.outs):
            if got is not None:
                out.copy_(got)


@dataclass
class _Width:
    """One width's static buffers, staging slots, graph and counts."""

    inputs: StepInputs
    buf: torch.Tensor                       # the inputs' one device buffer
    stage: list                             # [(pinned host buffer, its numpy view, event)]
    graph: object = None
    outs: tuple = ()                        # (logits, totals values) of the capture
    layout: object = None
    delta: dict = field(default_factory=dict)
    ptrs: tuple = ()                        # the caches' storage at capture
    eager: int = 0
    replays: int = 0
    capture_ms: float = 0.0
    pool_bytes: int = 0


class StepGraphs:
    """A step function ``step(params, caches, tokens, pos, lens, tables)
    -> (caches, logits[, capture])`` run eagerly (``backend=None``) or
    through one graph a width (``backend``: :class:`CudaGraph`, or
    :class:`RerunGraph` in the CPU tests), its inputs staged into one set of
    buffers a width either way. ``rows`` is the step's batch (max_batch)
    and ``table_width`` the block tables' width (None: the dense layout)."""

    def __init__(self, step, *, name: str, device: torch.device, rows: int,
                 table_width: int | None, backend=None, pool=None):
        self.step, self.name, self.device = step, name, device
        self.rows, self.table_width = rows, table_width
        self.backend, self.pool = backend, pool
        self._widths: dict[int, _Width] = {}

    # ------------------------------------------------------------- inputs
    def _width(self, W: int) -> _Width:
        w = self._widths.get(W)
        if w is not None:
            return w
        B, MB = self.rows, self.table_width or 0
        sizes = (B * W, B, B, B * MB)
        buf = torch.zeros(sum(sizes), dtype=torch.int32, device=self.device)
        offs = np.cumsum((0,) + sizes)
        tokens, pos, lens, tables = (buf[offs[i]:offs[i + 1]] for i in range(4))
        inputs = StepInputs(tokens.view(B, W), pos, lens,
                            tables.view(B, MB) if self.table_width is not None else None)
        w = self._widths[W] = _Width(inputs, buf, [])
        return w

    def _slot(self, w: _Width):
        """A pinned staging buffer of width ``w`` whose last copy to the
        card has run (a new one when every buffer's copy is still queued:
        the draft loop stages one width several times a tick, and staging
        never waits for the card)."""
        for slot in w.stage:
            if slot[2] is None or slot[2].query():
                return slot
        cuda = self.device.type == "cuda"
        host = torch.zeros(w.buf.numel(), dtype=torch.int32, pin_memory=cuda)
        w.stage.append((host, host.numpy(), torch.cuda.Event() if cuda else None))
        return w.stage[-1]

    def _stage(self, tokens, pos, lens, tables) -> _Width:
        """The width of a call whose inputs (numpy arrays or device tensors)
        were written into its static buffers: host arrays in one copy from
        pinned memory, tensors with ``copy_``, queued behind the stream's
        work."""
        args = (tokens, pos, lens, tables)
        if (tables is None) != (self.table_width is None):
            raise ValueError(f"{self.name} step: tables given iff the layout is paged")
        w = self._width(int(tokens.shape[1]))
        dst = (w.inputs.tokens, w.inputs.pos, w.inputs.lens, w.inputs.tables)
        if any(isinstance(a, np.ndarray) for a in args):
            host, view, ev = self._slot(w)
            at = 0
            for a, d in zip(args, dst):
                if d is None:
                    continue
                if isinstance(a, np.ndarray):
                    view[at: at + d.numel()].reshape(d.shape)[...] = a
                at += d.numel()
            w.buf.copy_(host, non_blocking=True)
            if ev is not None:
                ev.record()
        for a, d in zip(args, dst):
            if isinstance(a, torch.Tensor):
                d.copy_(a)
        return w

    # ---------------------------------------------------------------- run
    def _eager(self, params, caches, x: StepInputs):
        out = self.step(params, caches, x.tokens, x.pos, x.lens, x.tables)
        return out[0], out[1], (StepTotals.of(out[2]) if len(out) > 2 else None)

    def __call__(self, params, caches, tokens, pos, lens, tables):
        """(caches, logits, StepTotals or None) of one step; the inputs are
        numpy arrays or device tensors. A graph's logits are its static
        output (see the module docstring); its totals are a copy."""
        w = self._stage(tokens, pos, lens, tables)
        if self.backend is None or w.eager == 0:
            w.eager += 1
            out = self._eager(params, caches, w.inputs)
            if self.backend is not None and _storage(out[0]) != _storage(caches):
                raise RuntimeError(f"{self.name} step: it returned new cache tensors, and a "
                                   "graph replays only into the caches it was captured on")
            return out
        if w.graph is None:
            self._capture(w, params, caches)
        elif _storage(caches) != w.ptrs:
            raise RuntimeError(f"{self.name} step: the caches moved since the graph of "
                               f"width {w.inputs.tokens.shape[1]} was captured")
        w.graph.replay()
        _kops.add_counters(w.delta)
        w.replays += 1
        logits, totals = w.outs
        return caches, logits, (None if w.layout is None
                                else StepTotals(totals.clone(), w.layout))

    def _capture(self, w: _Width, params, caches) -> None:
        x = w.inputs
        cuda = self.device.type == "cuda"

        def fn(c):
            out = self.step(params, c, x.tokens, x.pos, x.lens, x.tables)
            if len(out) == 2:
                return out[1], None
            totals = StepTotals.of(out[2])
            if w.layout is not None and totals.layout != w.layout:
                raise RuntimeError(f"{self.name} step: its stats layout changed")
            w.layout = totals.layout
            return out[1], totals.values

        if cuda:
            torch.cuda.synchronize(self.device)
            gc.collect()
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(self.device)
        base = _kops.kernel_counters()
        t0 = time.perf_counter()
        graph = self.backend(self.pool)
        try:
            w.outs = graph.capture(fn, caches)
        except Exception as e:
            _kops.add_counters(_kops.kernel_counters_since(base), -1)
            raise RuntimeError(f"capturing the {self.name} step's graph at width "
                               f"{x.tokens.shape[1]} failed: {e}") from e
        w.delta = _kops.kernel_counters_since(base)
        _kops.add_counters(w.delta, -1)
        w.capture_ms = (time.perf_counter() - t0) * 1e3
        if cuda:
            w.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        w.graph, w.ptrs = graph, _storage(caches)

    # --------------------------------------------------------------- counts
    def counts(self) -> dict:
        """{width: {"eager": calls, "replays": n, "capture_ms": ms,
        "pool_bytes": bytes the capture reserved}}; eager-only widths carry
        their calls alone."""
        out = {}
        for W, w in self._widths.items():
            out[W] = {"eager": w.eager, "replays": w.replays}
            if w.graph is not None:
                out[W].update(capture_ms=w.capture_ms, pool_bytes=w.pool_bytes)
        return dict(sorted(out.items()))


def _storage(caches) -> tuple:
    """The caches' storage addresses (a graph replays on them)."""
    return tuple(t.data_ptr() for t in leaves(caches))
