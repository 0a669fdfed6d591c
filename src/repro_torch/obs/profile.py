"""Profiler hooks for the serving step: ``torch.profiler`` ranges (and NVTX
ranges on the card) around the mixed step, plus an optional
``torch.profiler`` device trace (the PyTorch counterpart of the reference's
``repro/obs/profile.py``, which annotates with ``jax.named_scope`` and
traces with ``jax.profiler``; DESIGN.md §14).

The host tracer (obs/trace.py) records *when* the scheduler ran a step;
these ranges make the *device* side legible: a profile captured with
:func:`device_trace` lines the step's kernels up under stable names.

Scope taxonomy::

    serve/step          the scheduler's ONE mixed prefill+decode step
    serve/fallback      the quarantined-row bf16 fallback step
    serve/logits        the lm-head projection inside either of the above

A range costs one ``record_function`` enter/exit on the host (and one NVTX
push/pop when the step runs on the card); it changes no number the step
computes. On the CPU no NVTX call is made.

:func:`device_trace` wraps a block in ``torch.profiler.profile`` and writes
a Chrome trace into its ``logdir``. If the profiler cannot start it warns
once and the block runs unprofiled, so serving never dies of profiling; it
yields the path it will write, or None when nothing is being profiled.
"""

from __future__ import annotations

import logging
import os
from contextlib import contextmanager

import torch

__all__ = ["named_scope", "current_scope", "device_trace", "TRACE_FILE"]

log = logging.getLogger("repro_torch.obs")

TRACE_FILE = "device_trace.json"

_warned = False
_SCOPES: list[str] = []


def current_scope() -> str:
    """The innermost open :func:`named_scope`'s name ("" outside any): the
    label ``roofline.op_cost`` charges an op to."""
    return _SCOPES[-1] if _SCOPES else ""


@contextmanager
def named_scope(name: str, *, cuda: bool = False):
    """A ``torch.profiler.record_function(name)`` range; with ``cuda`` (the
    step's tensors live on the card) also an NVTX range of the same name."""
    _SCOPES.append(name)
    try:
        with torch.profiler.record_function(name):
            if not cuda:
                yield
                return
            torch.cuda.nvtx.range_push(name)
            try:
                yield
            finally:
                torch.cuda.nvtx.range_pop()
    finally:
        _SCOPES.pop()


@contextmanager
def device_trace(logdir: str | None):
    """Profile the block (CPU activity, and CUDA activity where a card is
    present) and export a Chrome trace to ``logdir/device_trace.json``.
    Yields that path, or None when ``logdir`` is empty or the profiler did
    not start (then one warning, and the block runs unprofiled)."""
    global _warned
    if not logdir:
        yield None
        return
    prof = None
    try:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    except Exception as e:  # noqa: BLE001 - profiling must never kill serving
        prof = None
        if not _warned:
            _warned = True
            log.warning("obs: torch.profiler unavailable (%r) — device trace "
                        "disabled, host tracing unaffected", e)
    path = os.path.join(logdir, TRACE_FILE) if prof is not None else None
    try:
        yield path
    finally:
        if prof is not None:
            try:
                prof.stop()
                os.makedirs(logdir, exist_ok=True)
                prof.export_chrome_trace(path)
            except Exception as e:  # noqa: BLE001
                log.warning("obs: torch.profiler export failed: %r", e)
