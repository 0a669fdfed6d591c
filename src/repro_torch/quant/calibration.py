"""Static PTQ calibration: per-GEMM activation scales (absmax observers).

The paper profiles a *statically* quantized INT8 network (fixed scales,
calibrated once) — with dynamic per-tensor quantization every tensor's max
|q| is 127 by construction and Fig 5's statistic degenerates. Usage:

    with calibrating() as reg:                    # pass 1: observe absmax
        forward(cfg, rc, params, batch_calib)
    with static_scales(reg):                      # pass 2+: fixed scales
        with collecting() as col:                 # Fig 5 statistics
            forward(cfg, rc, params, batch_eval)

Scales are keyed by the GEMM ``name``: every layer of one kind shares a
name and therefore a scale (per-op-type calibration, the reference's
granularity under its scan over layers). An expert stack (x (E, M, K)) is
observed as one tensor: its absmax over every expert, as the reference's
vmapped observer folds one callback an expert into the same running max.

The state is module-global, as in the reference. The port runs eagerly on
one thread, so :func:`observe` reads ``|x|.max()`` on the host at once: one
device sync per quantized GEMM, only while a :func:`calibrating` context is
active.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

__all__ = ["Observer", "calibrating", "static_scales", "active_observer", "active_scales",
           "observe"]


_observer = None
_scales = None


class Observer(dict):
    """name -> running absmax (float)."""

    def update_absmax(self, name: str, amax: float):
        self[name] = max(self.get(name, 0.0), float(amax))


def active_observer() -> Observer | None:
    return _observer


def active_scales() -> dict | None:
    return _scales


@contextmanager
def calibrating():
    """Observe every quantized GEMM's activation absmax inside the block;
    yields the :class:`Observer` (the registry). Restores the enclosing
    observer on exit, exceptions included."""
    global _observer
    prev, _observer = _observer, Observer()
    try:
        yield _observer
    finally:
        _observer = prev


@contextmanager
def static_scales(reg: dict):
    """Run every GEMM named in ``reg`` on the fixed activation scale
    ``reg[name] / hi`` (per tensor, overriding ``act_scale="token"``); other
    GEMMs stay dynamic. Restores the enclosing scales on exit."""
    global _scales
    prev, _scales = _scales, dict(reg)
    try:
        yield
    finally:
        _scales = prev


def observe(name: str, x: torch.Tensor):
    """Fold max |x| into the active observer (no-op without one)."""
    obs = active_observer()
    if obs is not None:
        obs.update_absmax(name, float(x.abs().amax()))
