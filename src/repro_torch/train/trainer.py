"""Fault-tolerant training loop (the reference's ``repro/train/trainer.py``).

- **checkpoint/restart**: async snapshots every ``ckpt_every`` steps; on
  construction the trainer resumes from the latest valid checkpoint in
  ``ckpt_dir`` (a crashed run loses at most ``ckpt_every`` steps).
- **straggler mitigation**: ``StepClock`` tracks step latency; a step
  slower than ``factor`` × the running median is counted and logged.
- **failure injection**: ``fail_at_step`` raises ``InjectedFailure`` after
  that step's update and before its checkpoint, to exercise the resume.

On the card each batch is copied from pinned host memory on a side stream
(the next step's batch while the current step runs), and reading the
step's metrics is the one host sync a step.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import resolve_device
from ..configs.base import ModelConfig, RunConfig
from ..models import init
from ..tree import leaves
from . import checkpoint as ckpt
from .train_step import build_train_step, init_train_state

__all__ = ["Trainer", "StepClock", "InjectedFailure"]


class InjectedFailure(RuntimeError):
    pass


@dataclass
class StepClock:
    """Straggler watchdog: running latency stats + slow-step detection."""

    factor: float = 3.0
    times: list = field(default_factory=list)
    stragglers: int = 0

    def record(self, dt: float) -> bool:
        self.times.append(dt)
        hist = self.times[-100:]
        med = float(np.median(hist)) if len(hist) >= 5 else None
        slow = med is not None and dt > self.factor * med
        self.stragglers += int(slow)
        return slow

    def summary(self) -> dict:
        arr = np.array(self.times[-200:] or [0.0])
        return {
            "p50_ms": float(np.percentile(arr, 50) * 1e3),
            "p99_ms": float(np.percentile(arr, 99) * 1e3),
            "stragglers": self.stragglers,
        }


class Trainer:
    """``params``: a parameter tree to start from (e.g. the reference's
    weights carried across by ``interop.params_from_reference``), used
    as given; else ``init`` draws them from ``seed``. A checkpoint in
    ``ckpt_dir`` overrides either."""

    def __init__(
        self,
        cfg: ModelConfig,
        rc: RunConfig,
        *,
        ckpt_dir: str | None = None,
        ckpt_every: int = 50,
        seed: int = 0,
        fail_at_step: int | None = None,
        log_every: int = 10,
        log_fn=print,
        params: dict | None = None,
        device=None,
    ):
        self.cfg, self.rc = cfg, rc
        self.device = resolve_device(device)
        self.ckpt_dir, self.ckpt_every = ckpt_dir, ckpt_every
        self.fail_at_step = fail_at_step
        self.log_every, self.log = log_every, log_fn
        self.clock = StepClock()
        self.saver = ckpt.AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
        self._step_fn = build_train_step(cfg, rc)
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

        if params is None:
            params = init(cfg, rc, torch.Generator().manual_seed(seed), device=self.device)
        self.state = init_train_state(cfg, rc, params)
        self.step = 0
        if ckpt_dir and (last := ckpt.latest_step(ckpt_dir)) is not None:
            restored, manifest = ckpt.restore(ckpt_dir, last, self.state)
            self._load(restored)
            self.step = manifest["step"]
            self.log(f"[trainer] resumed from step {self.step}")
        self.history: list[dict] = []

    @torch.no_grad()
    def _load(self, restored: dict) -> None:
        """Copy a restored state into the live one (the parameters stay the
        same leaf tensors)."""
        for dst, src in zip(leaves(self.state), leaves(restored)):
            dst.copy_(src)

    def _upload(self, batch: dict) -> tuple:
        """(the batch on the trainer's device, the event its copy ends with):
        on the card, copied from pinned memory on the side stream."""
        if self._stream is None:
            return {n: t.to(self.device) for n, t in batch.items()}, None
        with torch.cuda.stream(self._stream):
            out = {n: t.pin_memory().to(self.device, non_blocking=True)
                   for n, t in batch.items()}
        return out, self._stream.record_event()

    def _ready(self, batch: dict, copied) -> dict:
        """``batch`` once the compute stream has waited for its copy."""
        if copied is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(copied)
            for t in batch.values():
                t.record_stream(stream)
        return batch

    def run(self, batches, num_steps: int) -> list[dict]:
        """Train ``num_steps`` more steps from iterator ``batches``."""
        end = self.step + num_steps
        nxt = self._upload(next(batches)) if self.step < end else None
        while self.step < end:
            batch = self._ready(*nxt)
            t0 = time.perf_counter()
            self.state, metrics = self._step_fn(self.state, batch)
            # the next batch's copy overlaps this step's device work
            nxt = self._upload(next(batches)) if self.step + 1 < end else None
            keys = sorted(metrics)
            vals = torch.stack([metrics[k].to(torch.float32).reshape(()) for k in keys]).tolist()
            dt = time.perf_counter() - t0
            self.step += 1
            slow = self.clock.record(dt)
            if slow:
                self.log(f"[watchdog] straggler step {self.step}: {dt*1e3:.0f} ms "
                         f"(median {np.median(self.clock.times[-100:])*1e3:.0f} ms)")
            row = dict(zip(keys, vals))
            row.update(step=self.step, ms=dt * 1e3)
            self.history.append(row)
            if self.step % self.log_every == 0:
                self.log(
                    f"[train] step {self.step} loss {row['loss']:.4f} "
                    f"lr {row['lr']:.2e} gnorm {row['grad_norm']:.2f} {dt*1e3:.0f} ms"
                )

            if self.fail_at_step is not None and self.step == self.fail_at_step:
                raise InjectedFailure(f"injected failure at step {self.step}")

            if self.saver and self.step % self.ckpt_every == 0:
                self.saver.save_async(self.step, self.state)
        if self.saver:
            self.saver.save_async(self.step, self.state)
            self.saver.wait()
        return self.history
