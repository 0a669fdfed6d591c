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

**On a dp×tp mesh** (``mesh=``: a ``MeshShape``, ``(data, model)`` or
``"data,model"``; ``mesh_backend`` ``nccl`` or ``gloo``, no default) the
Trainer is rank 0 of a pool of processes (``launch/mesh.py``), each holding
its part of the train state and running the sharded step
(``parallel/train_mesh.py``); rank 0 sends every op: attach, step, save,
load, and the state's parts for :meth:`gather_state`. ``state`` is then
None. Checkpoints keep the one-process layout (every leaf whole, logical
metadata only): a mesh Trainer's restores into a one-process Trainer bit
for bit and the other way round, whatever the two meshes. Saves are
synchronous. The watchdog, ``fail_at_step`` and the resume behave as
without a mesh.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import resolve_device
from ..configs.base import ModelConfig, RunConfig
from ..models import init
from ..tree import leaves, leaves_with_paths
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
    as given (on a mesh: cut into the ranks' parts); else ``init`` draws
    them from ``seed``, on a mesh with a generator on ``init_generator``
    (``cpu``, or ``cuda``: each rank's card). A checkpoint in ``ckpt_dir``
    overrides either."""

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
        mesh=None,
        mesh_backend: str | None = None,
        init_generator: str = "cpu",
    ):
        self.cfg, self.rc = cfg, rc
        self.device = resolve_device(device)
        self.ckpt_dir, self.ckpt_every = ckpt_dir, ckpt_every
        self.fail_at_step = fail_at_step
        self.log_every, self.log = log_every, log_fn
        self.clock = StepClock()
        self.history: list[dict] = []
        self.mesh = None
        self.step = 0
        if mesh is not None:
            self._attach_mesh(mesh, mesh_backend, params, seed, init_generator)
            return
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

    # ------------------------------------------------------------------ mesh
    def _attach_mesh(self, mesh, backend, params, seed: int, generator: str) -> None:
        """Start (or reuse) the rank pool and build every rank's engine:
        its parameters from ``params`` (the full tree, cut here) or drawn by
        each rank (``InitParts``), then the resume."""
        from ..launch.mesh import make_local_mesh, pool_spec, rank_pool
        from ..parallel import train_mesh as tm
        from ..parallel.sharding import MeshShape, use_mesh
        from ..parallel.state_sharding import abstract_train_state, shard_tree, train_state_specs

        if not isinstance(mesh, MeshShape):
            dm = [int(v) for v in mesh.split(",")] if isinstance(mesh, str) else list(mesh)
            mesh = make_local_mesh(*dm)
        tm.validate(self.cfg, self.rc, mesh)
        self.mesh = mesh
        self.state = None
        self._pool = rank_pool(pool_spec(mesh), backend=backend, device=self.device)
        if params is None:
            sources = [tm.InitParts(seed, generator)] * mesh.size
        else:
            with use_mesh(mesh, overrides=self.rc.sharding_overrides):
                specs = train_state_specs(self.cfg, self.rc, abstract_train_state(self.cfg, self.rc))
            pspecs = {n[len("params/"):]: sp for n, sp in specs.items() if n.startswith("params/")}
            sources = [tm.GivenParts(shard_tree(pspecs, params, mesh.coords(r), mesh))
                       for r in range(mesh.size)]
        self._tid = self._pool.attach_train(sources, cfg=self.cfg, rc=self.rc, mesh=mesh)
        self.engine = self._pool.me.trainer
        if self.ckpt_dir and (last := ckpt.latest_step(self.ckpt_dir)) is not None:
            self.step = self._pool.call(("train_load", self._tid, self.ckpt_dir, last))[0]
            self.log(f"[trainer] resumed from step {self.step}")

    def _mesh_call(self, kind: str, *args) -> list:
        return self._pool.call((kind, self._tid, *args))

    def gather_state(self, prefix: str = "") -> dict:
        """The full train state (or its leaves under ``prefix``, e.g.
        ``"params"``) put together from every rank's parts, on the host:
        {leaf path: tensor}. Without a mesh, the live state's leaves."""
        if self.mesh is None:
            return {n: t.detach() for n, t in leaves_with_paths(self.state) if n.startswith(prefix)}
        from ..parallel.state_sharding import gather_tree

        parts = self._mesh_call("train_parts", prefix)
        return gather_tree(self.engine.specs, parts, self.mesh)

    def resident_bytes(self) -> list:
        """Every rank's {"state_bytes", "share_bytes"} (mesh only)."""
        return self._mesh_call("train_resident")

    def _save(self) -> None:
        if self.mesh is not None:
            self._mesh_call("train_save", self.ckpt_dir, self.step)
        else:
            self.saver.save_async(self.step, self.state)

    def _record(self, row: dict, dt: float) -> None:
        """The watchdog, the history and the log line of one step."""
        self.step += 1
        slow = self.clock.record(dt)
        if slow:
            self.log(f"[watchdog] straggler step {self.step}: {dt*1e3:.0f} ms "
                     f"(median {np.median(self.clock.times[-100:])*1e3:.0f} ms)")
        row.update(step=self.step, ms=dt * 1e3)
        self.history.append(row)
        if self.step % self.log_every == 0:
            self.log(
                f"[train] step {self.step} loss {row['loss']:.4f} "
                f"lr {row['lr']:.2e} gnorm {row['grad_norm']:.2f} {dt*1e3:.0f} ms"
            )

    def _after_step(self) -> None:
        if self.fail_at_step is not None and self.step == self.fail_at_step:
            raise InjectedFailure(f"injected failure at step {self.step}")
        if self.ckpt_dir and self.step % self.ckpt_every == 0:
            self._save()

    def _run_mesh(self, batches, num_steps: int) -> list[dict]:
        end = self.step + num_steps
        self.rank_steps: list = []     # a step's {"meter", "laps", "seconds"} by rank
        while self.step < end:
            batch = {n: t.cpu() for n, t in next(batches).items()}
            t0 = time.perf_counter()
            out = self._mesh_call("train_step", batch)
            dt = time.perf_counter() - t0
            self.rank_steps.append([{k: o[k] for k in ("meter", "laps", "seconds")}
                                    for o in out])
            self._record(dict(out[0]["metrics"]), dt)
            self._after_step()
        if self.ckpt_dir and self.step % self.ckpt_every:
            self._save()
        return self.history

    def close(self) -> None:
        """Drop every rank's part of a mesh Trainer's state (the pool keeps
        running for the next Trainer or Scheduler)."""
        if self.mesh is not None and not self._pool.closed:
            self.engine = None
            self._mesh_call("train_detach")

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
        if self.mesh is not None:
            return self._run_mesh(batches, num_steps)
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
            self._record(dict(zip(keys, vals)), time.perf_counter() - t0)
            self._after_step()
        if self.saver:
            self.saver.save_async(self.step, self.state)
            self.saver.wait()
        return self.history
