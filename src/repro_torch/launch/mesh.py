"""The rank runtime of the dp×tp mesh: ``dp·tp`` processes joined by
``torch.distributed`` (the reference's ``make_local_mesh``, which asks JAX
for ``dp·tp`` devices of one process), and the mesh shapes
(``make_production_mesh``, ``make_local_mesh``: ``parallel.sharding.MeshShape``;
a shape's ``model`` axis is the pool's tp, every other axis together its dp).

:class:`RankPool` starts ``dp·tp - 1`` worker processes (the ``spawn``
start method) and makes the calling process rank 0. The ranks meet through
a ``file://`` rendezvous in a fresh temporary directory, so concurrent test
workers never race for a TCP port, and every rank creates every subgroup in
one order: the tp group of each dp row (ranks ``d·tp .. d·tp + tp - 1``),
then the dp group of each tp column. Rank ``d·tp + t`` sits at (d, t).

The backend and the device are the caller's, never switched on their own:

- ``nccl``: rank r on ``cuda:r``. Raises when the machine has fewer cards
  than ranks, naming ``gloo`` as the choice for ranks that share a card.
- ``gloo``: every rank on the one given device, the CPU or ``cuda:0``; the
  kernels run on the card in every rank, and the collectives copy through
  host memory.

A single controller drives the ranks: rank 0 (the serving ``Scheduler``
or the mesh ``Trainer``) broadcasts each op on a gloo control group, runs
it on its own shard, and gathers each rank's result. The ops: ``attach``
(each rank builds its ``RankEngine``: weights, caches, step), ``step`` (the
main or the fallback step), ``cow`` (copy-on-write page copies), the
Trainer's ``train_*`` ops (:meth:`_Rank.train_op`), ``counts`` /
``reset_counts`` (kernel counters), ``detach`` and ``stop``. Groups over
other sets of mesh axes (a pod mesh's) are made on first use, in one
order on every rank. A rank whose op raises prints
its traceback and exits; its peers' collectives then fail, rank 0 tears
the pool down and raises. Kernels are built in the parent before the
spawn: ranks only load the shared libraries.
"""

from __future__ import annotations

import atexit
import datetime
import math
import os
import shutil
import sys
import tempfile
import traceback

import torch

__all__ = ["RankPool", "rank_pool", "close_rank_pool", "make_production_mesh",
           "make_local_mesh", "pool_spec", "in_rank_pool"]

# a collective waits this long for its peers (the attach op includes each
# rank drawing its weights)
TIMEOUT = datetime.timedelta(seconds=600)


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production mesh as a shape: one pod (data=16,
    model=16), 256 ranks; two pods (pod=2, data=16, model=16), 512, the
    ``pod`` axis pure data parallelism. Starts no process."""
    from ..parallel.sharding import MeshShape

    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_local_mesh(data: int = 1, model: int = 1):
    """A (data, model) mesh shape of ``data·model`` ranks."""
    from ..parallel.sharding import MeshShape

    return MeshShape(("data", "model"), (int(data), int(model)))


def pool_spec(mesh):
    """The rank pool's (dp, tp) for a mesh shape: tp the ``model`` axis,
    dp every other axis together (rank r at ``mesh.coords(r)`` is the
    pool's (r // tp, r % tp))."""
    from ..parallel.serve_mesh import MeshSpec

    tp = mesh.shape.get("model", 1)
    return MeshSpec(mesh.size // tp, tp)


def _rank_device(backend: str, device: torch.device, rank: int) -> torch.device:
    return torch.device("cuda", rank) if backend == "nccl" else device


class _Rank:
    """One rank's membership: its process groups and its engine."""

    def __init__(self, rank: int, spec, backend: str, device: torch.device, init_file: str):
        import torch.distributed as tdist

        self.rank, self.spec, self.backend, self.device = rank, spec, backend, device
        self.world = spec.dp * spec.tp
        if device.type == "cuda":
            torch.cuda.set_device(device)
        tdist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                                 world_size=self.world, timeout=TIMEOUT)
        self.ctl = tdist.group.WORLD if backend == "gloo" else tdist.new_group(backend="gloo")
        tp_groups = [tdist.new_group(list(range(d * spec.tp, (d + 1) * spec.tp)))
                     for d in range(spec.dp)]
        dp_groups = [tdist.new_group(list(range(t, self.world, spec.tp)))
                     for t in range(spec.tp)]
        from ..parallel.serve_mesh import RankCoords

        d, t = divmod(rank, spec.tp)
        self.coords = RankCoords(d=d, t=t, dp_group=dp_groups[t], tp_group=tp_groups[d],
                                 world_group=tdist.group.WORLD,
                                 host_staged=backend == "gloo" and device.type == "cuda")
        self.engine = None
        self.eid = None
        self.trainer = None
        self.tid = None
        self._axis_groups: dict = {}
        self._dir = os.path.dirname(init_file)
        self._shm = None
        self._gids = 0

    def axis_group(self, mesh, axes: frozenset):
        """This rank's group over the mesh axes ``axes`` of ``mesh`` (rank r
        at ``mesh.coords(r)``): under gloo a ``host_shm.ShmGroup``; under
        nccl a process group (the pool's own tp, dp and world groups where
        they are it). Every group of a set of axes is made once, in one
        order on every rank."""
        from ..parallel.host_shm import ShmGroup
        from ..parallel.train_mesh import MODEL_AXIS

        axes = frozenset(axes)
        if self.backend == "gloo" and self._shm is None:
            # gloo ranks are one machine's: the training mesh's collectives
            # meet in shared host memory instead of gloo's TCP
            from ..parallel.host_shm import HostShm

            self._shm = HostShm(self._dir, self.rank, self.world)
        if self._shm is None:
            if axes == frozenset(mesh.axes):
                return torch.distributed.group.WORLD
            if axes == {MODEL_AXIS}:
                return self.coords.tp_group
            if axes == frozenset(mesh.axes) - {MODEL_AXIS}:
                return self.coords.dp_group
        key = (mesh, axes)
        if key not in self._axis_groups:
            others = [a for a in mesh.axes if a not in axes]
            mine = None
            for fixed in range(math.prod(mesh.shape[a] for a in others)):
                at = {}
                for a in reversed(others):
                    fixed, at[a] = divmod(fixed, mesh.shape[a])
                ranks = sorted(r for r in range(mesh.size)
                               if all(mesh.coords(r)[a] == at[a] for a in others))
                if self._shm is not None:
                    g = ShmGroup(self._shm, ranks, self._gids) if self.rank in ranks else None
                    self._gids += 1
                else:
                    g = torch.distributed.new_group(ranks)
                if self.rank in ranks:
                    mine = g
            self._axis_groups[key] = mine
        return self._axis_groups[key]

    # ------------------------------------------------------------- control
    def bcast(self, op=None):
        buf = [op]
        torch.distributed.broadcast_object_list(buf, src=0, group=self.ctl)
        return buf[0]

    def scatter(self, objs=None):
        out = [None]
        torch.distributed.scatter_object_list(out, objs, src=0, group=self.ctl)
        return out[0]

    def gather(self, obj):
        out = [None] * self.world if self.rank == 0 else None
        torch.distributed.gather_object(obj, out, dst=0, group=self.ctl)
        return out

    # ------------------------------------------------------------------ ops
    def dispatch(self, op, scattered=None):
        from ..kernels import ops

        kind = op[0]
        if kind == "attach":
            from ..parallel.serve_mesh import RankEngine

            _, eid, kw = op
            self.engine = None      # the previous engine's shards go before the next's come
            self.engine = RankEngine(source=scattered, coords=self.coords,
                                     device=self.device, **kw)
            self.eid = eid
            return True
        if kind in ("step", "cow", "detach"):
            if op[1] != self.eid:
                raise RuntimeError(f"rank {self.rank} holds engine {self.eid}, not {op[1]}")
            if kind == "step":
                return self.engine.run(*op[2:])
            if kind == "cow":
                self.engine.copy_pages(op[2])
                return None
            self.engine = self.eid = None
            return None
        if kind.startswith("train_"):
            return self.train_op(op, scattered)
        if kind == "counts":
            return ops.kernel_counts()
        if kind == "reset_counts":
            ops.reset_counts()
            return None
        raise ValueError(f"unknown mesh op {kind!r}")

    def train_op(self, op, source=None):
        """A mesh Trainer's ops: ``train_attach`` (build the rank's
        ``TrainEngine``: its state part and step), ``train_step``,
        ``train_parts`` (host copies of its parts), ``train_resident``,
        ``train_save``, ``train_load``, ``train_detach``."""
        kind, tid = op[0], op[1]
        if kind == "train_attach":
            from ..parallel.train_mesh import TrainEngine

            kw = op[2]
            self._drop_trainer()
            self.trainer = TrainEngine(
                rank=self.rank, source=source, device=self.device,
                group=lambda axes: self.axis_group(kw["mesh"], axes),
                ctl_barrier=lambda: torch.distributed.barrier(group=self.ctl), **kw)
            self.tid = tid
            return True
        if tid != self.tid:
            raise RuntimeError(f"rank {self.rank} holds train engine {self.tid}, not {tid}")
        eng = self.trainer
        if kind == "train_step":
            return eng.step(op[2])
        if kind == "train_parts":
            return eng.parts(op[2])
        if kind == "train_resident":
            return eng.resident()
        if kind == "train_save":
            return eng.save(*op[2:])
        if kind == "train_load":
            return eng.load(*op[2:])
        if kind == "train_detach":
            self._drop_trainer()
            return None
        raise ValueError(f"unknown mesh op {kind!r}")

    def _drop_trainer(self) -> None:
        """Free the train engine's state and hand its cached device memory
        back, so that another process on a shared card can use it."""
        import gc

        self.trainer = self.tid = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def _worker(rank, spec, backend, device, init_file, threads):
    """A worker rank: join, then run rank 0's ops until ``stop``."""
    try:
        torch.set_num_threads(threads)
        _IN_POOL.append(True)
        me = _Rank(rank, spec, backend, device, init_file)
        while True:
            op = me.bcast()
            if op[0] == "stop":
                break
            scattered = me.scatter() if op[0] in ("attach", "train_attach") else None
            me.gather(me.dispatch(op, scattered))
        torch.distributed.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


def _rank0_device(spec, backend: str, device) -> torch.device:
    """Rank 0's device, after refusing a backend the machine cannot give:
    nccl wants a card a rank."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"mesh backend {backend!r}: name one, 'nccl' (one rank a card) or "
                         "'gloo' (every rank on one device: the CPU, or one shared card)")
    dev = torch.device(device)
    world = spec.dp * spec.tp
    if backend == "nccl":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if dev.type != "cuda" or n < world:
            raise ValueError(
                f"backend 'nccl' puts rank r on cuda:r and needs {world} cards; this machine "
                f"has {n}. Use backend='gloo' to run the ranks on one device (the CPU, or one "
                "shared card)")
    return torch.device("cuda", dev.index or 0) if dev.type == "cuda" else dev


class RankPool:
    """``dp·tp`` ranks of one serving mesh, the calling process rank 0."""

    def __init__(self, spec, *, backend: str, device):
        self.device = _rank0_device(spec, backend, device)
        self.spec, self.backend = spec, backend
        self.world = spec.dp * spec.tp
        if self.device.type == "cuda":
            from ..kernels import build

            build.build()           # ranks only load the libraries
        self._dir = tempfile.mkdtemp(prefix="repro_torch_mesh_")
        init_file = os.path.join(self._dir, "rendezvous")
        threads = max(1, (os.cpu_count() or 1) // self.world)
        ctx = torch.multiprocessing.get_context("spawn")
        self.procs = [ctx.Process(target=_worker, daemon=True, args=(
            r, spec, backend, _rank_device(backend, self.device, r), init_file, threads))
            for r in range(1, self.world)]
        for p in self.procs:
            p.start()
        self._eid = 0
        self.closed = False
        try:
            self.me = _Rank(0, spec, backend, self.device, init_file)
        except BaseException:
            self.abort()
            raise

    # ---------------------------------------------------------------- calls
    def call(self, op, scatter=None) -> list:
        """Run ``op`` on every rank; returns each rank's result, by rank.
        ``scatter`` (attach only) gives each rank its own object."""
        if self.closed:
            raise RuntimeError("the mesh's rank pool is closed")
        if op[0] in ("step", "cow", "detach") and op[1] != self.me.eid:
            raise RuntimeError(f"the ranks now hold engine {self.me.eid}, not {op[1]}: a newer "
                               "mesh Scheduler replaced this one")
        if op[0].startswith("train_") and op[0] != "train_attach" and op[1] != self.me.tid:
            raise RuntimeError(f"the ranks now hold train engine {self.me.tid}, not {op[1]}: "
                               "a newer mesh Trainer replaced this one")
        try:
            self.me.bcast(op)
            mine = self.me.scatter(scatter) if scatter is not None else None
            return self.me.gather(self.me.dispatch(op, mine))
        except BaseException:
            self.abort()
            raise

    @property
    def engine(self):
        """Rank 0's ``RankEngine`` (the one the Scheduler reads)."""
        return self.me.engine

    def attach(self, sources: list, **kw) -> int:
        """Build one Scheduler's engine on every rank (replacing the one
        before); ``sources[r]`` gives rank r its weights. Returns the
        engine's id, which every later op of that Scheduler names."""
        self._eid += 1
        self.call(("attach", self._eid, kw), scatter=sources)
        return self._eid

    def attach_train(self, sources: list, **kw) -> int:
        """Build a mesh Trainer's engine on every rank (replacing the one
        before); ``sources[r]`` gives rank r its parameters. Returns the
        engine's id, which every later train op names."""
        self._eid += 1
        self.call(("train_attach", self._eid, kw), scatter=sources)
        return self._eid

    def counts(self) -> list:
        """``ops.kernel_counts()`` of every rank, by rank."""
        return self.call(("counts",))

    def reset_counts(self) -> None:
        self.call(("reset_counts",))

    # -------------------------------------------------------------- teardown
    def close(self) -> None:
        """Stop every rank and leave the process group."""
        if self.closed:
            return
        try:
            self.me.bcast(("stop",))
        except BaseException:
            pass
        for p in self.procs:
            p.join(timeout=30)
        self.abort()

    def abort(self) -> None:
        """Kill the workers and leave the process group, whatever state the
        ranks are in."""
        self.closed = True
        for p in self.procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        shutil.rmtree(self._dir, ignore_errors=True)


_POOL: list[RankPool] = []
_IN_POOL: list[bool] = []


def in_rank_pool() -> bool:
    """Whether this process is a rank of a running pool (its controller or
    a worker)."""
    return bool(_IN_POOL) or any(not p.closed for p in _POOL)


def rank_pool(spec, *, backend: str, device) -> RankPool:
    """The process's rank pool for ``spec`` on ``backend`` / ``device``:
    the running one when it matches, else a new one (the old one closed)."""
    dev = _rank0_device(spec, backend, device)
    if _POOL:
        p = _POOL[0]
        if not p.closed and (p.spec, p.backend, p.device) == (spec, backend, dev):
            return p
        close_rank_pool()
    _POOL.append(RankPool(spec, backend=backend, device=dev))
    return _POOL[0]


def close_rank_pool() -> None:
    """Stop the process's rank pool, if one runs."""
    while _POOL:
        _POOL.pop().close()


atexit.register(close_rank_pool)

