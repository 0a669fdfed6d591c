"""The sharded train step of a dp×tp mesh: what one rank holds and runs
(the reference lays its train state out by ``parallel/state_sharding.py``
and leaves the step to XLA's partitioner; here each rank issues its own
collectives on ``torch.distributed``).

**Storage.** Between steps a rank holds only its part of the train state,
as ``train_state_specs`` gives it under ``DEFAULT_RULES`` and
``rc.sharding_overrides``: parameters, AdamW's master weights and moments
(the int8 moments' ``q`` and ``s`` leaves too) and the EF residuals cut
on ``embed`` over ``data`` (FSDP) and on heads / mlp / vocab / experts over
``model``. A rank draws its parameters with ``models.init(..., keep=)``,
keeping its part of each leaf as it is drawn; it never holds the whole
tree.

**Compute** (Megatron's cut). The batch splits over the data axes: rank
(d, ·) takes rows ``[d·B/dp, (d+1)·B/dp)`` as ``batch_specs`` says. The
``model`` ranks of a row split every GEMM whose weight is sharded on
``model``: q / k / v, gate / up and MLA's q and absorbed ``w_uk`` / ``w_uv``
are column-parallel on the rank's heads and columns, o and down are
row-parallel on its heads and columns (the stored ``("heads", "embed")`` /
``("mlp", "embed")`` layout), the experts are the rank's ``E/tp``, and the
embedding and the LM head are vocab-parallel. Between a replicated
activation and such a region sits ``TrainProgram.enter`` (identity forward,
sum over tp backward); where the region's partial sums leave it,
``TrainProgram.exit`` (sum over tp forward, identity backward). The MoE
router, the norms and the residual stream are replicated over tp.

A step starts by putting together each parameter's compute view from the
stored parts (an all-gather over the data axes along the dim sharded on
them, then the tp cut), runs the forward and backward on the views, and
reduces each view's gradient back onto the stored part: a reduce-scatter
over the data axes along a dim sharded on them, an all-reduce over the data
axes of a leaf they replicate; over tp, a gradient that is partial there
(a replicated leaf used inside a tp region: q / k norms, MLA's ``w_dkv`` and
``kv_norm``) is summed first. AdamW then runs on the parts.

What must equal the one-process step, and how it does:

- the loss is the mean over the *global* batch's masked tokens: each rank's
  NLL sum over the global count (``models.model.loss_fn``); the Switch aux
  loss takes its token fractions and mean probabilities over the global
  batch (``models.moe``);
- the global gradient norm sums every leaf's squares over its parts,
  counting a part that several ranks hold once (the rank at index 0 on
  every axis the leaf is replicated over);
- the int8 moments' blocks are the global leaf's 64-wide blocks along its
  last axis: where a part's last-axis bounds fall inside a block, the
  block's absmax is max-reduced over the ranks holding pieces of it and
  the dequantization reads the global scales;
- ``ef_compress``'s per-tensor absmax is a global max over the parts;
- under remat the checkpointed blocks re-issue their forward collectives
  in the backward, in the same order on every rank.

Under gloo (the ranks of one machine) every collective of the step meets
in shared host memory (``parallel/host_shm.py``), whatever device the
tensors are on; under nccl, on the cards. Refused: the SSM and hybrid mixers,
the audio frontend and the gelu MLP (no tp cut here), a rules table that
shards the batch other than over every non-``model`` axis, and one that
shards the sequence (no sequence parallelism).
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import time
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from ..configs.base import ModelConfig, RunConfig
from ..tree import leaves, leaves_with_paths, tree_map, tree_map_with_path, unflatten_like
from . import collectives as coll
from .sharding import MeshShape, ReplicatedDimWarning, spec_for, use_mesh
from .state_sharding import (
    _flat,
    _index,
    abstract_train_state,
    part_shape,
    part_slices,
    shard_leaf,
    train_state_specs,
)

__all__ = ["MODEL_AXIS", "validate", "tp_cut", "InitParts", "GivenParts", "TrainEngine"]

MODEL_AXIS = "model"


def _tp(mesh: MeshShape) -> int:
    return mesh.shape.get(MODEL_AXIS, 1)


def _dp_axes(mesh: MeshShape) -> tuple:
    return tuple(a for a in mesh.axes if a != MODEL_AXIS)


def validate(cfg: ModelConfig, rc: RunConfig, mesh: MeshShape):
    """Refuse what the sharded step does not cut: raises
    ``NotImplementedError`` for an arch outside its cut and ``ValueError``
    for a width that tp does not divide."""
    if (cfg.family in ("ssm", "hybrid") or cfg.attn_type not in ("gqa", "mla")
            or cfg.frontend == "audio" or cfg.mlp_type != "swiglu"):
        raise NotImplementedError(f"{cfg.name}: the training mesh cuts GQA / MLA attention and "
                                  "SwiGLU / MoE FFNs only (no SSM, hybrid, audio or gelu)")
    tp = _tp(mesh)
    need = {"vocab_size": cfg.vocab_size, "num_heads": cfg.num_heads}
    if cfg.attn_type == "gqa":
        need["num_kv_heads"] = cfg.num_kv_heads
    if any(not cfg.is_moe_layer(i) for i in range(cfg.num_layers)):
        need["d_ff"] = cfg.d_ff
    if cfg.num_experts:
        need["num_experts"] = cfg.num_experts
        if cfg.num_shared_experts:
            need["shared d_ff"] = (cfg.moe_d_ff or cfg.d_ff) * cfg.num_shared_experts
    bad = {k: v for k, v in need.items() if v % tp}
    if bad:
        raise ValueError(f"{cfg.name}: model={tp} must divide {bad}")
    with use_mesh(mesh, overrides=rc.sharding_overrides) as ctx:
        rows, seq = ctx.rules.get("batch"), ctx.rules.get("seq")
    if seq is not None:
        raise NotImplementedError(f"the training mesh does not shard the sequence (sequence "
                                  f"parallelism is not cut); the rules give seq -> {seq!r}")
    if set(_flat(rows)) != set(_dp_axes(mesh)) or tuple(_flat(rows)) != tuple(
            a for a in mesh.axes if a in _flat(rows)):
        raise NotImplementedError(f"the training mesh splits the batch over {_dp_axes(mesh)} in "
                                  f"mesh order; the rules give {rows!r}")


def tp_cut(keys: tuple, ndim: int, tp: int) -> tuple:
    """(the dim of a parameter leaf cut over tp in the compute, or None;
    whether its gradient is partial over tp), by the leaf's path."""
    if tp == 1:
        return None, False
    parent = keys[-2] if len(keys) >= 2 else ""
    if keys[0] == "embed":
        return 0, False                       # vocab rows
    if keys[0] == "head":
        return ndim - 1, False                # vocab columns
    if "attn" in keys:
        if parent in ("wq", "wk", "wv"):
            return ndim - 1, False
        if parent == "wo":
            return ndim - 2, False
        if parent in ("w_uk", "w_uv"):
            return ndim - 2, False            # (layers, lora, heads, d)
        return None, True                     # q / k / kv norms, w_dkv: used on local heads
    if "ffn" in keys:
        if "experts" in keys:
            return 1, False                   # (layers, experts, ...)
        if parent in ("w_gate", "w_up"):
            return ndim - 1, False
        if parent == "w_down":
            return ndim - 2, False
    return None, False                        # norms, the router: replicated compute


@dataclass(frozen=True)
class LeafPlan:
    """One parameter leaf: the stored dim on ``model`` (None: none), the
    stored dims on data axes ((dim, axes), ...), the data axes it is
    replicated over, and its compute cut over tp."""

    m_dim: int | None
    d_dims: tuple
    rest_dp: tuple
    c_dim: int | None
    partial: bool


def _plan(name: str, ndim: int, spec: tuple, mesh: MeshShape) -> LeafPlan:
    m_dim, d_dims = None, []
    for i, entry in enumerate(spec):
        axes = _flat(entry)
        if not axes:
            continue
        if MODEL_AXIS in axes:
            if len(axes) > 1:
                raise NotImplementedError(f"{name}: a dim sharded on model with other axes "
                                          f"({entry!r})")
            m_dim = i
        else:
            if axes != tuple(a for a in mesh.axes if a in axes):
                raise NotImplementedError(f"{name}: mesh axes {axes} out of mesh order")
            d_dims.append((i, axes))
    used = {a for _, axes in d_dims for a in axes}
    c_dim, partial = tp_cut(tuple(name.split("/")), ndim, _tp(mesh))
    return LeafPlan(m_dim, tuple(d_dims), tuple(a for a in _dp_axes(mesh) if a not in used),
                    c_dim, partial)


# ------------------------------------------------------------ param sources
@dataclass(frozen=True)
class InitParts:
    """Every rank draws ``models.init`` from ``Generator(generator).manual_seed(seed)``
    and keeps its part of each leaf as it is drawn: the one-process
    ``init``'s weights, and no rank holds the whole tree. ``generator``:
    ``cpu``, or ``cuda`` (each rank's own device)."""

    seed: int = 0
    generator: str = "cpu"

    def params(self, engine: "TrainEngine"):
        from ..models import init

        gdev = engine.device if self.generator == "cuda" else torch.device("cpu")
        gen = torch.Generator(device=gdev).manual_seed(self.seed)

        def keep(path, leaf):
            return shard_leaf(engine.specs["params/" + "/".join(path)], leaf, engine.mesh,
                              engine.coords)

        return init(engine.cfg, engine.rc, gen, device=engine.device, keep=keep)


class GivenParts:
    """One rank's part of a given parameter tree, cut by the caller (host
    copies travel to the rank, which places them on its device)."""

    def __init__(self, part):
        self.part = tree_map(lambda t: t.detach().cpu(), part)

    def params(self, engine: "TrainEngine"):
        return tree_map(lambda t: t.to(engine.device), self.part)


class _Clock:
    """Seconds of a step's parts, each ended by a device sync."""

    def __init__(self, device):
        self.device, self.laps, self.t = device, {}, time.perf_counter()

    def lap(self, name: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.laps[name] = now - self.t
        self.t = now


# ------------------------------------------------------------------- engine
class TrainEngine:
    """What one rank holds for a mesh ``Trainer``: its part of the train
    state (``state``, in the one-process state's layout) and the sharded
    step. ``group(axes)`` returns this rank's group over the mesh axes
    ``axes`` (a frozenset): a ``host_shm.ShmGroup`` for gloo ranks of one
    machine, a process group under nccl; each rank asks for the same
    groups in the same order. ``ctl_barrier`` waits for every rank."""

    def __init__(self, cfg: ModelConfig, rc: RunConfig, mesh: MeshShape, rank: int, source, *,
                 device, group, ctl_barrier=None):
        from ..optim.adamw import AdamWState, _q8, _q8_log, _quantize_moments
        from .serve_mesh import MeshSpec, local_config

        validate(cfg, rc, mesh)
        self.cfg, self.rc, self.mesh, self.rank = cfg, rc, mesh, rank
        self.coords = mesh.coords(rank)
        self.device = torch.device(device)
        self.tp = _tp(mesh)
        self.t = self.coords.get(MODEL_AXIS, 0)
        self.dp = mesh.size // self.tp
        self.cfg_local = local_config(cfg, MeshSpec(self.dp, self.tp))
        self.barrier = ctl_barrier
        with warnings.catch_warnings(), use_mesh(mesh, overrides=rc.sharding_overrides):
            if rank:        # rank 0 (the controller) warns for the mesh
                warnings.simplefilter("ignore", ReplicatedDimWarning)
            abstract = abstract_train_state(cfg, rc)
            self.specs = train_state_specs(cfg, rc, abstract)
            self.row_entry = spec_for(("batch",), None)[0]
        self.shapes = {n: tuple(t.shape) for n, t in leaves_with_paths(abstract)}
        self.plans = [_plan(n[len("params/"):], len(self.shapes[n]), self.specs[n], mesh)
                      for n, _ in leaves_with_paths(abstract["params"], "params")]
        # every group the step uses, created in one order on every rank
        subsets = {frozenset({MODEL_AXIS}) & set(mesh.axes), frozenset(_dp_axes(mesh)),
                   frozenset(mesh.axes)}
        for p in self.plans:
            subsets.update(frozenset(a) for _, a in p.d_dims)
            subsets.add(frozenset(p.rest_dp))
        for n, spec in self.specs.items():
            if n.endswith("/s"):        # an int8 moment's block scales
                subsets.add(frozenset(_flat(spec[-1])))
        self.groups = {s: group(s) for s in sorted((s for s in subsets if s),
                                                  key=lambda s: tuple(sorted(s)))}

        params = source.params(self)
        quant = rc.moments_dtype == "int8"
        zero_s = {False: _q8(torch.zeros(1, 1))[1].reshape(()),
                  True: _q8_log(torch.zeros(1, 1))[1].reshape(())}

        def moment(prefix: str, log: bool):
            def one(name, p):
                if quant and _quantize_moments(p):
                    sname = f"{prefix}/{name}/s"
                    s_shape = part_shape(self.specs[sname], self.shapes[sname], mesh)
                    return {"q": torch.zeros(p.shape, dtype=torch.uint8 if log else torch.int8,
                                             device=self.device),
                            "s": zero_s[log].to(self.device).expand(s_shape).clone()}
                return torch.zeros(p.shape, dtype=torch.float32, device=self.device)
            return tree_map_with_path(one, params)

        master_dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[rc.master_dtype]
        opt = AdamWState(step=torch.zeros((), dtype=torch.int32, device=self.device),
                         master=tree_map_with_path(
                             lambda _, p: p.detach().to(master_dt, copy=True), params),
                         m=moment("opt/2", False), v=moment("opt/3", True))
        self.state = {"params": params, "opt": opt}
        if rc.grad_compression == "int8_ef":
            self.state["ef"] = tree_map_with_path(
                lambda _, p: torch.zeros(p.shape, dtype=torch.float32, device=self.device),
                params)
        for n, t in leaves_with_paths(self.state):
            want = part_shape(self.specs[n], self.shapes[n], mesh)
            if tuple(t.shape) != want:
                raise AssertionError(f"rank {rank}: {n} holds {tuple(t.shape)}, its spec "
                                     f"{self.specs[n]} gives {want}")
        self._moment_plans = {}

    # --------------------------------------------------------------- groups
    def _group(self, axes) -> object:
        return self.groups[frozenset(axes)]

    def _owner(self, name: str) -> bool:
        """Whether this rank writes / counts the part of ``name``: the one
        at index 0 on every axis the leaf is replicated over."""
        used = {a for e in self.specs[name] for a in _flat(e)}
        return all(self.coords[a] == 0 for a in self.mesh.axes if a not in used)

    # ---------------------------------------------------- weights and grads
    def _size(self, axes) -> int:
        return math.prod(self.mesh.shape[a] for a in axes)

    def _view(self, plan: LeafPlan, part: torch.Tensor, prog) -> torch.Tensor:
        """The compute view of one parameter from this rank's part."""
        x = part
        for dim, axes in plan.d_dims:
            x = prog.run("fsdp_all_gather", "all_gather", x, self._size(axes),
                         coll.all_gather_dim, self._group(axes), dim)
        if plan.m_dim != plan.c_dim:
            if plan.m_dim is not None:
                x = prog.run("tp_all_gather:weights", "all_gather", x, self.tp,
                             coll.all_gather_dim, self._group({MODEL_AXIS}), plan.m_dim)
            if plan.c_dim is not None:
                n = x.shape[plan.c_dim] // self.tp
                x = x.narrow(plan.c_dim, self.t * n, n)
        return x.detach().requires_grad_(True)

    def _grad(self, plan: LeafPlan, g: torch.Tensor, prog) -> torch.Tensor:
        """A compute view's gradient reduced onto this rank's stored part
        (in the gradient's dtype, as the reference's partitioner reduces
        it), then in f32."""
        if plan.partial and plan.c_dim is None:
            g = prog.run("grad_all_reduce:tp", "all_reduce", g, self.tp, coll.all_reduce,
                         self._group({MODEL_AXIS}))
        if plan.m_dim != plan.c_dim:
            if plan.c_dim is not None:
                g = prog.run("tp_all_gather:grads", "all_gather", g, self.tp,
                             coll.all_gather_dim, self._group({MODEL_AXIS}), plan.c_dim)
            if plan.m_dim is not None:
                n = g.shape[plan.m_dim] // self.tp
                g = g.narrow(plan.m_dim, self.t * n, n).contiguous()
        for dim, axes in reversed(plan.d_dims):
            g = prog.run("grad_reduce_scatter:dp", "reduce_scatter", g, self._size(axes),
                         coll.reduce_scatter_dim, self._group(axes), dim)
        if plan.rest_dp:
            g = prog.run("grad_all_reduce:dp", "all_reduce", g, self._size(plan.rest_dp),
                         coll.all_reduce, self._group(plan.rest_dp))
        return g.to(torch.float32)

    # ------------------------------------------------------------- optimizer
    def global_norm(self, grads) -> torch.Tensor:
        """The gradient's global norm over every rank's parts, a part that
        several ranks hold counted once."""
        sq = torch.zeros((), dtype=torch.float32, device=self.device)
        for (name, g) in leaves_with_paths(grads):
            if self._owner("params/" + name):
                sq = sq + torch.sum(torch.square(g.to(torch.float32)))
        return torch.sqrt(self._prog.run("grad_norm:all_reduce", "all_reduce", sq,
                                         self.mesh.size, coll.all_reduce,
                                         self._group(self.mesh.axes)))

    def global_max(self, tops: list) -> list:
        """Every leaf's absmax over its parts (``ef_compress``'s scales)."""
        return list(self._prog.run("ef_amax:all_reduce", "all_reduce", torch.stack(tops),
                                   self.mesh.size, coll.all_reduce,
                                   self._group(self.mesh.axes), "max").unbind(0))

    def _moment_plan(self, name: str, log: bool) -> dict:
        key = (name, log)
        if key not in self._moment_plans:
            pname, sname = "params/" + name, f"opt/{3 if log else 2}/{name}/s"
            K = self.shapes[pname][-1]
            a = part_slices(self.specs[pname], self.shapes[pname], self.mesh, self.coords)[-1]
            sa = part_slices(self.specs[sname], self.shapes[sname], self.mesh, self.coords)[-1]
            nb = self.shapes[sname][-1]
            aligned = (a.start % 64 == 0 and (a.stop % 64 == 0 or a.stop == K)
                       and sa.start == a.start // 64 and sa.stop == -(-a.stop // 64))
            self._moment_plans[key] = {
                "aligned": aligned, "a": a, "sa": sa, "nb": nb,
                "q_axes": _flat(self.specs[pname][-1]), "s_axes": _flat(self.specs[sname][-1])}
        return self._moment_plans[key]

    def _block_index(self, mp: dict, device) -> torch.Tensor:
        a = mp["a"]
        return torch.arange(a.start, a.stop, device=device) // 64

    def dq8(self, name: str, q: torch.Tensor, s: torch.Tensor, log: bool) -> torch.Tensor:
        from ..optim.adamw import _dq8, _dq8_log, _lin_values, _log_values

        mp = self._moment_plan(name, log)
        if mp["aligned"]:
            return (_dq8_log if log else _dq8)(q, s)
        if mp["s_axes"]:
            s = self._prog.run("moments:s_all_gather", "all_gather", s,
                               self._size(mp["s_axes"]), coll.all_gather_dim,
                               self._group(mp["s_axes"]), s.ndim - 1)
        s_el = s[..., self._block_index(mp, s.device)]
        return (_log_values if log else _lin_values)(q, s_el)

    def q8(self, name: str, x: torch.Tensor, log: bool):
        from ..optim.adamw import _log_codes, _lin_codes, _q8, _q8_log

        mp = self._moment_plan(name, log)
        if mp["aligned"]:
            return (_q8_log if log else _q8)(x)
        blk = self._block_index(mp, x.device)
        mag = x if log else x.abs()
        amax = torch.zeros(x.shape[:-1] + (mp["nb"],), dtype=torch.float32, device=x.device)
        amax = amax.scatter_reduce(-1, blk.expand(x.shape), mag, "amax", include_self=True)
        if mp["q_axes"]:
            amax = self._prog.run("moments:amax_all_reduce", "all_reduce", amax,
                                  self._size(mp["q_axes"]), coll.all_reduce,
                                  self._group(mp["q_axes"]), "max")
        s = amax + 1e-30 if log else amax / 127.0 + 1e-12
        q = (_log_codes if log else _lin_codes)(x, s[..., blk])
        return q, s[..., mp["sa"]].contiguous()

    # ----------------------------------------------------------------- step
    def _rows(self, batch: dict, i: int, k: int) -> dict:
        """This rank's rows of microbatch ``i`` of ``k`` of the global
        batch (M-RoPE positions (3, B, S) on axis 1)."""
        d = _index(self.row_entry, self.mesh, self.coords)
        out = {}
        for n, x in batch.items():
            ax = 1 if n == "positions" else 0
            B = x.shape[ax]
            if B % (k * self.dp):
                raise ValueError(f"a batch of {B} rows does not split into {k} microbatches "
                                 f"over {self.dp} data ranks")
            lo = i * (B // k) + d * (B // (k * self.dp))
            out[n] = x.narrow(ax, lo, B // (k * self.dp)).to(self.device)
        return out

    def step(self, batch: dict) -> dict:
        """One train step on the global ``batch`` (every rank is given the
        whole batch and takes its rows): {"metrics": the step's loss, aux,
        lr and grad norm (global), "meter": the collectives by label,
        "seconds": (the step, its part inside collectives), "laps": the
        seconds of its parts}."""
        from ..models import loss_fn
        from ..optim import adamw_update, ef_compress

        t0 = time.perf_counter()
        rc = self.rc
        prog = coll.TrainProgram(tp=self.tp, t=self.t, dp=self.dp,
                                 tp_group=self.groups.get(frozenset({MODEL_AXIS})),
                                 dp_group=self.groups.get(frozenset(_dp_axes(self.mesh))))
        self._prog = prog
        parts = leaves(self.state["params"])
        clock = _Clock(self.device)
        with torch.no_grad():
            views = [self._view(p, x, prog) for p, x in zip(self.plans, parts)]
        clock.lap("views")
        tree = unflatten_like(self.state["params"], views)
        k = rc.microbatches
        acc = None
        with coll.activate_train(prog):
            for i in range(k):
                total, metrics = loss_fn(self.cfg_local, rc, tree, self._rows(batch, i, k))
                grads = list(torch.autograd.grad(total, views, allow_unused=True))
                del total
                if k == 1:
                    acc = grads
                    break
                grads = [torch.zeros_like(v) if g is None else g for v, g in zip(views, grads)]
                if acc is None:
                    acc = [g.to(torch.float32) for g in grads]
                else:
                    for a, g in zip(acc, grads):
                        a.add_(g.to(torch.float32))
                del grads
        clock.lap("forward_backward")
        # each view's gradient reduced onto the stored part, leaf by leaf
        # (a full-size gradient is freed as soon as its part exists)
        gparts = []
        with torch.no_grad():
            for j, plan in enumerate(self.plans):
                g, acc[j] = acc[j], None
                g = torch.zeros_like(views[j]) if g is None else g
                gparts.append(self._grad(plan, g if k == 1 else g / k, prog))
                del g
        del views, tree, acc
        clock.lap("grad_reduce")
        grads = unflatten_like(self.state["params"], gparts)
        if rc.grad_compression == "int8_ef":
            grads, self.state["ef"] = ef_compress(grads, self.state["ef"], amax=self.global_max)
        _, self.state["opt"], om = adamw_update(grads, self.state["opt"], rc,
                                                self.state["params"], mesh=self)
        row = torch.stack([metrics["loss"].reshape(()).float(), metrics["aux"].reshape(()).float(),
                           om["lr"].reshape(()).float().to(self.device),
                           om["grad_norm"].reshape(()).float()])
        # a dry-run's step (meta tensors) has shapes, no values
        row = [math.nan] * 4 if row.is_meta else row.tolist()
        clock.lap("optimizer")
        self._prog = None
        return {"metrics": dict(zip(("loss", "aux", "lr", "grad_norm"), row)),
                "meter": prog.meter, "seconds": (time.perf_counter() - t0, prog.comm_s),
                "laps": clock.laps}

    # -------------------------------------------------------- state access
    def parts(self, prefix: str = "") -> dict:
        """{path: host copy of this rank's part} of the state's leaves under
        ``prefix``."""
        return {n: t.detach().cpu() for n, t in leaves_with_paths(self.state)
                if n.startswith(prefix)}

    def resident(self) -> dict:
        """This rank's state bytes; its specs' share (each leaf's full
        bytes over the number of parts its spec cuts it into, a replicated
        leaf whole); the one-process state's bytes; the card's peak
        allocation in this rank's process (None on the CPU)."""
        share = 0
        for n, t in leaves_with_paths(self.state):
            cuts = math.prod(self.mesh.shape[a] for e in self.specs[n] for a in _flat(e))
            share += math.prod(self.shapes[n]) * t.element_size() // cuts
        full = sum(math.prod(self.shapes[n]) * t.element_size()
                   for n, t in leaves_with_paths(self.state))
        peak = (torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda"
                else None)
        return {"state_bytes": sum(t.numel() * t.element_size() for t in leaves(self.state)),
                "share_bytes": share,
                "one_process_bytes": full, "peak_allocated_bytes": peak}

    # ---------------------------------------------------------- checkpoints
    def save(self, ckpt_dir: str, step: int, keep: int = 3) -> str:
        """Write the checkpoint of ``step`` in ``train.checkpoint``'s layout
        (one ``.npy`` a leaf, the full leaf, and the manifest): rank 0 lays
        out every file, each leaf's owning ranks write their parts into it,
        rank 0 renames the directory and keeps the newest ``keep``."""
        from ..train.checkpoint import _leaf_file

        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if self.rank == 0:
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp, exist_ok=True)
            manifest = {"step": step, "leaves": {}, "extra": {}}
            for n, t in leaves_with_paths(self.state):
                dt = "bfloat16" if t.dtype == torch.bfloat16 else str(
                    torch.empty((), dtype=t.dtype).numpy().dtype)
                np_dt = np.int16 if dt == "bfloat16" else np.dtype(dt)
                f = os.path.join(tmp, _leaf_file(n))
                np.lib.format.open_memmap(f, mode="w+", dtype=np_dt, shape=self.shapes[n])
                manifest["leaves"][n] = {"file": _leaf_file(n), "shape": list(self.shapes[n]),
                                         "dtype": dt}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f, indent=1)
        self.barrier()
        for n, t in leaves_with_paths(self.state):
            if not self._owner(n):
                continue
            arr = t.detach().cpu()
            arr = (arr.view(torch.int16) if arr.dtype == torch.bfloat16 else arr).numpy()
            mm = np.lib.format.open_memmap(os.path.join(tmp, _leaf_file(n)), mode="r+")
            # no flush: like ``train.checkpoint.save``, the page cache holds it
            mm[part_slices(self.specs[n], self.shapes[n], self.mesh, self.coords)] = arr
            del mm
        self.barrier()
        if self.rank == 0:
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            steps = sorted(int(m.group(1)) for d in os.listdir(ckpt_dir)
                           if (m := re.fullmatch(r"step_(\d+)", d)))
            for s in steps[:-keep]:
                shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)
        self.barrier()
        return final

    @torch.no_grad()
    def load(self, ckpt_dir: str, step: int) -> int:
        """Read this rank's part of every leaf of the checkpoint of
        ``step`` (any mesh's, or one process's) into the state in place;
        returns the manifest's step."""
        d = os.path.join(ckpt_dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        for n, t in leaves_with_paths(self.state):
            meta = manifest["leaves"][n]
            if tuple(meta["shape"]) != self.shapes[n]:
                raise ValueError(f"checkpoint leaf {n}: shape {meta['shape']}, the state's "
                                 f"{self.shapes[n]}")
            arr = np.load(os.path.join(d, meta["file"]), mmap_mode="r")
            part = np.array(arr[part_slices(self.specs[n], self.shapes[n], self.mesh,
                                            self.coords)], copy=True, order="C")
            src = torch.from_numpy(part.view(np.int16)).view(torch.bfloat16) \
                if meta["dtype"] == "bfloat16" else torch.from_numpy(part)
            t.copy_(src.reshape(t.shape).to(dtype=t.dtype))
        return int(manifest["step"])
