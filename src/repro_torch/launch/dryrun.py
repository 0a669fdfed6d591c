"""Multi-pod dry-run: price every live (arch × shape × mesh) cell on ``meta``
tensors (the reference's ``repro/launch/dryrun.py``, which lowers and
compiles each cell with XLA over 512 forced host devices).

A cell runs rank 0's program of ``make_production_mesh(multi_pod=)`` (16×16,
or 2×16×16) once on ``meta`` tensors, under ``roofline.op_cost.count_ops``:

- ``train_4k``: one step of the sharded trainer
  (``parallel/train_mesh.py::TrainEngine``) on the global batch; rank 0
  holds its part of the train state (``state_sharding.part_shape`` of each
  leaf's spec);
- ``decode_32k`` / ``long_500k``: one sharded mixed step
  (``parallel/serve_mesh.py``) of width ``prefill_chunk`` over a cache of
  ``seq_len`` tokens a row, rank 0 holding its weight and cache shards;
- ``prefill_32k``: one sharded mixed step of width ``seq_len``, the whole
  prompt in one step: the counterpart of the reference's ``build_prefill``.

The collectives go to ``parallel.collectives.MetaGroup``: meta results of
the right shape, each call charged by the reference's HLO table. Every
hand-written kernel charges its own count (``roofline.kernel_cost``). The
three terms are priced on the ``h100`` profile, the port's target, wherever
the sweep runs (the reference prices on its own target, ``HW()``), and
``fits`` is judged against its 80 GB. Nothing here is a measurement: the
terms are a price computed from counts.

The row prices the port's rank program, not GSPMD's layout: a cell the
rank programs refuse (a tp that does not divide the serving mesh's heads,
a sequence-parallel override on a serving cell, an arch the serving mesh
does not run) prints ``[FAIL] <cell>: <the refusal's words>`` and counts as
a failure; no other program is priced in its place. The training mesh
takes every train cell: its ``seq -> model`` override is sequence
parallelism, and a width tp does not divide runs whole on every tp rank. The
row's ``replicated_dims`` / ``dropped_rules`` are the accounting of the
state's specs (parameters, optimizer state, caches, the batch) under the
cell's rules, and of a train step's widths computed whole; a rank's
activations are slices and count nothing.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun                # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-v2-lite-16b
    PYTHONPATH=src python -m repro_torch.launch.dryrun --both-meshes --out build/dryrun
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import traceback
from dataclasses import dataclass

import torch

from ..configs.archs import ASSIGNED
from ..configs.base import SHAPES, RunConfig, get_config
from ..models import model_flops
from ..obs.profile import named_scope
from ..parallel.sharding import use_mesh
from ..roofline.analysis import HW_PROFILES, analyze
from ..roofline.op_cost import count_ops
from ..tree import leaves, tree_map_with_path
from .ctx_report import format_dropped_rules, sharding_report
from .mesh import make_production_mesh

__all__ = ["SKIPS", "Refused", "Cell", "live_cells", "cell_runconfig", "train_program",
           "serve_program", "build_cell", "run_cell", "main"]

# ---------------------------------------------------------------- cell plan
SKIPS: dict[tuple, str] = {
    ("qwen3-0.6b", "long_500k"): "pure full attention — quadratic at 500k (DESIGN.md §4)",
    ("qwen3-8b", "long_500k"): "pure full attention — quadratic at 500k",
    ("qwen3-14b", "long_500k"): "pure full attention — quadratic at 500k",
    ("smollm-360m", "long_500k"): "pure full attention — quadratic at 500k",
    ("llama4-maverick-400b-a17b", "long_500k"): "pure full attention — quadratic at 500k",
    ("deepseek-v2-lite-16b", "long_500k"): "pure full attention — quadratic at 500k",
    ("qwen2-vl-7b", "long_500k"): "pure full attention — quadratic at 500k",
    ("hubert-xlarge", "decode_32k"): "encoder-only — no decode step",
    ("hubert-xlarge", "long_500k"): "encoder-only — no decode step",
}


class Refused(Exception):
    """A rank program refused the cell (its words are the message)."""


def live_cells():
    for arch in ASSIGNED:
        for shape in SHAPES.values():
            if (arch, shape.name) not in SKIPS:
                yield arch, shape


def cell_runconfig(arch: str, shape, optimized: bool = False) -> RunConfig:
    """The reference's RunConfig per cell (its paper-faithful defaults;
    ``optimized`` its §Perf settings: weights not FSDP-sharded at serve time
    where the TP shard fits, sequence-parallel prefill, an int8 KV cache for
    decode, microbatches where the baseline did not fit)."""
    kw: dict = dict(dtype="bfloat16", param_dtype="bfloat16")
    if shape.kind == "train":
        kw.update(remat="block", scan_layers=True)
        kw["sharding_overrides"] = {"seq": "model"}
        if arch == "llama4-maverick-400b-a17b":
            kw.update(moments_dtype="int8")
            if optimized:
                kw.update(microbatches=4)
    else:
        kw.update(remat="none", scan_layers=True)
        if optimized:
            from ..models.model import count_params

            overrides = {}
            if count_params(get_config(arch)) * 2 / 16 / 1e9 < 8.0:
                overrides["embed"] = None
            if shape.kind == "prefill":
                overrides["seq"] = "model"
            kw["sharding_overrides"] = overrides
            if shape.kind == "decode":
                kw.update(kv_cache_dtype="int8")
    return RunConfig(**kw)


# ------------------------------------------------------------------ building
@dataclass
class Cell:
    """One cell's rank-0 program on meta tensors: ``run()`` takes one step
    and returns its collectives by label; ``state`` is what rank 0 holds
    between steps; ``accounting`` the specs' sharding context."""

    run: object
    state: object
    accounting: object


def _meta(shape, dtype=torch.int32):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _refusing(fn, *args, **kw):
    """``fn(*args, **kw)``, a rank program's refusal raised as
    :class:`Refused` with its words."""
    try:
        return fn(*args, **kw)
    except (ValueError, NotImplementedError) as e:
        raise Refused(str(e)) from e


class _MetaParts:
    """The training engine's parameter source on meta: rank 0's part of
    each leaf, by its spec."""

    def params(self, engine):
        from ..models.model import abstract_params
        from ..parallel.state_sharding import part_shape

        return tree_map_with_path(
            lambda n, t: _meta(part_shape(engine.specs["params/" + n], tuple(t.shape),
                                          engine.mesh), t.dtype),
            abstract_params(engine.cfg, engine.rc))


def _group_factory(mesh):
    from ..parallel.collectives import MetaGroup

    return lambda axes: MetaGroup(math.prod(mesh.shape[a] for a in axes))


def _train_batch(cfg, B: int, S: int) -> dict:
    if cfg.frontend == "audio":
        batch = {"embeds": _meta((B, S, 512), torch.float32)}
    else:
        batch = {"tokens": _meta((B, S))}
    batch["labels"] = _meta((B, S))
    if cfg.mrope_sections is not None:
        batch["positions"] = _meta((3, B, S))
    return batch


def train_program(cfg, rc, mesh, batch: dict) -> Cell:
    """Rank 0's train step of ``mesh`` on the meta ``batch`` (the global
    batch): ``run()`` returns the step's ``TrainProgram.meter``."""
    from ..parallel.state_sharding import abstract_train_state, batch_specs, train_state_specs
    from ..parallel.train_mesh import TrainEngine, validate

    with use_mesh(mesh, overrides=rc.sharding_overrides) as ctx:
        _refusing(validate, cfg, rc, mesh)      # counts the widths computed whole
        train_state_specs(cfg, rc, abstract_train_state(cfg, rc))
        batch_specs(batch)
    engine = _refusing(TrainEngine, cfg, rc, mesh, 0, _MetaParts(), device="meta",
                       group=_group_factory(mesh))
    def run():
        with named_scope("train/step"):
            return engine.step(batch)["meter"]

    return Cell(run=run, state=engine.state, accounting=ctx)


def serve_program(cfg, rc, spec, B: int, W: int, cap: int, mesh=None,
                  num_pages: int | None = None) -> Cell:
    """Rank (0, 0)'s sharded mixed step of a (dp, tp) ``spec`` for ``B``
    rows of ``W`` columns over a cache of ``cap`` tokens a row (a paged
    pool of ``num_pages``, default dense-equivalent): ``run()`` returns the
    step's ``MeshProgram.meter_snapshot()`` keyed ``label@bits``. The
    accounting context is ``mesh``'s (default: ``spec``'s (data, model))."""
    from ..models import init_caches
    from ..models.model import abstract_params
    from ..parallel import serve_mesh as sm
    from ..parallel.collectives import MetaGroup
    from ..parallel.state_sharding import batch_specs, cache_specs, prequant_param_specs, \
        train_state_specs
    from ..quant import apply_surgery
    from ..quant.policy import effective_policy

    if cfg.is_encoder:
        raise Refused(f"{cfg.name} is encoder-only: the Scheduler's mixed step serves "
                      "decoders (ROADMAP C12)")
    if cfg.family in ("ssm", "hybrid"):
        raise Refused(f"{cfg.name}: the {cfg.family} mixer's state is not chunk-resumable, so "
                      "it decodes on the legacy Engine, which has no mesh")
    if rc.sharding_overrides.get("seq") is not None:
        raise Refused("the serving mesh does not shard the sequence (the rules give seq -> "
                      f"{rc.sharding_overrides['seq']!r})")
    _refusing(sm.validate, cfg, rc, spec, B)
    if mesh is None:
        from .mesh import make_local_mesh

        mesh = make_local_mesh(spec.dp, spec.tp)
    pol = effective_policy(rc)
    full = abstract_params(cfg, rc)
    if pol.any_prequant:
        full = apply_surgery(cfg, rc, full)
    tokens = _meta((B, W))
    tables = _meta((B, cap // rc.block_size)) if rc.kv_layout == "paged" else None
    with use_mesh(mesh, overrides=rc.sharding_overrides) as ctx:
        if pol.any_prequant:
            prequant_param_specs(cfg, rc, full)
        else:
            train_state_specs(cfg, rc, {"params": full})
        cache_specs(cfg, rc, init_caches(cfg, rc, B, cap, num_pages=num_pages, device="meta"))
        batch_specs({"tokens": tokens})
    params = sm._map_keys(sm.param_keep(spec, 0), full)
    del full
    rows = B if rc.kv_layout == "paged" else B // spec.dp
    caches = init_caches(sm.local_config(cfg, spec), rc, rows, cap, num_pages=num_pages,
                         device="meta")
    coords = sm.RankCoords(d=0, t=0, dp_group=MetaGroup(spec.dp), tp_group=MetaGroup(spec.tp),
                           world_group=MetaGroup(spec.devices))
    step = sm.build_sharded_step(cfg, rc, spec, coords, with_stats=pol.is_quant)
    pos, lens = _meta((B,)), _meta((B,))
    state = {"params": params, "caches": caches}

    def run():
        state["caches"], _, _, meter = step(params, state["caches"], tokens, pos, lens, tables)
        return {f"{label}@{bits}": r for (label, bits), r in meter.items()}

    return Cell(run=run, state=state, accounting=ctx)


def build_cell(arch: str, shape, rc: RunConfig, mesh) -> Cell:
    """Rank 0's program of ``mesh`` for the cell, on meta tensors; raises
    :class:`Refused` where a rank program refuses it."""
    from .mesh import pool_spec

    cfg = get_config(arch)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return train_program(cfg, rc, mesh, _train_batch(cfg, B, S))
    W = S if shape.kind == "prefill" else max(rc.prefill_chunk, 1)
    return serve_program(cfg, rc, pool_spec(mesh), B, W, S, mesh=mesh)


def _state_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree)
               if isinstance(t, torch.Tensor))


def run_cell(
    arch: str,
    shape,
    *,
    multi_pod: bool,
    out_dir: str | None = None,
    optimized: bool = False,
    kv_layout: str | None = None,
    block_size: int | None = None,
    hw=None,
) -> dict:
    """Price one cell; returns its row (raises :class:`Refused` where a rank
    program refuses it)."""
    cfg = get_config(arch)
    rc = cell_runconfig(arch, shape, optimized=optimized)
    if shape.kind == "decode" and cfg.family not in ("ssm", "hybrid"):
        if kv_layout is not None:
            rc = dataclasses.replace(rc, kv_layout=kv_layout)
        if block_size is not None:
            rc = dataclasses.replace(rc, block_size=block_size)
    mesh = make_production_mesh(multi_pod=multi_pod)
    hw = HW_PROFILES["h100"] if hw is None else hw
    name = f"{arch}×{shape.name}×{'multi' if multi_pod else 'single'}"

    t0 = time.time()
    cell = build_cell(arch, shape, rc, mesh)
    with torch.no_grad() if shape.kind != "train" else contextlib.nullcontext():
        with count_ops() as cost:
            cost.hold(cell.state)
            argument = cost.live_bytes
            meter = cell.run()
    dt = time.time() - t0
    for line in format_dropped_rules(cell.accounting):
        print(f"[warn] {name}: {line}", flush=True)

    peak = float(cost.peak_bytes)
    report = analyze(name, chips=mesh.size, cost=cost, model_flops=model_flops(cfg, shape),
                     hw=hw, memory_per_chip=peak)
    row = {
        "cell": name,
        "arch": arch,
        "shape": shape.name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": mesh.size,
        "trace_s": round(dt, 1),
        "hw": hw.name,
        "peak_bytes_per_chip": peak,
        "argument_bytes_per_chip": float(argument),
        "temp_bytes_per_chip": peak - float(argument),
        "hlo_flops_per_chip": report.hlo_flops,
        "hlo_bytes_per_chip": report.hlo_bytes,
        "collective_bytes_per_chip": report.collective_bytes,
        "collectives": report.collectives,
        "collective_counts": dict(cost.collective_counts),
        "collectives_by_label": meter,
        "model_flops": report.model_flops,
        "compute_s": report.compute_s,
        "memory_s": report.memory_s,
        "collective_s": report.collective_s,
        "dominant": report.dominant,
        "useful_ratio": report.useful_ratio,
        "mfu": report.mfu,
        "fits": bool(peak <= hw.hbm_per_chip),
        **sharding_report(cell.accounting),
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fname = name.replace("×", "_").replace("/", "-") + ".json"
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(row, f, indent=1, default=str)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: all)")
    ap.add_argument("--multi-pod", action="store_true", help="2×16×16 mesh")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--optimized", action="store_true", help="the reference's §Perf settings")
    ap.add_argument("--kv-layout", default=None, choices=["dense", "paged"],
                    help="KV layout for the mixed-step decode cells")
    ap.add_argument("--block-size", type=int, default=None,
                    help="paged KV page size (tokens)")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--keep-going", action="store_true", default=True)
    args = ap.parse_args(argv)

    cells = [
        (a, s)
        for a, s in live_cells()
        if (args.arch is None or a == args.arch)
        and (args.shape is None or s.name == args.shape)
    ]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    t_all = time.time()
    rows, failures = [], []
    for multi in meshes:
        for arch, shape in cells:
            label = f"{arch}×{shape.name}×{'multi' if multi else 'single'}"
            try:
                row = run_cell(arch, shape, multi_pod=multi, out_dir=args.out,
                               optimized=args.optimized, kv_layout=args.kv_layout,
                               block_size=args.block_size)
                rows.append(row)
                print(
                    f"[ok]   {label}: peak {row['peak_bytes_per_chip']/1e9:.2f} GB/chip, "
                    f"dominant={row['dominant']}, mfu={row['mfu']*100:.1f}%, "
                    f"trace {row['trace_s']}s (priced on {row['hw']}, not measured)",
                    flush=True,
                )
            except Refused as e:
                failures.append((label, str(e)))
                print(f"[FAIL] {label}: {e}", flush=True)
            except Exception as e:  # noqa: BLE001
                failures.append((label, repr(e)))
                print(f"[FAIL] {label}: {e!r}", flush=True)
                traceback.print_exc()
                if not args.keep_going:
                    raise

    print(f"\n{len(rows)} cells priced, {len(failures)} failed "
          f"({time.time() - t_all:.1f}s)")
    for label, err in failures:
        print(f"  FAIL {label}: {err[:200]}")
    for arch, shape in SKIPS:
        print(f"  SKIP {arch}×{shape}: {SKIPS[(arch, shape)]}")
    sys.stdout.flush()
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
