#!/usr/bin/env python3
"""Which float products of the sharded serving step move with a rank's shape.

A rank of the dp x tp serving mesh computes its float products at the
single-device launch's shape (``MeshProgram.at_full``: the bf16 GEMMs and
the tied head at the single-device row count, MLA's absorbed einsums at its
batch and heads; operands zero-padded, the result cut back), so that each
takes the algorithm the one-card launch takes. This probe serves the
chip_smoke workload (8 requests of 32-128 prompt tokens from ``numpy`` seed
0, 16 new tokens each) over the mesh with ``at_full`` replaced, in every
rank, by one of these modes:

- ``code``: as the code does;
- ``audit``: as the code does and, at every call, also the product at the
  rank's own shape; per site (``at_full``'s name), count the calls and the
  calls where the two differ in any bit, the largest difference, the
  event-to-event ms of each (the ranks sharing the card, host gaps
  included) and the bytes the padding writes; then rank 0's first call of
  each site and shape is timed again on the idle card, padded and not;
- ``off``: every site at the rank's own shape;
- ``keep:SITE,...``: pad only the listed sites.

Runs, on the card: deepseek-v2-lite at full width cut to 4 layers under
chip_smoke's MoE policy on one card (the reference tokens,
``cycles_by_bits`` and drops, without and with a fault plan that sends row
0 to the ``*=bf16`` fallback step), then over the mesh: ``code``, ``off``
and ``audit`` under the fault plan, each against its one-card run; then
qwen3-0.6b at full width and depth, ``audit``. On the CPU (``--device
cpu``) the same on the ``_smoke`` archs in f32. One JSON line a run; the
audits' per-rank records go to ``build/mesh_full_probe/``.

    python3 scripts/mesh_full_probe.py                 # the card
    PYTHONPATH=src python3 scripts/mesh_full_probe.py --device cpu
"""

from __future__ import annotations

import argparse
import atexit
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
OUT = os.path.join(ROOT, "build", "mesh_full_probe")
MODE = "MESH_FULL_PROBE"          # the mode, read by every rank at each call
TAG = "MESH_FULL_PROBE_TAG"       # the run's name, for the audit files
AUDIT: dict = {}
RANK: list = [0]                  # this process's rank, read at its first audited call
CALLS: dict = {}                  # (site, shape) -> the first such call's operands


def _ms(torch, fn):
    """(result, device ms) of ``fn()`` on the card; ms is None on the CPU."""
    if not torch.cuda.is_available():
        return fn(), None
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    y = fn()
    b.record()
    b.synchronize()
    return y, a.elapsed_time(b)


def _install() -> None:
    """Replace ``MeshProgram.at_full`` (in the process that runs this file
    as its main module: the parent, and every rank ``spawn`` starts)."""
    import torch

    from repro_torch.parallel import collectives

    padded = collectives.MeshProgram.at_full

    def at_full(self, site, fn, *operands):
        mode = os.environ.get(MODE, "code")
        if mode == "code" or (mode.startswith("keep:") and site in mode[5:].split(",")):
            return padded(self, site, fn, *operands)
        local = [x for x, _ in operands]
        if mode != "audit":
            return fn(*local)
        if not AUDIT and torch.distributed.is_initialized():
            RANK[0] = torch.distributed.get_rank()
        full, full_ms = _ms(torch, lambda: padded(self, site, fn, *operands))
        mine, mine_ms = _ms(torch, lambda: fn(*local))
        key = json.dumps([[list(x.shape), {str(d): f for d, f in dims.items()}]
                          for x, dims in operands if x is not None])
        r = AUDIT.setdefault(site, {"calls": 0, "moved": 0, "max_abs": 0.0, "padded_ms": 0.0,
                                    "local_ms": 0.0, "pad_bytes": 0, "shapes": {},
                                    "moved_shapes": {}})
        r["calls"] += 1
        r["shapes"][key] = r["shapes"].get(key, 0) + 1
        # the zeros the padding writes, and the product's entries beyond the rank's
        grow = [(x, math.prod(dims.values())) for x, dims in operands if x is not None]
        r["pad_bytes"] += sum(x.numel() * (g - 1) * x.element_size() for x, g in grow)
        r["pad_bytes"] += mine.numel() * (grow[0][1] - 1) * mine.element_size()
        if full_ms is not None:
            r["padded_ms"] += full_ms
            r["local_ms"] += mine_ms
        if not torch.equal(full, mine):
            r["moved"] += 1
            r["moved_shapes"][key] = r["moved_shapes"].get(key, 0) + 1
            r["max_abs"] = max(r["max_abs"], float((full.float() - mine.float()).abs().max()))
        if (site, key) not in CALLS:
            CALLS[(site, key)] = (self, fn, operands)
        return full

    collectives.MeshProgram.at_full = at_full
    atexit.register(_dump)


def _dump() -> None:
    """This rank's audit, if it made one, to ``OUT/<tag>_rank<r>.json``."""
    if not AUDIT:
        return
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, f"{os.environ.get(TAG, 'run')}_rank{RANK[0]}.json"), "w") as f:
        json.dump(AUDIT, f)
    AUDIT.clear()


_install()


# ------------------------------------------------------------------- runs
def scheduler(cfg, rc, params, dev, *, mesh=None, backend=None, faults=None):
    import numpy as np

    from repro_torch.serve import Request, Scheduler

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(32, 129))).tolist()
               for _ in range(8)]
    s = Scheduler(cfg, rc, params, capacity=256, max_batch=4, track_energy=True, device=dev,
                  mesh=mesh, mesh_backend=backend, faults=faults)
    for rid, p in enumerate(prompts):
        s.submit(Request(rid=rid, prompt=p, max_new=16))
    return s


def fault_plan():
    from repro_torch.serve.faults import FaultEvent, FaultPlan

    return FaultPlan([FaultEvent(t, "nan_logits", 0) for t in range(2, 8)])


def one_card(torch, cfg, rc, dev, faults) -> dict:
    """The one-card serve's tokens, cycles and drops."""
    from repro_torch.models import init

    gen = torch.Generator(device=dev).manual_seed(0)
    s = scheduler(cfg, rc, init(cfg, rc, gen, device=dev), dev, faults=faults)
    done = s.run()
    return {"tokens": {r.rid: list(r.out) for r in done}, "cycles": dict(s.cycles_by_bits),
            "drops": sum(s.tick_dropped_tokens), "fallback_retries": s.fallback_retries}


def mesh_run(torch, name, cfg, rc, dev, mesh, backend, mode, want=None, faults=None) -> dict:
    """One mesh serve under ``mode``: its record (tokens and cycles against
    ``want`` where given) and, for an audit, every rank's sites."""
    from repro_torch.launch.mesh import close_rank_pool
    from repro_torch.parallel.serve_mesh import InitShards

    close_rank_pool()                  # the ranks read the mode as they start
    os.environ[MODE], os.environ[TAG] = mode, name
    for f in os.listdir(OUT) if os.path.isdir(OUT) else []:
        if f.startswith(name + "_rank"):
            os.remove(os.path.join(OUT, f))
    t0 = time.perf_counter()
    s = scheduler(cfg, rc, InitShards(cfg, rc, 0, dev.type), dev, mesh=mesh, backend=backend,
                  faults=faults)
    done = s.run()
    wall = time.perf_counter() - t0
    outs = {r.rid: list(r.out) for r in done}
    rec = {"run": name, "mode": mode, "arch": cfg.name, "layers": cfg.num_layers,
           "policy": rc.quant_policy, "mesh": mesh, "backend": backend, "seconds": wall,
           "faults": faults is not None, "fallback_retries": s.fallback_retries,
           "moe_dropped_tokens": s.moe_dropped_tokens,
           "rank_step_s": s.health()["mesh"]["rank_step_s"]}
    if want is not None:
        rec.update(tokens_equal=sum(a == b for r in want["tokens"]
                                    for a, b in zip(want["tokens"][r], outs.get(r, []))),
                   tokens=sum(len(o) for o in want["tokens"].values()),
                   cycles_equal=s.cycles_by_bits == want["cycles"], drops_one_card=want["drops"])
    ticks = s.ticks
    s.close()
    if mode == "audit":
        _dump()                        # rank 0 is this process
        close_rank_pool()              # the other ranks write theirs as they exit
        ranks = {}
        for f in sorted(os.listdir(OUT)):
            if f.startswith(name + "_rank"):
                with open(os.path.join(OUT, f)) as fh:
                    ranks[int(f[len(name) + 5:-5])] = json.load(fh)
        rec["ranks_reported"] = sorted(ranks)
        rec["sites"] = {site: {k: (max if k == "max_abs" else sum)(
            r[site][k] for r in ranks.values() if site in r)
            for k in ("calls", "moved", "max_abs", "padded_ms", "local_ms", "pad_bytes")}
            for site in sorted({k for r in ranks.values() for k in r})}
        rec["moved_shapes"] = {site: {d: r[site]["moved_shapes"] for d, r in ranks.items()
                                      if site in r and r[site]["moved"]}
                               for site in rec["sites"] if rec["sites"][site]["moved"]}
        rec["rank0_cost"] = rank0_cost(torch, ranks.get(0, {}), ticks)
    print(json.dumps(rec), flush=True)
    return rec


def median_ms(torch, fn, reps: int = 25) -> float:
    """Median CUDA-event ms of ``fn()`` on an idle card, after a warm-up."""
    import statistics

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def rank0_cost(torch, audit: dict, ticks: int) -> dict:
    """What the padding costs rank 0 a tick: each site's first call of each
    shape timed again, padded and at the rank's shape, with the pool stopped
    (the card idle but for this process), weighted by how often rank 0 made
    that call; and the bytes the padding wrote a tick."""
    from repro_torch.parallel.collectives import MeshProgram

    out = {}
    if not torch.cuda.is_available():
        CALLS.clear()
        return out
    os.environ[MODE] = "code"
    for (site, key), (prog, fn, operands) in sorted(CALLS.items()):
        n = audit.get(site, {}).get("shapes", {}).get(key, 0)
        p_ms = median_ms(torch, lambda: prog.at_full(site, fn, *operands))
        l_ms = median_ms(torch, lambda: fn(*(x for x, _ in operands)))
        o = out.setdefault(site, {"extra_ms_per_tick": 0.0, "pad_bytes_per_tick": 0.0,
                                  "shapes": {}})
        o["shapes"][key] = {"calls": n, "padded_ms": p_ms, "local_ms": l_ms}
        o["extra_ms_per_tick"] += n * (p_ms - l_ms) / max(ticks, 1)
    for site, o in out.items():
        o["pad_bytes_per_tick"] = audit.get(site, {}).get("pad_bytes", 0) / max(ticks, 1)
    CALLS.clear()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    import subprocess

    import torch

    from repro_torch import resolve_device
    from repro_torch.configs.base import RunConfig, get_config
    from repro_torch.launch.mesh import close_rank_pool

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip()
        print(json.dumps({"nvidia_smi": smi, "torch": torch.__version__}), flush=True)
        moe = get_config("deepseek-v2-lite-16b").replace(num_layers=4)
        dense, dtype = get_config("qwen3-0.6b"), "bfloat16"
        moe_mesh, dense_mesh = "2,4", "2,4"
        backend = "nccl" if torch.cuda.device_count() >= 8 else "gloo"
    else:
        moe, dense, dtype = (get_config("deepseek-v2-lite-16b_smoke"),
                             get_config("qwen3-0.6b_smoke"), "float32")
        moe_mesh, dense_mesh, backend = "2,4", "4,2", "gloo"
    base = dict(dtype=dtype, param_dtype=dtype, kv_cache_dtype="int8", kv_layout="paged",
                block_size=16, prefill_chunk=16)
    mrc = RunConfig(quant_policy="mla.*=int8,moe.*=int2,mlp.*=int2,*=bf16", **base)
    drc = RunConfig(quant_policy="attn.*=int8,mlp.*=int2,*=bf16", **base)
    t0 = time.perf_counter()

    want = one_card(torch, moe, mrc, dev, None)
    want_f = one_card(torch, moe, mrc, dev, fault_plan())
    runs = [mesh_run(torch, "moe_code", moe, mrc, dev, moe_mesh, backend, "code", want),
            mesh_run(torch, "moe_off", moe, mrc, dev, moe_mesh, backend, "off", want),
            mesh_run(torch, "moe_audit_faults", moe, mrc, dev, moe_mesh, backend, "audit",
                     want_f, fault_plan()),
            mesh_run(torch, "dense_audit", dense, drc, dev, dense_mesh, backend, "audit")]
    close_rank_pool()
    gated = [r for r in runs if r["mode"] != "off" and "tokens" in r]
    print(json.dumps({
        "moved": {r["run"]: sorted(r["moved_shapes"]) for r in runs if "sites" in r},
        "gates_met": all(r["tokens_equal"] == r["tokens"] and r["cycles_equal"]
                         and r["moe_dropped_tokens"] == r["drops_one_card"] for r in gated),
        "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
