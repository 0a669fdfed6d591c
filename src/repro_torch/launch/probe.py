"""Perf-iteration probe (the reference's ``repro/launch/probe.py``): price
one cell with RunConfig / rule overrides and print the roofline forensics,
the three terms, the top byte charges and the top collectives.

    PYTHONPATH=src python -m repro_torch.launch.probe --arch deepseek-v2-lite-16b \\
        --shape decode_32k --set kv_cache_dtype=int8 --rule embed=None

The cell runs as ``launch/dryrun.py`` runs it: rank 0's program of the
production mesh on ``meta`` tensors, its terms priced on the ``h100``
profile (a price from counts, not a measurement). ``--dump`` writes the op
trace as JSON lines (op, ``named_scope`` label, bytes, FLOPs, shape) where
the reference writes its optimized HLO.

``--energy`` runs the quantized-inference energy cell instead: surger the
model onto the fused tuGEMM path, execute one forward with per-layer stats
capture, and print the cycles -> PPA energy report (``core.report``). It
executes on the card (the fused GEMM and its stats kernel) unless
``--device cpu`` is given; a missing card raises. The weights are drawn on
the device by an explicit generator from ``--seed``.

``--policy`` takes the declarative per-layer QuantPolicy: the
``pattern=kind[:mode]`` grammar, inline JSON, or ``@policy.json`` / a
``.json`` path. It applies to both modes and supersedes the deprecated
``--set gemm_backend=...``.

    python -m repro_torch.launch.probe --arch qwen3-0.6b --energy \\
        --policy "attn.*=int8,mlp.*=int2,*=bf16" --batch 4 --seq 64
    python -m repro_torch.launch.probe --arch qwen3-0.6b_smoke --energy \\
        --policy "*=int4:prequant" --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from ..configs.base import SHAPES, RunConfig, get_config
from ..models import model_flops
from ..roofline.analysis import HW_PROFILES, analyze
from ..roofline.op_cost import count_ops
from .dryrun import build_cell, cell_runconfig
from .mesh import make_production_mesh

__all__ = ["probe", "energy_probe", "main"]


def _coerce(v: str):
    if v in ("None", "none", "null"):
        return None
    if v in ("True", "False"):
        return v == "True"
    for t in (int, float):
        try:
            return t(v)
        except ValueError:
            pass
    return v


def _load_policy(text: str | None):
    from ..quant.policy import load_policy

    return load_policy(text)


def probe(arch, shape_name, sets=(), rules=(), multi_pod=False, dump=None,
          label="probe", policy=None):
    """Price one cell with overrides; print and return its RooflineReport."""
    shape = SHAPES[shape_name]
    rc = cell_runconfig(arch, shape)
    overrides = dict(rc.sharding_overrides)
    kw = {}
    for s in sets:
        k, v = s.split("=", 1)
        kw[k] = _coerce(v)
    pol = _load_policy(policy)
    if pol is not None:
        kw["quant_policy"] = pol
    for r in rules:
        k, v = r.split("=", 1)
        overrides[k] = _coerce(v)
    rc = dataclasses.replace(rc, **kw, sharding_overrides=overrides)

    mesh = make_production_mesh(multi_pod=multi_pod)
    t0 = time.time()
    cell = build_cell(arch, shape, rc, mesh)
    with torch.no_grad() if shape.kind != "train" else torch.enable_grad():
        with count_ops(trace=bool(dump)) as cost:
            cost.hold(cell.state)
            meter = cell.run()
    dt = time.time() - t0

    hw = HW_PROFILES["h100"]
    peak = float(cost.peak_bytes)
    rep = analyze(f"{arch}×{shape_name}", chips=mesh.size, cost=cost,
                  model_flops=model_flops(get_config(arch), shape), hw=hw, memory_per_chip=peak)
    print(f"\n=== {label}: {arch}×{shape_name} (traced {dt:.0f}s, peak {peak/1e9:.2f} GB/chip; "
          f"priced on {hw.name}, not measured)")
    print(f"  compute {rep.compute_s*1e3:10.1f} ms   memory {rep.memory_s*1e3:10.1f} ms   "
          f"collective {rep.collective_s*1e3:10.1f} ms   -> {rep.dominant} bound")
    print(f"  useful_ratio {rep.useful_ratio:.2f}   roofline-fraction {rep.mfu*100:.2f}%")
    print("  collectives: " + ", ".join(
        f"{k}={v/1e9:.1f}GB(n={cost.collective_counts.get(k, 0)})"
        for k, v in sorted(rep.collectives.items(), key=lambda kv: -kv[1])))
    print("  top HBM charges:")
    for lab, op, c in cost.top_bytes(10):
        print(f"    {c['bytes']/1e9:8.2f} GB  x{c['calls']:<5} {op:<28} {lab or '-':<14} "
              f"{list(c['shape'])}")

    def moved(r):
        return r.get("wire_bytes", r.get("payload_bytes", 0) + r.get("scale_bytes", 0))

    if meter:
        print("  top collectives (by label):")
        for name, r in sorted(meter.items(), key=lambda kv: -moved(kv[1]))[:8]:
            print(f"    {moved(r)/1e9:8.3f} GB  x{r['calls']:<5} {name}")
    if dump:
        with open(dump, "w") as f:
            for rec in cost.trace:
                f.write(json.dumps(rec) + "\n")
    return rep


def energy_probe(arch, sets=(), variant="serial", batch=2, seq=8, label="energy",
                 policy=None, device="cuda", seed=0, impl="auto", params=None, tokens=None):
    """Execute one surgered quantized forward and print the per-layer
    cycles -> energy report: under a mixed QuantPolicy every row is charged
    at its own bitwidth, with per-bits subtotals. Returns the EnergyReport.

    ``params`` (a float tree on ``device``) and ``tokens`` ((batch, seq)
    int) replace the weights drawn from ``seed`` and the tokens drawn from
    ``seed + 1``; ``impl`` selects every kernel's path (``torch``: the plain
    versions on the same device)."""
    from .. import resolve_device
    from ..core.report import energy_report
    from ..models import init
    from ..quant import apply_surgery, forward_with_stats
    from ..quant.policy import effective_policy

    dev = resolve_device(device)
    cfg = get_config(arch)
    rc = RunConfig(dtype="float32", param_dtype="float32", remat="none",
                   quant_policy="*=int8")
    legacy_keys = {"gemm_backend", "gemm_mode", "collect_gemm_stats", "quant_layers"}
    kw = {}
    for s in sets:
        k, v = s.split("=", 1)
        kw[k] = v if k == "gemm_backend" else _coerce(v)
    legacy_set = sorted(legacy_keys & kw.keys())
    pol = _load_policy(policy)
    if pol is not None and legacy_set:
        raise SystemExit(
            f"--policy supersedes --set {'/'.join(legacy_set)}; express them "
            f"in the policy spec (pattern=kind[:mode][:stats])")
    if pol is not None:
        kw["quant_policy"] = pol
    elif legacy_set:
        # legacy spellings still honored: drop the default policy so the
        # knobs lower through effective_policy (with its DeprecationWarning)
        kw.setdefault("gemm_backend", "int8")
        kw["quant_policy"] = None
    rc = dataclasses.replace(rc, **kw)
    pol = effective_policy(rc)
    if not pol.is_quant:
        raise SystemExit(
            "--energy needs a quant policy: --policy 'attn.*=int8,mlp.*=int2,"
            "*=bf16' (or --policy '*=int4:prequant')"
        )

    t0 = time.time()
    with torch.no_grad():
        if params is None:
            params = init(cfg, rc, torch.Generator(device=dev).manual_seed(seed), device=dev)
        params = apply_surgery(cfg, rc, params)
        if tokens is None:
            gen = torch.Generator(device=dev).manual_seed(seed + 1)
            tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen, device=dev)
        tokens = torch.as_tensor(tokens, device=dev)
        h, _, _, cap = forward_with_stats(cfg, rc, params, {"tokens": tokens}, caches=None,
                                          cache_pos=None, kv_view=None, impl=impl)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    rep = energy_report(cap, variant=variant)
    print(f"\n=== {label}: {arch} ({tokens.shape[0]}x{tokens.shape[1]} tokens, "
          f"policy {pol.describe()}, ran in {time.time()-t0:.1f}s on {dev.type})")
    print(rep.render())
    return rep


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--set", action="append", default=[], help="RunConfig field=value")
    ap.add_argument("--policy", default=None,
                    help="per-layer mixed-precision QuantPolicy: "
                         "'attn.*=int8,mlp.*=int2,*=bf16' grammar, inline "
                         "JSON, or @file.json / a .json path")
    ap.add_argument("--rule", action="append", default=[], help="sharding rule logical=mesh_axis")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--dump", default=None, help="write the op trace as JSON lines")
    ap.add_argument("--label", default="probe")
    ap.add_argument("--energy", action="store_true",
                    help="run the quantized-inference energy cell (executes a forward)")
    ap.add_argument("--variant", default="serial", choices=["serial", "parallel"])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="--energy: cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.energy:
        return energy_probe(args.arch, args.set, args.variant, args.batch, args.seq,
                            args.label, policy=args.policy, device=args.device, seed=args.seed)
    if args.shape is None:
        ap.error("--shape is required (unless --energy)")
    return probe(args.arch, args.shape, args.set, args.rule, args.multi_pod, args.dump,
                 args.label, policy=args.policy)


if __name__ == "__main__":
    main()
