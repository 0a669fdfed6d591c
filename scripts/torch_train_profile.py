#!/usr/bin/env python3
"""Where a training step's time goes on the GPU: chip_smoke.py's
``train_dense`` configuration (qwen3-0.6b at full width, 8 x 512 tokens,
bf16, lr 1e-3) under each ``--remat`` mode given, in one process, on the
same weights (seed 0) and the same batch (the data stream's first).

For each mode: one warm-up step (its seconds printed), ``--steps`` timed
steps (host clock around a step ended by ``torch.cuda.synchronize``), one
step split into its parts (the loss forward, the backward, then the f32
cast, clipping and AdamW, each ended by a synchronize), then one step
under ``torch.profiler``: the device's busy time (the union of device-side
activity), its idle share of the profiled wall, kernel launches, and the
top device activities and host ops. One JSON line a mode, with the card's
name and power limit.

    python3 scripts/torch_train_profile.py                  # block, none, full
    python3 scripts/torch_train_profile.py --remat block --steps 5
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))


def main(argv=None) -> int:
    import torch

    import chip_smoke  # noqa: F401  (puts src/ on the path, sets the cuBLAS workspace)

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--remat", action="append", choices=["none", "block", "full"],
                    help="repeatable (default: block, none, full)")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_train_profile: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs.base import RunConfig, ShapeConfig, get_config
    from repro_torch.data import make_batches
    from repro_torch.models import init, model_flops
    from repro_torch.tree import tree_map

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cfg = get_config(args.arch)
    shape = ShapeConfig("train", args.seq_len, args.global_batch, "train")
    it = make_batches(cfg, shape, seed=0)
    batch = {k: v.to("cuda") for k, v in next(it).items()}
    it.close()
    rc0 = RunConfig(dtype="bfloat16", param_dtype="bfloat16")
    host = init(cfg, rc0, torch.Generator().manual_seed(0), device="cpu")
    for remat in args.remat or ["block", "none", "full"]:
        rc = RunConfig(dtype="bfloat16", param_dtype="bfloat16", remat=remat, lr=args.lr,
                       warmup_steps=1, total_steps=1000)
        params = tree_map(lambda t: t.to("cuda", copy=True), host)
        rec = profile_one(torch, cfg, rc, params, batch, args.steps)
        rec.update(arch=cfg.name, layers=cfg.num_layers, seq_len=args.seq_len,
                   global_batch=args.global_batch, remat=remat, card=smi,
                   model_flops_per_step=model_flops(cfg, shape))
        rec["bf16_peak_share"] = (rec["model_flops_per_step"] / (rec["step_ms_median"] / 1e3)
                                  / 989e12)
        print(json.dumps(rec), flush=True)
        del params
    return 0


def profile_one(torch, cfg, rc, params, batch, steps: int) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import loss_fn
    from repro_torch.optim import adamw_update
    from repro_torch.train import build_train_step, init_train_state
    from repro_torch.tree import leaves, unflatten_like
    from torch_serve_profile import device_activity

    state = init_train_state(cfg, rc, params)
    step = build_train_step(cfg, rc)
    torch.cuda.reset_peak_memory_stats()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    (state, _), first_ms = timed(lambda: step(state, batch))
    step_ms = []
    for _ in range(steps):
        (state, _), ms = timed(lambda: step(state, batch))
        step_ms.append(ms)
    flat = leaves(state["params"])
    (total, _), fwd_ms = timed(lambda: loss_fn(cfg, rc, state["params"], batch))
    grads, bwd_ms = timed(lambda: torch.autograd.grad(total, flat))
    del total
    _, opt_ms = timed(lambda: adamw_update(
        unflatten_like(state["params"], [g.to(torch.float32) for g in grads]), state["opt"], rc,
        state["params"]))
    del grads
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        (state, _), prof_ms = timed(lambda: step(state, batch))
    busy_us, by_name = device_activity(prof.events(), DeviceType.CUDA)
    top = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)
    host = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total, reverse=True)
    launches = sum(e.count for e in host if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                                      "cudaLaunchKernelExC"))
    return {"phase": "train_profile", "first_step_ms": first_ms, "step_ms": step_ms,
            "step_ms_median": statistics.median(step_ms),
            "split_ms": {"loss_forward": fwd_ms, "backward": bwd_ms, "optimizer": opt_ms},
            "peak_memory_gb": peak / 1e9, "profiled_step_ms": prof_ms,
            "device_busy_ms": busy_us / 1e3, "device_idle_share": 1.0 - busy_us / 1e3 / prof_ms,
            "launches": launches, "device_events": sum(c for _, c in by_name.values()),
            "top_device": [{"name": k[:80], "ms": v[0] / 1e3, "calls": v[1],
                            "share_of_busy": v[0] / busy_us} for k, v in top[:15]],
            "top_host_self": [{"name": e.key[:80], "ms": e.self_cpu_time_total / 1e3,
                               "calls": e.count} for e in host[:12]]}


if __name__ == "__main__":
    sys.exit(main())
