#!/usr/bin/env python3
"""Where a serving tick's time goes on the GPU: profile the port's paged
scheduler serving chip_smoke.py's serve workload (its ``model_setup`` and
``serving_scheduler``: qwen3-0.6b at full width, 8 requests of 32-128
prompt tokens, 16 new each) under one quantization policy, after
``apply_surgery`` has packed the policy's prequant leaves.

Runs the workload once to warm up, then once under ``torch.profiler`` with
CPU and CUDA activities, and prints one JSON line: wall time (profiled, and
the warm-up's without the profiler), the device's busy time (the union of
the intervals of device-side activity: kernels, memcpy and memset; the host
ops that launched them are not counted again), the device's idle share of
the profiled wall, kernel launches, memsets, host copies and host waits
for the card (stream, device and event synchronizations) per tick, the
serve's ``cycles_by_bits``, and the top device activities and host ops by
time.
``--policy`` may be given several times: the policies are profiled in
turn in one process, on the same weights, one line each. ``--moe`` serves
the same workload on deepseek-v2-lite at full width instead
(``chip_smoke.model_setup_moe``), by default under chip_smoke's fused
dynamic and prequant MoE policies. ``--spec-gamma`` serves speculatively
(a draft under ``--draft-policy``, built from the float weights).

    python3 scripts/torch_serve_profile.py          # chip_smoke.POLICY
    python3 scripts/torch_serve_profile.py --policy 'attn.*=int8:unfused,mlp.*=int2:prequant:unfused,*=bf16'
    python3 scripts/torch_serve_profile.py --moe
    python3 scripts/torch_serve_profile.py --spec-gamma 4 --policy 'attn.*=int8:per_token,mlp.*=int2:per_token,*=bf16'
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def device_activity(events, cuda_type):
    """Busy microseconds (union of intervals) and per-name totals of the
    device-side events; host-side op events are skipped, since their device
    time is the sum of the kernels they launched, and so are the
    ``obs.named_scope`` ranges (``serve/step`` and the like), which the
    profiler also puts on the device's timeline and which span whole steps,
    idle gaps included."""
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in events if e.device_type == cuda_type
                   and not (getattr(e, "is_user_annotation", False)
                            or e.name.startswith("serve/")))
    busy, end = 0.0, float("-inf")
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for s, t, name in spans:
        busy += max(0.0, t - max(s, end))
        end = max(end, t)
        by_name[name][0] += t - s
        by_name[name][1] += 1
    return busy, by_name


def main(argv=None) -> int:
    import torch

    import chip_smoke

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--policy", action="append",
                    help=f"QuantPolicy grammar, repeatable (default: {chip_smoke.POLICY})")
    ap.add_argument("--moe", action="store_true",
                    help="deepseek-v2-lite at full width (default policies: "
                         f"{chip_smoke.MOE_POLICY} and {chip_smoke.MOE_PREQUANT_POLICY})")
    ap.add_argument("--spec-gamma", type=int, default=0,
                    help="speculative decoding with this many drafts a tick (default 0: off)")
    ap.add_argument("--draft-policy", default="*=int2",
                    help="the draft's QuantPolicy under --spec-gamma (default *=int2)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_serve_profile: needs a CUDA device", file=sys.stderr)
        return 2
    if args.moe:
        cfg, rc0, params0, _ = chip_smoke.model_setup_moe(torch)
        default = [chip_smoke.MOE_POLICY, chip_smoke.MOE_PREQUANT_POLICY]
    else:
        cfg, rc0, params0, _ = chip_smoke.model_setup(torch)
        default = [chip_smoke.POLICY]
    spec = {}
    if args.spec_gamma:
        rc0 = dataclasses.replace(rc0, spec_gamma=args.spec_gamma,
                                  draft_policy=args.draft_policy)
        spec = {"draft_params": params0}
    for policy in args.policy or default:
        rc, params = chip_smoke.surgered(cfg, rc0, params0, policy)
        profile_one(torch, chip_smoke, cfg, rc, params, policy, **spec)
        del params
    return 0


def profile_one(torch, chip_smoke, cfg, rc, params, policy: str, **kw) -> None:
    """Serve once to warm up, once under the profiler; print the line.
    ``kw`` goes to the Scheduler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def serve():
        s, _ = chip_smoke.serving_scheduler(cfg, rc, params, "auto", **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.run()
        torch.cuda.synchronize()
        return s, time.perf_counter() - t0

    _, wall_unprofiled = serve()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sched, wall = serve()
    busy_us, by_name = device_activity(prof.events(), DeviceType.CUDA)
    if busy_us <= 0:
        raise RuntimeError("the profile holds no device-side events")
    top = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)
    host = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total, reverse=True)
    launches = sum(e.count for e in host if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                                      "cudaLaunchKernelExC"))
    memsets = sum(e.count for e in host if e.key == "cudaMemsetAsync")
    copies = sum(e.count for e in host if e.key in ("cudaMemcpyAsync", "cudaMemcpy"))
    waits = sum(e.count for e in host if e.key in ("cudaStreamSynchronize",
                                                   "cudaDeviceSynchronize",
                                                   "cudaEventSynchronize"))
    print(json.dumps({
        "phase": "serve_profile", "arch": cfg.name, "layers": cfg.num_layers,
        "policy": policy, "wall_s": wall,
        "wall_unprofiled_s": wall_unprofiled, "ticks": sched.ticks,
        "median_tick_ms": 1e3 * sorted(sched.tick_seconds)[len(sched.tick_seconds) // 2],
        "launches_per_tick": launches / sched.ticks,
        "memsets_per_tick": memsets / sched.ticks,
        "host_copies_per_tick": copies / sched.ticks,
        "host_waits_per_tick": waits / sched.ticks,
        "spec_gamma": rc.spec_gamma, "draft_policy": rc.draft_policy if rc.spec_gamma else None,
        "drafted_tokens": sched.drafted_tokens,
        "accepted_draft_tokens": sched.accepted_draft_tokens,
        "cycles_by_bits": {str(b): d for b, d in sorted(sched.cycles_by_bits.items())},
        "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "device_events": sum(c for _, c in by_name.values()),
        "top_device": [{"name": k[:80], "ms": v[0] / 1e3, "calls": v[1],
                        "share_of_busy": v[0] / busy_us} for k, v in top[:20]],
        "top_host_self": [{"name": e.key[:80], "ms": e.self_cpu_time_total / 1e3,
                           "calls": e.count} for e in host[:12]],
    }), flush=True)


if __name__ == "__main__":
    sys.exit(main())
