#!/usr/bin/env python3
"""Where a serving tick's time goes on the GPU: profile the port's paged
scheduler serving chip_smoke.py's serve workload (its ``model_setup`` and
``serving_scheduler``: qwen3-0.6b at full width, 8 requests of 32-128
prompt tokens, 16 new each) under one quantization policy, after
``apply_surgery`` has packed the policy's prequant leaves.

The Scheduler replays its steps as CUDA graphs (``serve/graphs.py``);
``--eager`` runs them eagerly. One Scheduler serves the workload once to
warm up (its first step at each width and, graphed, each width's capture),
then the same requests again under ``torch.profiler`` with CPU and CUDA
activities, and the script prints one JSON line: wall time (profiled, and
the warm-up's without the profiler), the device's busy time (the union of
the intervals of device-side activity: kernels, memcpy and memset; the host
ops that launched them are not counted again), the device's idle share of
the profiled wall, host kernel launches, graph launches, memsets, host
copies and host waits for the card (stream, device and event
synchronizations) per tick, the profiled serve's ``cycles_by_bits``, each
step's eager calls, replays, capture ms and graph pool bytes a width, and
the top device activities and host ops by time.
``--policy`` may be given several times: the policies are profiled in
turn in one process, on the same weights, one line each. ``--moe`` serves
the same workload on deepseek-v2-lite at full width instead
(``chip_smoke.model_setup_moe``), by default under chip_smoke's fused
dynamic and prequant MoE policies. ``--spec-gamma`` serves speculatively
(a draft under ``--draft-policy``, built from the float weights).

    python3 scripts/torch_serve_profile.py          # chip_smoke.POLICY
    python3 scripts/torch_serve_profile.py --eager  # the same, steps run eagerly
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
    ap.add_argument("--eager", action="store_true",
                    help="run the steps eagerly (default: replay CUDA graphs)")
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
    spec = {"graphs": not args.eager}
    if args.spec_gamma:
        rc0 = dataclasses.replace(rc0, spec_gamma=args.spec_gamma,
                                  draft_policy=args.draft_policy)
        spec["draft_params"] = params0
    for policy in args.policy or default:
        rc, params = chip_smoke.surgered(cfg, rc0, params0, policy)
        profile_one(torch, chip_smoke, cfg, rc, params, policy, **spec)
        del params
    return 0


def profile_one(torch, chip_smoke, cfg, rc, params, policy: str, **kw) -> None:
    """Serve once to warm up, then the same requests again on the same
    Scheduler under the profiler; print the line. ``kw`` goes to the
    Scheduler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import Request

    sched, prompts = chip_smoke.serving_scheduler(cfg, rc, params, "auto", **kw)

    def serve():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sched.run()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    wall_unprofiled = serve()
    ticks0, laps0 = sched.ticks, len(sched.tick_seconds)
    cyc0 = {b: dict(d) for b, d in sched.cycles_by_bits.items()}
    drafted0, accepted0 = sched.drafted_tokens, sched.accepted_draft_tokens
    for i, p in enumerate(prompts):
        sched.submit(Request(rid=len(prompts) + i, prompt=p, max_new=16))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = serve()
    ticks, laps = sched.ticks - ticks0, sorted(sched.tick_seconds[laps0:])
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
    graph_launches = sum(e.count for e in host if e.key in ("cudaGraphLaunch", "cuGraphLaunch"))
    print(json.dumps({
        "phase": "serve_profile", "arch": cfg.name, "layers": cfg.num_layers,
        "policy": policy, "graphs": sched.graphs, "wall_s": wall,
        "wall_unprofiled_s": wall_unprofiled, "ticks": ticks,
        "median_tick_ms": 1e3 * laps[len(laps) // 2],
        "launches_per_tick": launches / ticks,
        "graph_launches_per_tick": graph_launches / ticks,
        "memsets_per_tick": memsets / ticks,
        "host_copies_per_tick": copies / ticks,
        "host_waits_per_tick": waits / ticks,
        "spec_gamma": rc.spec_gamma, "draft_policy": rc.draft_policy if rc.spec_gamma else None,
        "drafted_tokens": sched.drafted_tokens - drafted0,
        "accepted_draft_tokens": sched.accepted_draft_tokens - accepted0,
        "cycles_by_bits": {str(b): {k: v - cyc0.get(b, {}).get(k, 0) for k, v in d.items()}
                           for b, d in sorted(sched.cycles_by_bits.items())},
        "step_counts": sched.step_counts(),
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
