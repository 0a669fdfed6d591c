"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``
(the reference's ``repro/launch/serve.py``, its flags, defaults, fallbacks
and summary lines, plus ``--device``).

Spins up the block-managed, continuously-batched Scheduler (chunked prefill
+ decode packed into one mixed step per tick) on synthetic prompts and
reports throughput/latency; SSM/hybrid stacks fall back to the legacy dense
Engine (``--engine legacy`` forces it). Prompts come from
``np.random.default_rng(seed)``, as in the reference, so both launchers
serve the same prompts.

Serves on the card in bf16 (weights drawn there by a CUDA generator) unless
``--device cpu`` (f32, the plain PyTorch versions); asking for the card
without one raises.

``--mesh DP,TP`` shards the Scheduler's step over ``DP·TP`` ranks
(``parallel/serve_mesh.py``, ``launch/mesh.py``): this process is rank 0,
``--mesh-backend`` must name ``gloo`` (every rank on ``--device``: the CPU,
or one shared card) or ``nccl`` (rank r on ``cuda:r``), and the summary
gains a ``mesh:`` line. ``--devices N`` says how many ranks the
machine may start (the reference's N host devices; default: as many as the
mesh wants).

``--data D --model M`` open the reference's mesh context,
``use_mesh(make_local_mesh(D, M))``, around init and serve, so
``health()["sharding"]`` reports its accounting (dropped rules, replicated
dims). At D·M = 1 the serve is unchanged. At D·M > 1 the serve runs on the
rank pool at (D, M), as ``--mesh D,M`` does (the port's only sharded serve;
the reference's runs GSPMD's layout on one process's devices): it needs
``--mesh-backend``, and a ``--mesh`` given too must say the same. The CLI
never serves on one device while the flags ask for D·M (ROADMAP C).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from .. import resolve_device
from ..configs.base import RunConfig, get_config
from ..models import init
from ..parallel.sharding import use_mesh
from ..quant import apply_surgery
from ..quant.policy import load_policy
from ..serve import AdmissionController, Engine, Request, Scheduler, install_sigint_drain

__all__ = ["main"]


def main(argv=None, *, params=None):
    """Parse ``argv`` (default ``sys.argv``), serve, print the summary and
    return the finished requests. ``params`` replaces the seeded random
    weights (a tree already on the device, e.g. carried across by
    ``interop.params_from_reference``); the command line never passes it."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--capacity", type=int, default=128)
    ap.add_argument("--engine", default="scheduler", choices=["scheduler", "legacy"],
                    help="scheduler = chunked-prefill mixed step; legacy = "
                         "dense slot pool with one-shot B=1 prefill")
    ap.add_argument("--kv-layout", default="dense", choices=["dense", "paged"])
    ap.add_argument("--block-size", type=int, default=16,
                    help="tokens per KV page (paged layout)")
    ap.add_argument("--prefill-chunk", type=int, default=16,
                    help="scheduler prompt chunk width (mixed-step columns)")
    ap.add_argument("--token-budget", type=int, default=0,
                    help="per-tick scheduled-token cap (0 = rows*chunk)")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="paged pool size (0 = dense-equivalent)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share block-aligned prompt prefixes across requests "
                         "via ref-counted copy-on-write pages (paged layout only)")
    ap.add_argument("--kv-dtype", default="bfloat16", choices=["bfloat16", "int8"])
    ap.add_argument("--gemm-backend", default="bf16", choices=["bf16", "int8", "int4", "int2"],
                    help="uniform precision (shorthand for --policy '*=<kind>')")
    ap.add_argument("--policy", default=None,
                    help="per-layer mixed-precision QuantPolicy, e.g. "
                         "'attn.*=int8,mlp.*=int2,*=bf16'")
    ap.add_argument("--spec-gamma", type=int, default=0,
                    help="speculative decoding: draft N tokens per decode "
                         "tick against the --draft-policy view and verify "
                         "them in one mixed step (0 = off)")
    ap.add_argument("--draft-policy", default="*=int2",
                    help="QuantPolicy for the speculative draft pass "
                         "(ignored unless --spec-gamma > 0)")
    ap.add_argument("--mesh", default=None, metavar="DP,TP",
                    help="shard the scheduler's mixed step over a dp×tp mesh of "
                         "ranks (tensor/expert-parallel with quantize-before-"
                         "all-gather). Scheduler engine only, e.g. --mesh 2,4")
    ap.add_argument("--devices", type=int, default=0,
                    help="ranks the machine may start for --mesh (the reference's "
                         "N host devices; 0 = as many as the mesh wants)")
    ap.add_argument("--mesh-backend", default=None, choices=["gloo", "nccl"],
                    help="needed with --mesh: gloo puts every rank on --device "
                         "(the CPU or one shared card); nccl puts rank r on cuda:r")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    # robustness / admission control (scheduler engine)
    ap.add_argument("--queue-bound", type=int, default=0,
                    help="per-class admission queue bound (0 = unbounded)")
    ap.add_argument("--ttl-ticks", type=int, default=0,
                    help="per-request TTL in scheduler ticks (0 = none); "
                         "expired work is shed before it runs")
    ap.add_argument("--tenant-budget", type=int, default=0,
                    help="token budget for the 'default' tenant (0 = none)")
    ap.add_argument("--priority", default="interactive",
                    choices=["realtime", "interactive", "batch"],
                    help="priority class for the synthetic requests")
    ap.add_argument("--energy", action="store_true",
                    help="track per-request SlotMeter energy and print the "
                         "summary at exit (survives a SIGINT drain)")
    # observability (scheduler engine)
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="record request-lifecycle + tick-phase spans and "
                         "pool/energy counter tracks, and write a Chrome "
                         "trace-event JSON loadable at https://ui.perfetto.dev "
                         "(tokens are bit-identical with tracing on or off)")
    ap.add_argument("--metrics-out", default=None, metavar="OUT.jsonl",
                    help="append one JSON line with the full metrics-registry "
                         "snapshot (counters/gauges/latency histograms) at exit")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="capture a torch.profiler trace of the serve into "
                         "DIR/device_trace.json; the steps carry serve/* "
                         "named ranges that line up with --trace spans by name")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.data * args.model > 1:
        want = f"{args.data},{args.model}"
        if args.mesh is not None and [int(v) for v in args.mesh.split(",")] != [args.data,
                                                                               args.model]:
            raise SystemExit(f"[serve] --mesh {args.mesh} and --data {args.data} --model "
                             f"{args.model} ask for different meshes")
        args.mesh = want
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    dtype = "float32" if dev.type == "cpu" else "bfloat16"
    rc = RunConfig(
        dtype=dtype, param_dtype=dtype, remat="none",
        kv_cache_dtype=args.kv_dtype,
        kv_layout=args.kv_layout, block_size=args.block_size,
        prefix_cache=args.prefix_cache,
        prefill_chunk=args.prefill_chunk, token_budget=args.token_budget,
        quant_policy=load_policy(args.policy) or f"*={args.gemm_backend}",
        spec_gamma=args.spec_gamma,
        draft_policy=load_policy(args.draft_policy) if args.spec_gamma else None,
    )
    rng = np.random.default_rng(args.seed)

    use_scheduler = args.engine == "scheduler" and cfg.family not in ("ssm", "hybrid")
    if args.engine == "scheduler" and not use_scheduler:
        print(f"[serve] {cfg.family} mixer state is not chunk-resumable — "
              "falling back to the legacy engine")
    if not use_scheduler and rc.kv_layout != "dense":
        # the legacy engine only speaks the dense slot layout
        print("[serve] legacy engine: forcing --kv-layout dense")
        rc = dataclasses.replace(rc, kv_layout="dense", prefix_cache=False)
    elif rc.prefix_cache and rc.kv_layout != "paged":
        print("[serve] --prefix-cache needs --kv-layout paged: disabling")
        rc = dataclasses.replace(rc, prefix_cache=False)
    if not use_scheduler and rc.spec_gamma:
        print("[serve] legacy engine cannot speculate: disabling --spec-gamma")
        rc = dataclasses.replace(rc, spec_gamma=0, draft_policy=None)
    if args.mesh and not use_scheduler:
        raise SystemExit("[serve] --mesh needs the scheduler engine")
    if args.mesh and rc.spec_gamma:
        print("[serve] speculative decoding is single-device: disabling --spec-gamma")
        rc = dataclasses.replace(rc, spec_gamma=0, draft_policy=None)
    if args.mesh:
        from ..parallel.serve_mesh import as_spec, validate

        if args.mesh_backend is None:
            ap.error("--mesh needs --mesh-backend: gloo (every rank on --device) or nccl "
                     "(rank r on cuda:r)")
        validate(cfg, rc, as_spec(args.mesh), args.max_batch, world=args.devices or None)

    from .mesh import make_local_mesh

    with use_mesh(make_local_mesh(args.data, args.model)):
        return _serve(args, cfg, rc, dev, rng, use_scheduler, params)


def _serve(args, cfg, rc, dev, rng, use_scheduler, params):
    """Init, serve and print the summary under the caller's mesh context."""
    if params is None:
        params = init(cfg, rc, torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    # the draft weight view must derive from the float tree BEFORE the
    # target policy's surgery packs any leaf (packed leaves pin their own
    # bitwidth and would run the draft at target precision): the Scheduler
    # gets the pre-surgery params for its SpecDecoder
    draft_params = params if (use_scheduler and rc.spec_gamma) else None
    # pack any prequant rules offline (identity for dynamic/bf16 policies)
    params = apply_surgery(cfg, rc, params)
    if use_scheduler:
        adm = AdmissionController(
            max_queue=args.queue_bound or None,
            tenant_budgets=({"default": args.tenant_budget} if args.tenant_budget else None),
            default_ttl=args.ttl_ticks or None,
        )
        tracer = None
        if args.trace:
            from ..obs.trace import Tracer

            tracer = Tracer()
        eng = Scheduler(
            cfg, rc, params,
            capacity=args.capacity, max_batch=args.max_batch,
            num_pages=args.num_pages or None,
            temperature=args.temperature, seed=args.seed,
            draft_params=draft_params,
            admission=adm, track_energy=args.energy,
            tracer=tracer, device=dev, mesh=args.mesh, mesh_backend=args.mesh_backend,
        )
    else:
        eng = Engine(
            cfg, rc, params,
            capacity=args.capacity, max_batch=args.max_batch,
            temperature=args.temperature, seed=args.seed, device=dev,
        )
    for rid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, size=args.prompt_len).tolist()
        req = Request(rid=rid, prompt=prompt, max_new=args.max_new)
        if use_scheduler:
            req.priority = args.priority   # a refusal shows in health()'s rejections
        eng.submit(req)
    # graceful shutdown: first ^C drains active slots (energy summaries and
    # health counters survive), second ^C aborts hard
    restore = install_sigint_drain(eng) if use_scheduler else None
    t0 = time.perf_counter()
    try:
        if args.profile_dir:
            from ..obs.profile import device_trace

            with device_trace(args.profile_dir):
                done = eng.run()
        else:
            done = eng.run()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    finally:
        if restore is not None:
            restore()
    dt = time.perf_counter() - t0

    toks = sum(len(r.out) for r in done)
    label = "scheduler" if use_scheduler else "legacy"
    print(f"[serve] {args.arch} ({label}, kv_layout={rc.kv_layout}): "
          f"{len(done)} requests, {toks} tokens "
          f"in {dt:.2f}s ({toks/dt:.1f} tok/s)")
    if use_scheduler:
        print(f"  cache: {eng.cache_stats()}")
        h = eng.health()
        print(f"  health: ladder={h['ladder']['name']} "
              f"(transitions={len(h['ladder']['transitions'])}) "
              f"completed={h['completed']} rejected={h['rejections']} "
              f"preemptions={h['preemptions']} "
              f"deadline_misses={h['deadline_misses']} "
              f"stall_episodes={h['stall_episodes']} "
              f"engine_stalls={h['engine_stalls']}"
              + (" [drained]" if h["draining"] else ""))
        if rc.prefix_cache:
            p = h["prefix_cache"]
            print(f"  prefix: hits={p['hits']} "
                  f"tokens_reused={p['tokens_reused']} "
                  f"prefill_computed={p['prefill_tokens_computed']} "
                  f"cached_pages={p['cached_pages']} "
                  f"evictions={p['evictions']} cow={p['cow_events']}")
        if args.mesh:
            m = h["mesh"]
            c = m["comms"]
            by = {b: r["payload_bytes"] for b, r in c["by_bits"].items()}
            print(f"  mesh: dp={m['dp']} tp={m['tp']} devices={m['devices']} "
                  f"moe_dropped_tokens={m['moe_dropped_tokens']} "
                  f"wire_bytes={c['bytes_moved']} by_bits={by} "
                  f"(bf16 equivalent {c['bf16_bytes']}) backend={m['backend']} "
                  f"interconnect_energy_j={eng.interconnect_report()['energy_j']:.3g}")
            s = h["sharding"]
            if s["dropped_rules"] or s["replicated_dims"]:
                print(f"  sharding: replicated_dims={s['replicated_dims']} "
                      f"dropped_rules={s['dropped_rules']}")
        if rc.spec_gamma:
            s = eng.spec_summary()
            print(f"  spec: gamma={s['spec_gamma']} draft={s['draft_policy']} "
                  f"acceptance={s['acceptance_rate']:.2f} "
                  f"({s['accepted_draft_tokens']}/{s['drafted_tokens']} drafts)")
        if args.energy:
            for m in eng.energy_summary():
                print(f"  energy: rid={m['rid']} tokens={m['tokens']} "
                      f"cycles={m['cycles']:.3g} energy_j={m['energy_j']:.3g}")
        lat = h.get("latency")
        if lat and lat["ttft_s"]["count"]:
            t, i = lat["ttft_s"], lat["itl_s"]
            print(f"  latency: ttft_s p50={t['p50']:.4f} p95={t['p95']:.4f} "
                  f"p99={t['p99']:.4f} (n={t['count']}) | "
                  f"itl_s p50={i['p50']:.4f} p95={i['p95']:.4f} "
                  f"p99={i['p99']:.4f} (n={i['count']})")
        if args.trace:
            from ..obs.trace import trace_summary, validate_chrome_trace

            obj = eng.trace.to_dict()
            validate_chrome_trace(obj)
            eng.trace.export(args.trace)
            ts = trace_summary(obj)
            print(f"  trace: {args.trace} ({ts['events']} events, "
                  f"{ts['spans']} spans, {ts['counters']} counter samples, "
                  f"{ts['request_tracks']} request tracks) — open in "
                  f"https://ui.perfetto.dev")
        if args.metrics_out:
            eng.metrics.emit_jsonl(
                args.metrics_out,
                extra={"arch": args.arch, "engine": "scheduler", "wall_s": round(dt, 3)})
            print(f"  metrics: appended snapshot to {args.metrics_out}")
    for r in done[:3]:
        print(f"  req {r.rid}: {r.out[:8]}...")
    if args.mesh:
        eng.close()         # the ranks free their shards; the rank pool stays up
    return done


if __name__ == "__main__":
    main()
