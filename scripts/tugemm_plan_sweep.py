#!/usr/bin/env python3
"""Device time of the tuGEMM kernels on the shared split-K mainloop (the
fused, int8 and plane-packed GEMMs) under other split plans than
``kernels/tugemm_fused.py::split_plan`` picks: for each case, every plan of
a list (tile width, K splits), the fused GEMM with and without the cycle
stats, read from ``torch.profiler`` as ``chip_smoke.py``'s device_time
phase reads it (median of 10 flushed calls, the summed device events of one
call; one profile holds up to 16 calls). Prints one JSON line per (case,
plan), outputs checked bit for bit against the plain version under every
plan, then one ``summary`` line per case: the picked plan's time against
the fastest plan's (the fused GEMM's with stats, as the serve runs it).
``--experts`` sweeps the fused GEMM over deepseek-v2-lite's 64 experts
instead (one launch, x (64, 16, K), int2 quantized on load and packed):
each plan then also tries one split.

    python3 scripts/tugemm_plan_sweep.py [--experts]
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def plans(Kw: int, picked, splits=(2, 4, 6, 8, 12, 16)):
    """(bn, splits, chunks) for every tile width and split count of
    ``splits`` blocks, and the picked plan."""
    from repro_torch.kernels.tugemm_fused import KC

    k_chunks = -(-Kw // KC)
    out = [picked]
    for bn in (32, 64, 128):
        for s in splits:
            chunks = -(-k_chunks // s)
            plan = (bn, -(-k_chunks // chunks), chunks)
            if plan not in out:
                out.append(plan)
    return out


def main() -> int:
    import torch

    import chip_smoke
    from repro_torch.kernels import tugemm_fused as fused_mod
    from repro_torch.kernels import tugemm_int8 as int8_mod
    from repro_torch.kernels import tugemm_packed as packed_mod
    from repro_torch.kernels.ops import pack_weights
    from repro_torch.quant.quantize import fused_scales

    if not torch.cuda.is_available():
        print("tugemm_plan_sweep: needs a GPU", file=sys.stderr)
        return 2
    dev = torch.device(chip_smoke.DEVICE)
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read()
    print(smi.strip(), flush=True)
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bf16 = torch.bfloat16
    picked = fused_mod.split_plan

    def i8(shape, bits=8):
        lo = -(2 ** (bits - 1))
        return torch.randint(lo, -lo, shape, device=dev, generator=gen, dtype=torch.int8)

    def fused_case(name, M, K, N, mode, bits, E=None):
        lead = () if E is None else (E,)
        x = torch.randn(*lead, M, K, device=dev, generator=gen).to(bf16)
        if mode == "quant":
            w = (torch.randn(*lead, K, N, device=dev, generator=gen) * 0.02).to(bf16)
            sx, sw = fused_scales(x, w, bits)
        else:
            w = pack_weights(i8((K, N), bits), bits).expand(*lead, -1, -1).contiguous()
            sx = fused_scales(x, torch.ones(*lead, K, N, device=dev), bits)[0]
            sw = torch.rand(*lead, N, device=dev, generator=gen) * 1e-3 + 1e-4
        sx, sw = sx.reshape(lead + (1, 1)), sw.reshape(lead + (1, N))
        planes = K // w.shape[-2]
        kw = dict(bits=bits, w_mode=mode, out_dtype=bf16)
        want = fused_mod.tugemm_fused(x, w, sx, sw, None, impl="torch", collect_stats=True, **kw)
        calls = {collect: (lambda collect=collect: fused_mod.tugemm_fused(
            x, w, sx, sw, None, impl="cuda", collect_stats=collect, **kw))
            for collect in (True, False)}
        return (name, "tugemm_fused", fused_mod, M, N, w.shape[-2], planes, x.element_size(),
                calls, lambda got: all(torch.equal(g, h) for g, h in zip(got, want)), E or 1)

    def int8_case(name, M, K, N):
        a, b = i8((M, K)), i8((K, N))
        want = int8_mod.tugemm_int8(a, b, impl="torch")
        return (name, "tugemm_int8", int8_mod, M, N, K, 1, 1,
                {None: lambda: int8_mod.tugemm_int8(a, b, impl="cuda")},
                lambda got: torch.equal(got, want), 1)

    def packed_case(name, M, K, N, bits):
        a = i8((M, K))
        pb = pack_weights(i8((K, N), bits), bits)
        want = packed_mod.tugemm_packed(a, pb, bits=bits, impl="torch")
        return (name, "tugemm_packed", packed_mod, M, N, pb.shape[0], 8 // bits, 1,
                {None: lambda: packed_mod.tugemm_packed(a, pb, bits=bits, impl="cuda")},
                lambda got: torch.equal(got, want), 1)

    cases = [fused_case("one block 4x64x32 quant8", 4, 64, 32, "quant", 8),
             fused_case("q 64x1024x2048 quant8", 64, 1024, 2048, "quant", 8),
             fused_case("k 64x1024x1024 quant8", 64, 1024, 1024, "quant", 8),
             fused_case("o 64x2048x1024 quant8", 64, 2048, 1024, "quant", 8),
             fused_case("gate 64x1024x3072 quant2", 64, 1024, 3072, "quant", 2),
             fused_case("down 64x3072x1024 quant2", 64, 3072, 1024, "quant", 2),
             fused_case("gate 64x1024x3072 packed2", 64, 1024, 3072, "packed", 2),
             fused_case("down 64x3072x1024 packed2", 64, 3072, 1024, "packed", 2),
             fused_case("gate 64x1024x3072 packed4", 64, 1024, 3072, "packed", 4),
             fused_case("down 64x3072x1024 packed4", 64, 3072, 1024, "packed", 4),
             fused_case("gate 4x1024x3072 packed2", 4, 1024, 3072, "packed", 2),
             fused_case("down 4x3072x1024 packed2", 4, 3072, 1024, "packed", 2),
             fused_case("k 4x1024x1024 packed2", 4, 1024, 1024, "packed", 2),
             fused_case("q 64x1024x2048 packed2", 64, 1024, 2048, "packed", 2),
             fused_case("q 64x1024x2048 packed4", 64, 1024, 2048, "packed", 4),
             fused_case("k 64x1024x1024 packed4", 64, 1024, 1024, "packed", 4),
             fused_case("o 64x2048x1024 packed2", 64, 2048, 1024, "packed", 2),
             fused_case("o 4x2048x1024 packed2", 4, 2048, 1024, "packed", 2),
             int8_case("q 64x1024x2048", 64, 1024, 2048)]
    for M in (64, 4):
        cases += [packed_case(f"gate {M}x1024x3072 int2", M, 1024, 3072, 2),
                  packed_case(f"down {M}x3072x1024 int2", M, 3072, 1024, 2),
                  packed_case(f"gate {M}x1024x3072 int4", M, 1024, 3072, 4),
                  packed_case(f"down {M}x3072x1024 int4", M, 3072, 1024, 4)]
    splits = (2, 4, 6, 8, 12, 16)
    if "--experts" in sys.argv[1:]:
        E, M = chip_smoke.MOE_EXPERTS, chip_smoke.MOE_M
        cases = [fused_case(f"experts {n} {E}x{M}x{K}x{N} {mode}2", M, K, N, mode, 2, E)
                 for n, K, N in chip_smoke.MOE_GEMMS for mode in ("quant", "packed")]
        splits = (1, 2, 4, 8, 16)

    for name, kernel, mod, M, N, Kw, planes, xbytes, calls, exact_of, E in cases:
        chosen = picked(M, N, Kw, planes, sms, xbytes, E)
        grid, fns = [], []
        for plan in plans(Kw, chosen, splits):
            def set_plan(*_, plan=plan):
                return plan
            mod.split_plan = set_plan
            exact = exact_of(next(iter(calls.values()))())   # with stats, where it has them
            for collect, call in calls.items():
                def fn(call=call, set_plan=set_plan):
                    mod.split_plan = set_plan
                    return call()
                grid.append((plan, collect, exact))
                fns.append(fn)
        times = chip_smoke.device_ms_many(torch, fns, flush)
        mod.split_plan = picked
        best = {}
        for (plan, collect, exact), (ms, source, launches, _) in zip(grid, times):
            print(json.dumps({"kernel": kernel, "case": name, "bn": plan[0], "splits": plan[1],
                              "chunks": plan[2], "collect": collect,
                              "blocks": plan[1] * -(-N // plan[0]) * E * -(-M // 64),
                              "picked": plan == chosen, "exact": exact, "device_ms": ms,
                              "source": source, "launches": launches}), flush=True)
            if not exact:
                raise AssertionError(f"{kernel} {name} under plan {plan} is not exact")
            if collect is not False:
                best[plan] = ms
        fastest = min(best, key=best.get)
        print(json.dumps({"summary": name, "kernel": kernel, "planes": planes,
                          "picked": chosen, "picked_ms": best[chosen], "best": fastest,
                          "best_ms": best[fastest], "miss": best[chosen] / best[fastest] - 1}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
