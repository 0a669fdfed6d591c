#!/usr/bin/env python3
"""Device time of the fused and int8 tuGEMM kernels under other split plans
than ``kernels/tugemm_fused.py::split_plan`` picks: for each case, every
plan of a list (tile width, K splits) with and without the cycle stats,
read from ``torch.profiler`` as ``chip_smoke.py``'s device_time phase reads
it (median of 10 flushed calls, the summed device events of one call).
Prints one JSON line per (case, plan); outputs are checked bit for bit
against the plain version once per case.

    python3 scripts/tugemm_plan_sweep.py
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def plans(Kw: int, picked):
    """(bn, splits, chunks) for every tile width and split count of 2, 4, 6,
    8, 12 or 16 blocks, and the picked plan."""
    from repro_torch.kernels.tugemm_fused import KC

    k_chunks = -(-Kw // KC)
    out = [picked]
    for bn in (32, 64, 128):
        for s in (2, 4, 6, 8, 12, 16):
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
    from repro_torch.kernels.ops import pack_weights
    from repro_torch.quant.quantize import compute_scale

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

    def fused_case(name, M, K, N, mode, bits):
        x = torch.randn(M, K, device=dev, generator=gen).to(bf16)
        sx = compute_scale(x, bits).reshape(1, 1)
        if mode == "quant":
            w = (torch.randn(K, N, device=dev, generator=gen) * 0.02).to(bf16)
            sw = compute_scale(w, bits, axis=1).reshape(1, N)
        else:
            lo = -(2 ** (bits - 1))
            wq = torch.randint(lo, -lo, (K, N), device=dev, generator=gen, dtype=torch.int8)
            w = pack_weights(wq, bits)
            sw = torch.rand(1, N, device=dev, generator=gen) * 1e-3 + 1e-4
        planes = K // w.shape[0]
        return name, (x, w, sx, sw, None), dict(bits=bits, w_mode=mode, out_dtype=bf16), planes

    cases = [fused_case("one block 4x64x32 quant8", 4, 64, 32, "quant", 8),
             fused_case("q 64x1024x2048 quant8", 64, 1024, 2048, "quant", 8),
             fused_case("k 64x1024x1024 quant8", 64, 1024, 1024, "quant", 8),
             fused_case("o 64x2048x1024 quant8", 64, 2048, 1024, "quant", 8),
             fused_case("gate 64x1024x3072 quant2", 64, 1024, 3072, "quant", 2),
             fused_case("down 64x3072x1024 quant2", 64, 3072, 1024, "quant", 2),
             fused_case("gate 64x1024x3072 packed2", 64, 1024, 3072, "packed", 2),
             fused_case("down 64x3072x1024 packed2", 64, 3072, 1024, "packed", 2),
             fused_case("k 4x1024x1024 packed2", 4, 1024, 1024, "packed", 2)]
    for name, args, kw, planes in cases:
        x, w = args[0], args[1]
        M, N, Kw = x.shape[0], w.shape[1], w.shape[0]
        want = fused_mod.tugemm_fused(*args, impl="torch", collect_stats=True, **kw)
        for plan in plans(Kw, picked(M, N, Kw, planes, sms)):
            fused_mod.split_plan = lambda *a, plan=plan: plan
            got = fused_mod.tugemm_fused(*args, impl="cuda", collect_stats=True, **kw)
            torch.cuda.synchronize()
            exact = all(torch.equal(a, b) for a, b in zip(got, want))
            for collect in (True, False):
                ms, source, launches = chip_smoke.device_ms(
                    torch, lambda: fused_mod.tugemm_fused(*args, impl="cuda",
                                                          collect_stats=collect, **kw), flush)
                print(json.dumps({"kernel": "tugemm_fused", "case": name, "bn": plan[0],
                                  "splits": plan[1], "chunks": plan[2], "collect": collect,
                                  "blocks": plan[1] * -(-N // plan[0]) * -(-M // 64),
                                  "picked": plan == picked(M, N, Kw, planes, sms),
                                  "exact": exact, "device_ms": ms, "source": source,
                                  "launches": launches}), flush=True)
        fused_mod.split_plan = picked

    a = torch.randint(-128, 128, (64, 1024), device=dev, generator=gen, dtype=torch.int8)
    b = torch.randint(-128, 128, (1024, 2048), device=dev, generator=gen, dtype=torch.int8)
    want = int8_mod.tugemm_int8(a, b, impl="torch")
    for plan in plans(1024, picked(64, 2048, 1024, 1, sms)):
        int8_mod.split_plan = lambda *a_, plan=plan: plan
        exact = torch.equal(int8_mod.tugemm_int8(a, b, impl="cuda"), want)
        ms, source, launches = chip_smoke.device_ms(
            torch, lambda: int8_mod.tugemm_int8(a, b, impl="cuda"), flush)
        print(json.dumps({"kernel": "tugemm_int8", "case": "q 64x1024x2048", "bn": plan[0],
                          "splits": plan[1], "chunks": plan[2],
                          "blocks": plan[1] * -(-2048 // plan[0]),
                          "picked": plan == picked(64, 2048, 1024, 1, sms), "exact": exact,
                          "device_ms": ms, "source": source, "launches": launches}), flush=True)
    int8_mod.split_plan = picked
    return 0


if __name__ == "__main__":
    sys.exit(main())
