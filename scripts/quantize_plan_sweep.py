#!/usr/bin/env python3
"""Device time of ``quantize_sym`` on the card, read from ``torch.profiler``
as ``chip_smoke.py``'s device_time phase reads it (median of 10 flushed
calls, the summed device events of one call), in two parts:

1. The route: ``ops.quantize_sym`` on the C1 path's 14 operands of
   qwen3-0.6b (seeded random bf16 at the serve policy's bits: activations
   (64, K) per tensor, weights (K, N) per column) with the scale in each
   form the op takes (0-d and (N,), as ``chip_smoke.py``'s ``c1_operands``
   passes it, then a Python float and (1, N)), and per column on a ragged x
   (37×333, 1024×1004) and on the q weight off 16-byte alignment. Each call
   is checked bit for bit against the op's plain route. One JSON line a
   call, then one ``route`` line a pair of forms: the 14 calls' device ms
   and the most device operations of one call.
2. The grids: the kernel (``kernels/quantize.py::launch``) under the plan
   ``quantize_plan`` picks and under others (u = 1, 2 and 4 rows a batch on
   each block height, each grid one batch a thread, and u = 1 on a grid the
   card holds at once), every plan's codes checked bit for bit. One JSON
   line a (case, plan), then one ``summary`` line a case: the picked plan's
   time against the fastest's and against ``x.to(torch.int8)`` (a PyTorch
   cast that moves the same bytes), and the picked plan's CUDA-event time
   after device_time's flush (a 256 MiB write, which leaves L2 dirty) and
   after a 256 MiB read (L2 clean).

    python3 scripts/quantize_plan_sweep.py [--src DIR]

``--src DIR`` times the route of the package under ``DIR/src`` instead of
this checkout's (a checkout of another commit, whose ``ops.quantize_sym``
takes the same arguments), and skips the grids.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def plans(M: int, N: int, picked, sms: int):
    """The picked plan, then (gx, gy, tx, ty, u) for every u of 1, 2, 4 and
    every block height from the widest block's down to one row, on the
    picked block width and on the widest: each grid one batch a thread, and
    for u = 1 also the grid the card holds at once (threads take several
    batches)."""
    from repro_torch.kernels.quantize import BLOCK, LANE, RESIDENT

    cdiv = lambda a, b: -(-a // b)
    lanes = N // LANE + (N % LANE != 0)
    gx0 = cdiv(lanes, BLOCK)
    widths = {(picked[0], picked[2]), (gx0, cdiv(lanes, gx0))}
    out = [picked]
    for gx, tx in sorted(widths):
        ty = max(1, BLOCK // tx)
        heights = []
        while ty >= 1:
            heights.append(ty)
            ty = 0 if ty == 1 else max(1, ty // 2)
        for ty in heights:
            resident = sms * min(32, RESIDENT // (tx * ty))
            grids = [(min(cdiv(M, ty * u), 65535), u) for u in (1, 2, 4)]
            grids.append((min(cdiv(M, ty), max(1, resident // gx), 65535), 1))
            for gy, u in grids:
                if (gx, gy, tx, ty, u) not in out:
                    out.append((gx, gy, tx, ty, u))
    return out


class ReadFlush:
    """A flush that reads a buffer larger than L2 (``zero_`` by name, as
    the timing helpers call it): L2 is left holding clean lines, so the
    call under test evicts nothing dirty."""

    def __init__(self, buf, torch):
        self.buf, self.out, self.torch = buf, buf.new_empty(()), torch

    def zero_(self):
        self.torch.sum(self.buf, dim=0, out=self.out)


def route(torch, chip_smoke, dev, flush) -> None:
    """Part 1: ``ops.quantize_sym`` as a caller calls it."""
    from repro_torch.kernels import ops
    from repro_torch.quant.quantize import compute_scale

    gen = torch.Generator(device=dev).manual_seed(13)
    calls = []          # (case, form, bits, shape, in the 14, call)

    def add(case, x, scale, bits, form, serve):
        want = ops.quantize_sym(x, scale, bitwidth=bits, impl="torch")
        got = ops.quantize_sym(x, scale, bitwidth=bits)
        if not (got.dtype == want.dtype and torch.equal(got, want)):
            raise AssertionError(f"ops.quantize_sym {case} {form} is not exact")
        calls.append((case, form, bits, tuple(x.shape), serve,
                      lambda: ops.quantize_sym(x, scale, bitwidth=bits)))

    for name, K, N, bits in chip_smoke.LAYER_GEMMS:
        for case, shape, per_col in ((f"{name}.weight", (K, N), True),
                                     (f"{name}.act", (64, K), False)):
            x = torch.randn(*shape, device=dev, generator=gen).to(torch.bfloat16)
            s = compute_scale(x, bits, axis=1 if per_col else None)
            forms = ({"(N,)": s, "(1, N)": s.reshape(1, -1)} if per_col
                     else {"0-d": s, "float": s.item()})
            for form, scale in forms.items():
                add(case, x, scale, bits, form, True)
    # beyond the 14: ragged N, and x off 16-byte alignment (one element into
    # an odd-sized buffer), per column at 8 bits
    for case, (M, N), offset in (("ragged 37x333", (37, 333), 0),
                                 ("ragged weight 1024x1004", (1024, 1004), 0),
                                 ("misaligned attn.q.weight", (1024, 2048), 1)):
        buf = torch.empty(M * N + offset, device=dev, dtype=torch.bfloat16)
        x = buf[offset:].view(M, N)
        x.copy_(torch.randn(M, N, device=dev, generator=gen))
        add(case, x, compute_scale(x, 8, axis=1), 8, "(N,)", False)
    times = chip_smoke.device_ms_many(torch, [c[-1] for c in calls], flush)
    by_form: dict = {}
    for (case, form, bits, shape, serve, _), (ms, source, launches, kinds) in zip(calls, times):
        print(json.dumps({"case": case, "form": form, "bits": bits, "shape": list(shape),
                          "device_ms": ms, "device_ops": launches, "source": source,
                          "device_kernels": kinds}), flush=True)
        if serve:
            by_form.setdefault(form, []).append((ms, launches))
    for pair in (("0-d", "(N,)"), ("float", "(1, N)")):
        got = [t for form in pair for t in by_form[form]]
        n_ops = [n for _, n in got]
        print(json.dumps({"route": " + ".join(pair), "calls": len(got),
                          "device_ms": sum(ms for ms, _ in got),
                          "device_ops_per_call": None if None in n_ops else max(n_ops)}),
              flush=True)


def grids(torch, chip_smoke, dev, flush) -> None:
    """Part 2: the kernel under other grids than ``quantize_plan`` picks."""
    from repro_torch.kernels import quantize as qmod
    from repro_torch.quant.quantize import compute_scale

    gen = torch.Generator(device=dev).manual_seed(12)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = []
    for name, K, N, bits in chip_smoke.LAYER_GEMMS:
        cases.append((f"{name}.weight", K, N, torch.bfloat16, bits, True))
        cases.append((f"{name}.act", 64, K, torch.bfloat16, bits, False))
    cases += [("attn.q.weight f32", 1024, 2048, torch.float32, 8, True),
              ("mlp.down.weight f32", 3072, 1024, torch.float32, 2, True),
              ("ragged", 37, 333, torch.bfloat16, 8, False),
              ("ragged weight 1024x1004", 1024, 1004, torch.bfloat16, 8, True)]
    for name, M, N, dt, bits, per_col in cases:
        x = (torch.randn(M, N, device=dev, generator=gen) * 0.02).to(dt)
        s = compute_scale(x, bits, axis=1 if per_col else None)
        want = qmod.quantize_sym(x, s, bitwidth=bits, impl="torch")
        chosen = qmod.quantize_plan(M, N, sms)
        grid, fns = [], []
        for plan in plans(M, N, chosen, sms):
            fn = lambda plan=plan: qmod.launch(x, s, bits, plan)
            grid.append((plan, torch.equal(fn(), want)))
            fns.append(fn)
        # yardstick: x.to(int8) moves the same bytes (x read, q written)
        *times, (cast_ms, *_) = chip_smoke.device_ms_many(
            torch, fns + [lambda: x.to(torch.int8)], flush)
        best = {}
        byts = x.numel() * x.element_size() + s.numel() * 4 + M * N
        bound_ms = byts / chip_smoke.HBM_BYTES_PER_S * 1e3
        for (plan, exact), (ms, source, launches, _) in zip(grid, times):
            gx, gy, tx, ty, u = plan
            print(json.dumps({"case": name, "M": M, "N": N, "dtype": str(dt).split(".")[-1],
                              "gx": gx, "gy": gy, "tx": tx, "ty": ty, "u": u,
                              "blocks": gx * gy, "picked": plan == chosen, "exact": exact,
                              "device_ms": ms, "bound_ms": bound_ms,
                              "bound_share": bound_ms / ms, "source": source,
                              "launches": launches}), flush=True)
            if not exact:
                raise AssertionError(f"quantize_sym {name} under plan {plan} is not exact")
            best[plan] = ms
        fastest = min(best, key=best.get)
        # the picked plan by CUDA events after each flush: one that leaves
        # L2 full of dirty lines (device_time's) and one that leaves it clean
        call = lambda: qmod.launch(x, s, bits, chosen)
        dirty = chip_smoke._event_ms(torch, call, flush, 10)
        clean = chip_smoke._event_ms(torch, call, ReadFlush(flush, torch), 10)
        print(json.dumps({"summary": name, "picked": chosen, "picked_ms": best[chosen],
                          "best": fastest, "best_ms": best[fastest], "bound_ms": bound_ms,
                          "miss": best[chosen] / best[fastest] - 1, "cast_ms": cast_ms,
                          "events_ms_dirty_l2": dirty, "events_ms_clean_l2": clean}),
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", help="time the route of the package under DIR/src")
    args = ap.parse_args()
    import torch

    import chip_smoke     # puts this checkout's src/ first on the path

    if args.src:
        sys.path.insert(0, os.path.join(os.path.abspath(args.src), "src"))
    if not torch.cuda.is_available():
        print("quantize_plan_sweep: needs a GPU", file=sys.stderr)
        return 2
    dev = torch.device(chip_smoke.DEVICE)
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read()
    print(smi.strip(), flush=True)
    import repro_torch
    print(json.dumps({"package": os.path.dirname(repro_torch.__file__)}), flush=True)
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32, device=dev)
    route(torch, chip_smoke, dev, flush)
    if not args.src:
        grids(torch, chip_smoke, dev, flush)
    return 0


if __name__ == "__main__":
    sys.exit(main())
