"""Quickstart: the tuGEMM core end to end on the port.

The four steps of the reference's ``examples/quickstart.py``, with the same
inputs (numpy seed 0 for steps 1-3) and the same printed quantities:

1. exact temporal-unary GEMM (``core.tugemm``: serial/parallel cycle counts
   + exactness; the thermometer-decomposed kernel ``ops.temporal_gemm``
   gives the same product);
2. the gate-level cycle-accurate simulator agreeing with the analytic model;
3. PPA of the hardware design points (Table I);
4. a quantized LM forward through the tuGEMM int8 backend (``*=int8:stats``)
   collecting the statistics the paper profiles in Fig 5, plus the
   energy report of the same forward.

Run it as::

    PYTHONPATH=src python -m repro_torch.quickstart [--device cpu] [--arch qwen3-0.6b]

It runs on ``cuda`` unless ``--device cpu`` is given. The reference's
forward attends without a cache; the port's forward runs on its paged KV
pool (one 16-token page per row, f32 pages at the f32 model dtype), which
is the same causal attention.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from . import resolve_device
from .configs.base import RunConfig, get_config
from .core import energy_report, evaluate_ppa, tugemm, worst_case_cycles
from .core.cycle_sim import simulate_serial
from .kernels import ops
from .models import KVView, forward, init, init_caches
from .quant.capture import capture_stats
from .quant.stats import collecting

__all__ = ["main"]

ARCH = "qwen3-0.6b_smoke"


def _lm_step(cfg, rc: RunConfig, params: dict, tokens: torch.Tensor, impl: str = "auto"):
    """One prefill forward of ``tokens`` (B, S) from position 0 under the
    ``:stats`` collector and an energy capture, every kernel on the ``impl``
    path; returns (hidden, collector, capture)."""
    dev = tokens.device
    B, S = tokens.shape
    per_row = -(-S // rc.block_size)
    caches = init_caches(cfg, rc, B, S, num_pages=B * per_row, device=dev)
    tables = torch.arange(B * per_row, dtype=torch.int32, device=dev).reshape(B, per_row)
    pos = torch.zeros(B, dtype=torch.int32, device=dev)
    view = KVView(pos=pos, lens=torch.full((B,), S, dtype=torch.int32, device=dev),
                  tables=tables, block_size=rc.block_size, layout=rc.kv_layout)
    with torch.no_grad(), collecting(bitwidth=8) as col, capture_stats() as cap:
        h, _, _ = forward(cfg, rc, params, {"tokens": tokens}, caches=caches,
                          cache_pos=pos, kv_view=view, impl=impl)
    return h, col, cap


def main(arch: str = ARCH, device=None, *, params: dict | None = None,
         tokens: torch.Tensor | None = None, impl: str = "auto") -> dict:
    """Run the four steps, print their lines and return their quantities.
    ``params``/``tokens`` default to random weights and tokens from seeds 0
    and 1 (the tests pass the reference's, carried across); ``impl`` is the
    step-4 forward's kernel path (``auto`` | ``torch`` | ``cuda``)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    out: dict = {}

    # 1) exact temporal-unary GEMM ------------------------------------------
    A = rng.integers(-8, 8, size=(16, 16))     # 4-bit operands
    B = rng.integers(-8, 8, size=(16, 16))
    C = rng.integers(-8, 8, size=(16, 16))
    At, Bt, Ct = (torch.from_numpy(v).to(dev) for v in (A, B, C))
    Y, stats = tugemm(At, Bt, Ct)
    Yn = Y.cpu().numpy()
    if not (Yn == A @ B + C).all():
        raise AssertionError("tuGEMM must be EXACT")
    if not torch.equal(ops.temporal_gemm(At, Bt, bitwidth=4) + Ct.to(torch.int32), Y):
        raise AssertionError("the thermometer decomposition must be EXACT")
    ser, par = int(stats.serial_cycles), int(stats.parallel_cycles)
    out["step1"] = {"serial_cycles": ser, "parallel_cycles": par,
                    "worst_serial": worst_case_cycles(4, 16, "serial"),
                    "worst_parallel": worst_case_cycles(4, 16, "parallel")}
    print(f"1. tuGEMM 16x16 (4-bit): exact ✓   serial={ser:,} cycles, "
          f"parallel={par:,} cycles "
          f"(worst case {worst_case_cycles(4, 16, 'serial'):,} / "
          f"{worst_case_cycles(4, 16, 'parallel'):,})")

    # 2) cycle-accurate golden model ----------------------------------------
    sim = simulate_serial(A, B, C)
    if not ((sim.Y == Yn).all() and sim.total_cycles == ser):
        raise AssertionError(f"the simulator disagrees: {sim.total_cycles} vs {ser} cycles")
    out["step2"] = {"sim_serial_cycles": sim.total_cycles}
    print("2. gate-level simulator: output + cycle count agree with the analytic op ✓")

    # 3) PPA (Table I design points) ----------------------------------------
    out["step3"] = {}
    for variant in ("serial", "parallel"):
        rep = evaluate_ppa(variant, 4, 16, 16, 16, float(ser if variant == "serial" else par))
        out["step3"][variant] = {"area_mm2": rep.area_mm2, "power_w": rep.power_w,
                                 "latency_s": rep.latency_s, "energy_j": rep.energy_j}
        print(f"3. {variant:8s} 4-bit 16x16: {rep.area_mm2*1e3:.1f} mm²·10⁻³  "
              f"{rep.power_w*1e3:.1f} mW  {rep.latency_s*1e6:.2f} µs  {rep.energy_j*1e9:.1f} nJ")

    # 4) a real model through the tuGEMM backend ----------------------------
    cfg = get_config(arch)
    # the reference quickstart's RunConfig on the port's paged KV layout
    rc = RunConfig(dtype="float32", param_dtype="float32", remat="none",
                   quant_policy="*=int8:stats", kv_layout="paged", block_size=16)
    if params is None:
        params = init(cfg, rc, torch.Generator().manual_seed(0), device=dev)
    if tokens is None:
        tokens = torch.randint(0, cfg.vocab_size, (2, 16), dtype=torch.int32,
                               generator=torch.Generator().manual_seed(1))
    h, col, cap = _lm_step(cfg, rc, params, tokens.to(dev), impl)
    if not (h.shape == (*tokens.shape, cfg.d_model) and bool(torch.isfinite(h).all())):
        raise AssertionError("the forward's hidden states are not finite of shape (B, S, D)")
    prof = col.profile()
    energy = energy_report(cap)
    if energy.total_cycles != col.total_cycles("serial"):
        raise AssertionError("the energy report and the collector disagree on serial cycles")
    out["step4"] = {"arch": cfg.name, "gemms": len(col.records),
                    "expected_max": prof.expected_max(),
                    "serial_cycles": col.total_cycles("serial"),
                    "parallel_cycles": col.total_cycles("parallel"),
                    "speedup_vs_worst": prof.speedup_vs_worst_case(),
                    "profile_counts": prof.counts.tolist(),
                    "energy_total_cycles": energy.total_cycles,
                    "energy_total_j": energy.total_energy_j,
                    "energy_render_total": next(
                        ln for ln in energy.render().splitlines() if ln.startswith("total:"))}
    print(f"4. {cfg.name} int8 forward: {len(col.records)} GEMMs through the "
          f"tuGEMM backend, E[max|value|]={prof.expected_max():.0f}, "
          f"total serial cycles {col.total_cycles('serial'):,} "
          f"(avg-case speedup vs worst {prof.speedup_vs_worst_case():.1f}x)")
    print("   " + out["step4"]["energy_render_total"])
    print("\nquickstart OK")
    return out


def _cli() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--arch", default=ARCH)
    args = ap.parse_args()
    main(args.arch, args.device)


if __name__ == "__main__":
    _cli()
