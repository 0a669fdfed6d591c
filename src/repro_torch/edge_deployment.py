"""Edge deployment study on the port (the reference's
``examples/edge_deployment.py``, the paper's §IV direction end to end):

1. quantize a small LM to int8/int4/int2 through the PTQ path,
2. profile its GEMM max-value statistics on real forward passes (Fig 5
   methodology, static scales from ``quant.calibration``),
3. plan the full-size model's decode workload onto tuGEMM tile arrays
   (serial/parallel × bitwidth) and report area/power/latency/energy per
   generated token,
4. compare accuracy proxies (hidden-state cosine against the float model):
   int8 tracks the float model closely, and every arithmetic error is a
   quantization error, never a stochastic one.

Run it as::

    PYTHONPATH=src python -m repro_torch.edge_deployment [--device cpu]

It runs on ``cuda`` unless ``--device cpu`` is given; the model is f32 on
both, as in the reference's example. Weights come from a generator seeded
0 on the device, tokens from numpy seeds 1 (evaluation) and 2
(calibration).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from . import resolve_device
from .configs.base import RunConfig, get_config
from .core.tiling import GemmTask, TileConfig, plan_workload
from .models import forward, init, input_batch
from .quant.calibration import calibrating, static_scales
from .quant.stats import collecting

__all__ = ["main"]

ARCH = "qwen3-0.6b_smoke"
PLAN_ARCH = "qwen3-0.6b"


def _tokens(cfg, seed: int, dev) -> torch.Tensor:
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (4, 32))
    return torch.from_numpy(toks).to(dev)


def _hidden(cfg, rc, params, tokens):
    h, _, _ = forward(cfg, rc, params, input_batch(cfg, tokens))
    return h.float()


def main(device=None, *, params: dict | None = None) -> dict:
    """Run the study, print its lines and return {"cosine": {bits: cos},
    "profiles": {bits: StatsCollector}, "plans": {(variant, bits): report}}.
    ``params`` defaults to random f32 weights from seed 0 (a test hands in
    the reference's, carried across by ``interop.params_from_reference``)."""
    dev = resolve_device(device)
    cfg = get_config(ARCH)
    rc_f = RunConfig(dtype="float32", param_dtype="float32", remat="none")
    if params is None:
        params = init(cfg, rc_f, torch.Generator(device=dev).manual_seed(0), device=dev)
    toks = _tokens(cfg, 1, dev)
    with torch.no_grad():
        h_ref = _hidden(cfg, rc_f, params, toks)

        # 1+2) quantized forwards + Fig 5 profiling (static scales)
        profs, agreements = {}, {}
        for bits in (8, 4, 2):
            rc_q = RunConfig(dtype="float32", param_dtype="float32", remat="none",
                             quant_policy=f"*=int{bits}:stats")
            rc_cal = RunConfig(dtype="float32", param_dtype="float32", remat="none",
                               quant_policy=f"*=int{bits}")
            with calibrating() as reg:
                _hidden(cfg, rc_cal, params, _tokens(cfg, 2, dev))
            with static_scales(reg), collecting(bitwidth=bits) as col:
                h_q = _hidden(cfg, rc_q, params, toks)
            profs[bits] = col
            cos = float((h_ref * h_q).sum()
                        / torch.clamp(h_ref.norm() * h_q.norm(), min=1e-9))
            agreements[bits] = cos
            prof = col.profile()
            print(f"int{bits}: hidden-state cosine vs float = {cos:.4f} | "
                  f"{len(col.records)} GEMMs, E[max]={prof.expected_max():.1f}, "
                  f"avg-case speedup {prof.speedup_vs_worst_case():.1f}x")

    # 3) map the full-size model's decode workload onto tuGEMM arrays
    full = get_config(PLAN_ARCH)
    d, hd, h, kv, ff, L = (full.d_model, full.resolved_head_dim, full.num_heads,
                           full.num_kv_heads, full.d_ff, full.num_layers)
    tasks = [
        GemmTask("qkv+o", 1, d, (h + 2 * kv) * hd + h * hd, count=L),
        GemmTask("mlp", 1, d, 2 * ff, count=L),
        GemmTask("mlp_down", 1, ff, d, count=L),
        GemmTask("lm_head", 1, d, full.vocab_size, count=1),
    ]
    prof8 = profs[8].profile()
    print(f"\n{full.name} single-token decode on tuGEMM arrays "
          f"(avg-case cycles from the measured profile):")
    print(f"{'config':<30} {'area mm²':>9} {'power W':>8} {'ms/token':>9} {'mJ/token':>9}")
    plans = {}
    for variant in ("serial", "parallel"):
        for bits in (8, 4, 2):
            rep = plan_workload(tasks, TileConfig(variant=variant, S=16, bitwidth=bits, units=64),
                                profile=prof8)
            plans[(variant, bits)] = rep
            print(f"{f'{variant} {bits}-bit 64x16x16 units':<30} {rep.area_mm2:>9.3f} "
                  f"{rep.power_w:>8.3f} {rep.latency_s*1e3:>9.1f} {rep.energy_j*1e3:>9.2f}")

    assert agreements[8] > 0.99, "int8 tuGEMM must track the float model closely"
    assert agreements[8] > agreements[2], "lower bits => more quantization error"
    print("\n[edge_deployment] OK")
    return {"cosine": agreements, "profiles": profs, "plans": plans}


def _cli() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(ap.parse_args().device)


if __name__ == "__main__":
    _cli()
