#!/usr/bin/env python3
"""Where a dp x tp train step's time goes, on the card.

Trains ``chip_smoke.py``'s training-mesh workloads on a (data=2, model=2)
mesh of ranks sharing the card (``Trainer(mesh=)``; gloo, the step's
collectives in shared host memory) and prints one JSON line a workload:
each step's wall seconds, the last step's parts on every rank (views,
forward + backward, gradient reduction, optimizer), each rank's seconds
inside collectives and rank 0's collectives by label (calls, operand bytes,
seconds). The workloads: qwen3-0.6b at full width and depth, bf16, remat
``block``, 8 x 512 tokens, 3 steps; deepseek-v2-lite cut to 4 layers, 4 x
512 tokens, 2 steps. First it times the host staging a collective pays:
a 600 MB device-to-host copy, and the copy back through freshly pinned
memory and plainly.

``--group`` runs ``chip_smoke.py``'s whole training-mesh group instead
(every phase and gate; ~2 minutes). Needs the card.

    python3 scripts/mesh_train_probe.py [--group]
"""

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))
sys.path.insert(0, os.path.join(HERE, ".."))


def staging(torch) -> dict:
    x = torch.randn(150_000_000, device="cuda")       # 600 MB of f32
    h = x.cpu()
    out = {}
    for name, fn in (("to_cpu", lambda: x.cpu()),
                     ("pin_to_dev", lambda: h.pin_memory().to("cuda", non_blocking=True)),
                     ("plain_to_dev", lambda: h.to("cuda"))):
        ts = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        out[name] = ts
    return {"staging_600MB_s": out}


def workload(torch, tag: str, cfg, rc, steps: int, batch: int, generator: str) -> dict:
    import chip_smoke as cs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import make_batches

    mt = cs._mesh_trainer(torch, cfg, rc, init_generator=generator)
    it = make_batches(cfg, ShapeConfig("train", cs.TRAIN_SEQ, batch, "train"), seed=0)
    mt.run(it, steps)
    it.close()
    last = mt.rank_steps[-1]
    rec = {"tag": tag, "step_s": [h["ms"] / 1e3 for h in mt.history],
           "losses": [h["loss"] for h in mt.history],
           "laps_by_rank": [r["laps"] for r in last],
           "collective_s_by_rank": [r["seconds"][1] for r in last],
           "meter_rank0": last[0]["meter"]}
    mt.close()
    return rec


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--group", action="store_true",
                    help="run chip_smoke.py's training-mesh group alone")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("mesh_train_probe: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs.base import RunConfig, get_config
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import close_rank_pool

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi, "torch": torch.__version__}), flush=True)
    build.build()
    if args.group:
        torch.backends.cuda.matmul.allow_tf32 = False
        _, rc, params, _ = cs.model_setup(torch)
        del params
        t0 = time.perf_counter()
        cs.train_mesh_phases(torch, rc, smi)
        print(json.dumps({"group_seconds": time.perf_counter() - t0}), flush=True)
        return 0
    print(json.dumps(staging(torch)), flush=True)
    rc = RunConfig(dtype="bfloat16", param_dtype="bfloat16", remat="block", lr=cs.TRAIN_LR,
                   warmup_steps=3, total_steps=cs.TRAIN_STEPS)
    print(json.dumps(workload(torch, "qwen3-0.6b", get_config(cs.ARCH), rc, 3, cs.TRAIN_BATCH,
                              "cpu")), flush=True)
    mcfg = get_config(cs.MOE_ARCH).replace(num_layers=cs.MESH_MOE_LAYERS)
    print(json.dumps(workload(torch, "deepseek-v2-lite (4 layers)", mcfg, rc, 2,
                              cs.MESH_MOE_BATCH, "cuda")), flush=True)
    close_rank_pool()
    return 0


if __name__ == "__main__":
    sys.exit(main())
