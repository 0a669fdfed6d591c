"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``
(the reference's ``repro/launch/train.py`` and its flags, plus
``--device`` and ``--mesh-backend``).

Trains on the card in bf16 unless ``--device cpu`` (f32 there) or
``--dtype`` says otherwise. ``--data D --model M`` (either above 1) trains
on a D×M mesh of processes (``Trainer(mesh=)``: the sharded step of
``parallel/train_mesh.py``) and needs ``--mesh-backend``, which has no
default: ``gloo`` runs every rank on the one device (the CPU, or one shared
card), ``nccl`` puts rank r on ``cuda:r``. ``--production-mesh`` takes the
reference's (data=16, model=16) shape, and ``--multi-pod`` its (pod=2,
data=16, model=16): one card a rank over nccl, so they raise on a machine
with fewer cards, naming the ranks and the cards; the mesh is never
shrunk. A prequant policy is refused, as the reference refuses it (packed
frozen weights are a serving form). The GEMMs run under the policy:
``*=bf16`` (the default) trains through ``torch.matmul``; a quantized
policy trains through the plain versions on the CPU and is refused by the
kernels on the card (no TPU kernel has a backward). A script that starts
a mesh needs an ``if __name__ == "__main__":`` guard: the ranks are
spawned.
"""

from __future__ import annotations

import argparse

import torch

from ..configs.base import SHAPES, RunConfig, ShapeConfig, get_config
from ..data import make_batches
from ..quant.policy import QuantPolicy, load_policy
from ..train import Trainer
from .mesh import make_local_mesh, make_production_mesh

__all__ = ["main"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default=None, help="assigned shape name (default: custom)")
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--gemm-backend", default="bf16", choices=["bf16", "int8", "int4", "int2"],
                    help="uniform precision (shorthand for --policy '*=<kind>')")
    ap.add_argument("--policy", default=None,
                    help="per-layer mixed-precision QuantPolicy, e.g. "
                         "'attn.*=int8,mlp.*=int2,*=bf16'")
    ap.add_argument("--moments", default="float32", choices=["float32", "int8"])
    ap.add_argument("--grad-compression", default="none", choices=["none", "int8_ef"])
    ap.add_argument("--remat", default="block", choices=["none", "block", "full"])
    ap.add_argument("--dtype", default=None, help="compute dtype (default bf16; f32 on the CPU)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--data", type=int, default=1, help="local mesh data-axis size")
    ap.add_argument("--model", type=int, default=1, help="local mesh model-axis size")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--mesh-backend", default=None, choices=["nccl", "gloo"],
                    help="the mesh's collectives (no default): nccl, one card a rank; gloo, "
                         "every rank on the one device")
    args = ap.parse_args(argv)

    mesh, backend = None, args.mesh_backend
    if args.production_mesh or args.multi_pod:
        mesh = make_production_mesh(multi_pod=args.multi_pod)
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if backend == "gloo" or n < mesh.size:
            raise ValueError(f"--production-mesh{' --multi-pod' if args.multi_pod else ''} is "
                             f"{dict(mesh.shape)}: {mesh.size} ranks over nccl, one card each; "
                             f"this machine has {n} cards. It is never shrunk: use --data/--model")
        backend = "nccl"
    elif args.data > 1 or args.model > 1:
        if backend is None:
            raise ValueError("--data/--model want --mesh-backend: nccl (one card a rank) or "
                             "gloo (every rank on the one device)")
        mesh = make_local_mesh(args.data, args.model)
    cfg = get_config(args.arch)
    on_cpu = args.device == "cpu"
    dtype = args.dtype or ("float32" if on_cpu else "bfloat16")
    policy = load_policy(args.policy) or QuantPolicy.parse(f"*={args.gemm_backend}")
    if policy.any_prequant:
        ap.error("prequant policies are serving-time (packed frozen weights); "
                 "train with dynamic rules, e.g. --policy '*=int8'")
    rc = RunConfig(
        dtype=dtype,
        param_dtype=dtype,
        quant_policy=policy,
        remat=args.remat,
        lr=args.lr,
        total_steps=args.steps,
        warmup_steps=max(1, args.steps // 10),
        moments_dtype=args.moments,
        grad_compression=args.grad_compression,
        microbatches=args.microbatches,
    )
    shape = (
        SHAPES[args.shape]
        if args.shape
        else ShapeConfig("custom", args.seq_len, args.global_batch, "train")
    )
    where = args.device if mesh is None else f"mesh {mesh.shape} ({backend})"
    print(f"[launch] {args.arch} on {where} | {shape}")
    trainer = Trainer(cfg, rc, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                      seed=args.seed, device=args.device, mesh=mesh, mesh_backend=backend)
    batches = make_batches(cfg, shape, seed=args.seed, start_step=trainer.step)
    try:
        trainer.run(batches, args.steps - trainer.step)
    finally:
        batches.close()
    print(f"[launch] done at step {trainer.step}; watchdog {trainer.clock.summary()}")
    return trainer


if __name__ == "__main__":
    main()
