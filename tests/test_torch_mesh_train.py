"""Port parity for dp×tp training (``repro_torch.parallel.train_mesh`` and
``Trainer(mesh=)`` on ``torch.distributed``).

The module's cases share one 2×2 pool of gloo ranks on the CPU (this
process rank 0, stopped at the module's end). Against the reference's
``Trainer`` (its jitted step, its ``PRNGKey(0)`` weights carried across by
``interop.params_from_reference``, the same numpy batches), over 3 f32
steps on ``qwen3-0.6b_smoke`` and ``deepseek-v2-lite-16b_smoke``:

- the loss to 1e-5 relative and every gathered parameter leaf to 1e-4
  relative L2 (f32 on both sides; the sums over ranks and the frameworks'
  reduction orders differ, nothing else);
- under remat ``block`` the same tolerances;
- with int8 moments and ``int8_ef`` the loss to 1e-5 and the parameters to
  2e-3 relative L2: EF quantizes every gradient leaf to 127 levels of its
  absmax, so a one-ulp difference at a rounding boundary moves one entry by
  a whole step, which Adam's normalised update then carries (a 1×1 mesh
  matches the one-process port to 1e-7);
- each rank's state bytes are its specs' share.

Then: a mesh checkpoint restores bit for bit into the one-process port and
a one-process checkpoint into the mesh; ``compressed_psum`` against the
mean of the reference's ``_dq(_q(g))`` over the shards, int8 on the wire;
the CLI on a 2×2 gloo mesh, and its refusals.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig, get_config
from repro.models import init as j_init
from repro.optim.compress import _dq, _q
from repro.train import Trainer as JTrainer
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import ShapeConfig as TShapeConfig
from repro_torch.configs.base import get_config as t_get_config
from repro_torch.data import make_batches
from repro_torch.interop import params_from_reference
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import close_rank_pool, make_local_mesh
from repro_torch.launch.train import main as train_main
from repro_torch.train import Trainer
from repro_torch.train import checkpoint as ckpt

torch.set_float32_matmul_precision("highest")
HERE = os.path.dirname(os.path.abspath(__file__))
MESH = (2, 2)
STEPS = 3
# the reference's tests/test_train.py RunConfig
RC_KW = dict(dtype="float32", param_dtype="float32", remat="none", lr=1e-2, warmup_steps=5,
             total_steps=60)
LOSS_TOL = 1e-5
PARAM_TOL = 1e-4
EF_PARAM_TOL = 2e-3


@pytest.fixture(scope="module", autouse=True)
def _rank_pool():
    """One 2×2 gloo pool for the module's cases, stopped at its end."""
    yield
    close_rank_pool()


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    den = np.linalg.norm(b)
    return float(np.linalg.norm(a - b) / den) if den else float(np.linalg.norm(a))


def _batches(arch, n=STEPS, B=4, S=16, seed=1):
    it = make_batches(t_get_config(arch), TShapeConfig("t", S, B, "train"), seed=seed)
    out = [{k: v.numpy().copy() for k, v in next(it).items()} for _ in range(n)]
    it.close()
    return out


def _quiet(*_):
    pass


def _flat_ref(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): np.asarray(x)
            for path, x in flat}


@pytest.mark.parametrize("arch,kw,tol", [
    ("qwen3-0.6b_smoke", {}, PARAM_TOL),
    ("deepseek-v2-lite-16b_smoke", {}, PARAM_TOL),
    ("qwen3-0.6b_smoke", dict(remat="block"), PARAM_TOL),
    ("qwen3-0.6b_smoke", dict(moments_dtype="int8", grad_compression="int8_ef"), EF_PARAM_TOL),
])
def test_mesh_trainer_matches_reference(arch, kw, tol):
    """3 steps of the 2×2 mesh Trainer against the reference's Trainer on
    its own weights and the same batches; every rank holds its share."""
    rc, trc = RunConfig(**{**RC_KW, **kw}), TRunConfig(**{**RC_KW, **kw})
    cfg, tcfg = get_config(arch), t_get_config(arch)
    batches = _batches(arch)
    jt = JTrainer(cfg, rc, seed=0, log_fn=_quiet)
    p0 = params_from_reference(jax.tree.map(np.asarray, j_init(cfg, rc, jax.random.PRNGKey(0))),
                               "cpu")
    jt.run(iter([{k: jnp.asarray(v) for k, v in b.items()} for b in batches]), STEPS)
    mt = Trainer(tcfg, trc, device="cpu", params=p0, mesh=MESH, mesh_backend="gloo",
                 log_fn=_quiet)
    mt.run(iter([{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]), STEPS)
    np.testing.assert_allclose([h["loss"] for h in mt.history],
                               [h["loss"] for h in jt.history], rtol=LOSS_TOL)
    got = mt.gather_state("params")
    want = _flat_ref(jt.state["params"])
    assert set(got) == {"params/" + n for n in want}
    bad = {n: e for n in want if (e := _rel_l2(got["params/" + n].numpy(), want[n])) > tol}
    assert not bad, bad
    for r in mt.resident_bytes():
        assert 0 < r["state_bytes"] <= r["share_bytes"], r


def test_checkpoint_reshards_both_ways(tmp_path):
    """A mesh checkpoint restores into the one-process Trainer bit for bit,
    and a one-process checkpoint into the mesh; training on from either
    gives the same state to the 1e-4 of the parity test."""
    arch = "qwen3-0.6b_smoke"
    tcfg, trc = t_get_config(arch), TRunConfig(**RC_KW, moments_dtype="int8")
    b = [{k: torch.from_numpy(v) for k, v in x.items()} for x in _batches(arch, 4)]
    mesh_dir, one_dir = str(tmp_path / "mesh"), str(tmp_path / "one")
    mt = Trainer(tcfg, trc, device="cpu", mesh=MESH, mesh_backend="gloo", ckpt_dir=mesh_dir,
                 ckpt_every=2, log_fn=_quiet)
    mt.run(iter(b[:2]), 2)
    assert ckpt.latest_step(mesh_dir) == 2
    one = Trainer(tcfg, trc, device="cpu", ckpt_dir=mesh_dir, log_fn=_quiet)
    assert one.step == 2
    mesh_state = mt.gather_state()
    one_state = one.gather_state()
    assert set(mesh_state) == set(one_state)
    assert all(torch.equal(mesh_state[n], one_state[n]) for n in one_state)

    one2 = Trainer(tcfg, trc, device="cpu", ckpt_dir=one_dir, ckpt_every=3, log_fn=_quiet)
    one2.run(iter(b[:3]), 3)
    mt2 = Trainer(tcfg, trc, device="cpu", mesh=MESH, mesh_backend="gloo", ckpt_dir=one_dir,
                  log_fn=_quiet)
    assert mt2.step == 3
    got = mt2.gather_state()
    assert all(torch.equal(got[n], t) for n, t in one2.gather_state().items())
    one2.run(iter(b[3:]), 1)
    mt2.run(iter(b[3:]), 1)
    g1, g2 = one2.gather_state("params"), mt2.gather_state("params")
    assert max(_rel_l2(g2[n].numpy(), g1[n].numpy()) for n in g1) <= PARAM_TOL


_PSUM = textwrap.dedent("""
    import json, sys
    import torch, torch.distributed as dist
    from repro_torch.optim.compress import compressed_psum

    rank, world, init, shards = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    shards = json.loads(shards)
    dist.init_process_group("gloo", init_method="file://" + init, rank=rank, world_size=world)
    g = {k: torch.tensor(v[rank], dtype=torch.float32) for k, v in shards.items()}
    meter = {}
    got = compressed_psum(g, meter=meter)
    dist.destroy_process_group()
    print(json.dumps({"got": {k: v.tolist() for k, v in got.items()}, "meter": meter}))
""")


def test_compressed_psum_matches_reference(tmp_path):
    """Over 4 gloo ranks (their own processes), ``compressed_psum`` of each
    rank's shard equals the mean over the shards of the reference's
    ``_dq(_q(g))`` (summed in another order: to 1e-6 relative), the same
    on every rank, with int8 payloads and one f32 scale a shard on the
    wire."""
    rng = np.random.default_rng(0)
    shards = {"w": rng.standard_normal((4, 6, 5)).astype(np.float32) * [[[1.0]], [[3.0]],
                                                                          [[0.1]], [[2.0]]],
              "b": rng.standard_normal((4, 7)).astype(np.float32)}
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.join(HERE, "..", "src"),
                                                       os.environ.get("PYTHONPATH", "")]))
    arg = json.dumps({k: v.tolist() for k, v in shards.items()})
    init = str(tmp_path / "rendezvous")
    procs = [subprocess.Popen([sys.executable, "-c", _PSUM, str(r), "4", init, arg], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e[-2000:] for _, e in outs]
    ranks = [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]
    for k, v in shards.items():
        want = np.mean([np.asarray(_dq(*_q(jnp.asarray(s)))) for s in v], axis=0)
        for r in ranks:
            np.testing.assert_allclose(r["got"][k], want, rtol=1e-6, atol=1e-7)
    n = sum(v[0].size for v in shards.values())
    for r in ranks:
        assert r["meter"]["payload_bytes"] == 3 * n                 # int8: one byte a value
        assert r["meter"]["scale_bytes"] == 3 * 4 * len(shards)     # one f32 a shard
        assert r["meter"]["f32_bytes"] == 4 * r["meter"]["payload_bytes"]


def test_launch_train_on_a_mesh(tmp_path):
    """``--data 2 --model 2 --mesh-backend gloo --device cpu`` trains on the
    module's pool (the global batch split over the data ranks) and
    resumes from its checkpoint."""
    argv = ["--arch", "qwen3-0.6b_smoke", "--steps", "4", "--seq-len", "16", "--global-batch",
            "4", "--device", "cpu", "--data", "2", "--model", "2", "--mesh-backend", "gloo",
            "--remat", "block", "--moments", "int8", "--grad-compression", "int8_ef",
            "--ckpt-dir", str(tmp_path)]
    t = train_main(argv)
    assert t.step == 4 and ckpt.latest_step(str(tmp_path)) == 4
    assert all(np.isfinite(h["loss"]) and h["loss"] > 1.0 for h in t.history)
    ranks = t.rank_steps[-1]
    assert len(ranks) == 4 and all("fsdp_all_gather" in r["meter"] for r in ranks)
    t2 = train_main(argv)
    assert t2.step == 4 and not t2.history


@pytest.mark.parametrize("argv,match", [
    (["--data", "2", "--model", "2"], "mesh-backend"),
    (["--production-mesh", "--mesh-backend", "nccl"], "256 ranks"),
    (["--multi-pod"], "512 ranks"),
])
def test_launch_train_mesh_refusals(argv, match):
    """No backend, and the production meshes on a machine without their
    cards: refused before any rank starts."""
    with pytest.raises(ValueError, match=match):
        train_main(["--arch", "qwen3-0.6b_smoke", "--steps", "1", "--device", "cpu", *argv])


@pytest.mark.parametrize("arch,kw", [
    pytest.param("qwen3-0.6b_smoke", {}, id="qwen3-0.6b_smoke"),
    pytest.param("deepseek-v2-lite-16b_smoke", {}, id="deepseek-v2-lite-16b_smoke"),
    pytest.param("falcon-mamba-7b_smoke", {}, id="falcon-mamba-7b_smoke"),
    pytest.param("hymba-1.5b_smoke", {"sharding_overrides": {"seq": "model"}},
                 id="hymba-1.5b_smoke-seq_parallel"),
])
def test_dryrun_meta_step_matches_the_pools_meter(arch, kw):
    """The dry-run's rank-0 train step (``launch.dryrun.train_program``: the
    sharded step on meta tensors, its collectives on ``MetaGroup``s)
    records the collective calls, operand bytes and ring bytes by label
    that rank 0 of the real 2×2 gloo pool records for the same batch, and
    holds the real rank's state bytes: the Mamba mixer's cut (falcon-mamba)
    and sequence parallelism's gathers and reduce-scatters (hymba under
    ``seq -> model``) included."""
    trc, tcfg = TRunConfig(**RC_KW, **kw), t_get_config(arch)
    batch = _batches(arch, n=1)[0]
    mt = Trainer(tcfg, trc, device="cpu", mesh=MESH, mesh_backend="gloo", log_fn=_quiet)
    mt.run(iter([{k: torch.from_numpy(v) for k, v in batch.items()}]), 1)
    real = mt.rank_steps[-1][0]["meter"]
    held = mt.resident_bytes()[0]["state_bytes"]

    meta = {k: torch.empty(v.shape, dtype=torch.from_numpy(v).dtype, device="meta")
            for k, v in batch.items()}
    cell = dryrun.train_program(tcfg, trc, make_local_mesh(*MESH), meta)
    meter = cell.run()
    keep = ("calls", "bytes", "wire_bytes")
    assert {n: {k: r[k] for k in keep} for n, r in meter.items()} == {
        n: {k: r[k] for k in keep} for n, r in real.items()} != {}
    from repro_torch.tree import leaves

    assert sum(t.numel() * t.element_size() for t in leaves(cell.state)) == held
    if kw:
        assert {"tp_all_gather:seq", "tp_reduce_scatter:seq"} <= set(meter)
