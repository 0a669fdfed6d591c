"""Port parity for the probe's energy cell, ``health()["sharding"]`` and the
serve CLI's ``--data`` / ``--model``.

- ``launch.probe.energy_probe(..., device="cpu")`` on ``qwen3-0.6b_smoke``
  and ``deepseek-v2-lite-16b_smoke``, given the reference probe's weights
  (``init`` at ``PRNGKey(0)``) and tokens (``PRNGKey(1)``), gives the
  reference's per-layer cycles exactly and its energy within 1e-6
  relative, under the mixed policy and ``*=int4:prequant``. The
  reference's stacked stats are cut into one row a layer, as the port
  records them.
- ``health()["sharding"]`` after the same serve under a (data 2, model 4)
  context, whose 3 rows do not divide ``data``: the reference runs in a
  subprocess on 8 forced host devices with ``scan_layers=False`` and an
  ``Auto``-axes mesh (ROADMAP C4), the port in this process. The dropped
  rules are equal; the port counts each constrain site once a step width,
  the reference once a trace, and it traces its first width twice.
- On the rank pool the ranks hold slices and count nothing; the
  controller's meta steps count what one process counts under the same
  context.
- The CLI's ``--data 1 --model 1``: the reference CLI's tokens, summary
  and ``health()["sharding"]``; ``--data 2 --model 4`` (a rank pool of 8
  gloo ranks): the reference CLI's tokens and ``health()["sharding"]`` on
  8 forced host devices, printed as the ``sharding:`` line.
"""

import functools
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

from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import get_config as j_get_config
from repro.core import report as j_report
from repro.core.tugemm import TuGemmStats as JTuGemmStats
from repro.launch import serve as j_serve
from repro.models import init as j_init
from repro.quant import apply_surgery as j_apply_surgery
from repro.quant import forward_with_stats as j_forward_with_stats
from repro.quant import tree_entries
from repro.quant.capture import CapturedGemm as JCapturedGemm
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import get_config as t_get_config
from repro_torch.interop import params_from_reference
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import serve as t_serve
from repro_torch.launch.mesh import close_rank_pool
from repro_torch.launch.probe import energy_probe
from repro_torch.parallel.sharding import use_mesh
from repro_torch.serve import Request, Scheduler

HERE = os.path.dirname(os.path.abspath(__file__))
MIXED = {"qwen3-0.6b_smoke": "attn.*=int8,mlp.*=int2,*=bf16",
         "deepseek-v2-lite-16b_smoke": "mla.*=int8,moe.*=int2,mlp.*=int2,*=bf16"}


def _reference_probe(arch, policy, batch=2, seq=8):
    """The reference's ``energy_probe`` body: (its weights as numpy, its
    tokens, its stats cut one row a layer, its report over those rows)."""
    cfg = j_get_config(arch)
    rc = JRunConfig(dtype="float32", param_dtype="float32", remat="none", quant_policy=policy)
    params = j_init(cfg, rc, jax.random.PRNGKey(0))
    toks = jax.random.randint(jax.random.PRNGKey(1), (batch, seq), 0, cfg.vocab_size)
    _, _, _, tree = j_forward_with_stats(cfg, rc, j_apply_surgery(cfg, rc, params),
                                         {"tokens": toks})
    flat, seen = {}, {}
    for label, e in tree_entries(tree):
        st = {f: np.asarray(getattr(e.stats, f)) for f in
              ("step_cycles", "serial_cycles", "parallel_cycles", "max_abs", "act_max")}
        layers = st["serial_cycles"].shape[0] if label.startswith("groups") else None
        for i in range(layers or 1):
            one = {f: (v[i] if layers else v) for f, v in st.items()}
            n = seen[e.name] = seen.get(e.name, -1) + 1
            flat[f"{e.name}#{n}"] = JCapturedGemm(e.name, e.M, e.K, e.N, JTuGemmStats(
                **{f: jnp.asarray(v) for f, v in one.items()}), e.bits)
    return jax.tree.map(np.asarray, params), np.asarray(toks), flat


@pytest.mark.parametrize("arch", list(MIXED))
@pytest.mark.parametrize("kind", ["mixed", "prequant"])
def test_energy_probe_matches_reference(arch, kind, capsys):
    """Both report variants (serial, parallel) of one forward each side."""
    policy = MIXED[arch] if kind == "mixed" else "*=int4:prequant"
    params, toks, flat = _reference_probe(arch, policy)
    tparams = params_from_reference(params, device="cpu")
    for variant in ("serial", "parallel"):
        want = j_report.energy_report(flat, variant=variant)
        got = energy_probe(arch, policy=policy, variant=variant, device="cpu", params=tparams,
                           tokens=torch.from_numpy(toks))
        assert "=== energy:" in capsys.readouterr().out
        rows = {le.label: (le.bits, le.M, le.K, le.N, le.instances, le.serial_cycles,
                           le.parallel_cycles, le.max_abs) for le in got.layers}
        ref = {le.label: (le.bits, le.M, le.K, le.N, le.instances, le.serial_cycles,
                          le.parallel_cycles, le.max_abs) for le in want.layers}
        assert rows == ref and len(rows) > 10
        assert got.total_cycles == want.total_cycles > 0
        for f in ("total_energy_j", "total_latency_s", "unit_energy_j"):
            assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-6, abs=0.0), f
        assert {b: v["cycles"] for b, v in got.by_bits.items()} == {
            b: v["cycles"] for b, v in want.by_bits.items()}


def test_energy_probe_refuses_unquantized_policy_and_missing_card(monkeypatch):
    with pytest.raises(SystemExit, match="needs a quant policy"):
        energy_probe("qwen3-0.6b_smoke", policy="*=bf16", device="cpu")
    with pytest.raises(SystemExit, match="supersedes"):
        energy_probe("qwen3-0.6b_smoke", sets=["gemm_backend=int8"], policy="*=int8",
                     device="cpu")
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        energy_probe("qwen3-0.6b_smoke", policy="*=int8")


# ------------------------------------------------------- health()["sharding"]
SERVE = dict(arch="qwen3-0.6b_smoke", policy="attn.*=int8,mlp.*=int2,*=bf16", capacity=32,
             max_batch=3, prompts=[[5, 9, 11, 3, 7, 2], [1, 2, 3], [8, 8, 4, 4, 2, 2, 1, 9]],
             max_new=4)
RC_KW = dict(dtype="float32", param_dtype="float32", remat="none", kv_layout="paged",
             kv_cache_dtype="int8", block_size=4, prefill_chunk=5)

_REFERENCE = textwrap.dedent("""
    import json, sys
    import jax
    from repro.configs.base import RunConfig, get_config
    from repro.models import init
    from repro.parallel.sharding import use_mesh
    from repro.serve import Request, Scheduler

    a = json.loads(sys.argv[1])
    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    cfg = get_config(a["arch"])
    rc = RunConfig(quant_policy=a["policy"], scan_layers=False, **a["rc"])
    with use_mesh(mesh):
        s = Scheduler(cfg, rc, init(cfg, rc, jax.random.PRNGKey(0)), capacity=a["capacity"],
                      max_batch=a["max_batch"])
        for i, p in enumerate(a["prompts"]):
            s.submit(Request(rid=i, prompt=p, max_new=a["max_new"]))
        done = s.run()
        h = s.health()
    print(json.dumps({"devices": len(jax.devices()), "sharding": h["sharding"],
                      "tokens": {r.rid: list(map(int, r.out)) for r in done}}))
""")


@functools.lru_cache(maxsize=None)
def _reference_health():
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(HERE, "..", "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    arg = json.dumps({**{k: v for k, v in SERVE.items()}, "rc": RC_KW})
    out = subprocess.run([sys.executable, "-c", _REFERENCE, arg], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["devices"] == 8
    return res


def test_health_sharding_matches_reference():
    ref = _reference_health()
    cfg = t_get_config(SERVE["arch"])
    rc = TRunConfig(quant_policy=SERVE["policy"], **RC_KW)
    jcfg = j_get_config(SERVE["arch"])
    jrc = JRunConfig(quant_policy=SERVE["policy"], **RC_KW)
    params = params_from_reference(
        jax.tree.map(np.asarray, j_init(jcfg, jrc, jax.random.PRNGKey(0))), device="cpu")
    with use_mesh(t_mesh.make_local_mesh(2, 4)):
        s = Scheduler(cfg, rc, params, capacity=SERVE["capacity"],
                      max_batch=SERVE["max_batch"], device="cpu")
        for i, p in enumerate(SERVE["prompts"]):
            s.submit(Request(rid=i, prompt=p, max_new=SERVE["max_new"]))
        done = s.run()
    got = json.loads(json.dumps(s.health()["sharding"]))
    assert {str(r.rid): list(r.out) for r in done} == ref["tokens"]
    assert got["dropped_rules"] == ref["sharding"]["dropped_rules"] != {}
    # the reference traces its first step width twice: its caches enter the
    # first step uncommitted and come back laid out by it, a new input
    # sharding for jit. Its count is the port's plus that width's sites
    with use_mesh(t_mesh.make_local_mesh(2, 4)) as ctx:
        first = Scheduler(cfg, rc, params, capacity=SERVE["capacity"],
                          max_batch=SERVE["max_batch"], device="cpu")
        for i, p in enumerate(SERVE["prompts"]):
            first.submit(Request(rid=i, prompt=p, max_new=SERVE["max_new"]))
        first.tick()
    assert 0 < ctx.replicated_dims < got["replicated_dims"]
    assert ref["sharding"]["replicated_dims"] == got["replicated_dims"] + ctx.replicated_dims
    # outside any context the block is the reference's empty one
    assert Scheduler(cfg, rc, params, capacity=8, max_batch=1,
                     device="cpu").health()["sharding"] == {"replicated_dims": 0,
                                                            "dropped_rules": {}}


def _serve_params():
    jrc = JRunConfig(quant_policy=SERVE["policy"], **RC_KW)
    return params_from_reference(jax.tree.map(
        np.asarray, j_init(j_get_config(SERVE["arch"]), jrc, jax.random.PRNGKey(0))),
        device="cpu")


def test_health_sharding_on_the_rank_pool():
    """A (1, 2) rank pool under the (data 2, model 4) context above (2 kv
    heads do not divide model 4, so the context replicates; the pool's tp
    divides them): the ranks hold slices and count nothing, the
    controller's meta steps of each width count. Tokens are the
    reference's, the block is the single process's under the same
    context, which the test above holds to the reference's."""
    ref = _reference_health()
    cfg = t_get_config(SERVE["arch"])
    rc = TRunConfig(quant_policy=SERVE["policy"], **RC_KW)
    params = _serve_params()
    blocks, tokens = [], []
    try:
        for mesh in (None, "1,2"):
            with use_mesh(t_mesh.make_local_mesh(2, 4)):
                s = Scheduler(cfg, rc, params, capacity=SERVE["capacity"],
                              max_batch=SERVE["max_batch"], device="cpu", mesh=mesh,
                              mesh_backend="gloo" if mesh else None)
                for i, p in enumerate(SERVE["prompts"]):
                    s.submit(Request(rid=i, prompt=p, max_new=SERVE["max_new"]))
                done = s.run()
            blocks.append(s.health()["sharding"])
            tokens.append({str(r.rid): list(r.out) for r in done})
    finally:
        close_rank_pool()
    assert tokens[1] == tokens[0] == ref["tokens"]
    assert blocks[1] == blocks[0]
    assert blocks[1]["replicated_dims"] > 0


_REFERENCE_CLI = textwrap.dedent("""
    import json, sys
    import jax
    from repro.launch import serve as j_serve

    def make_local_mesh(data=1, model=1):
        return jax.make_mesh((data, model), ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)

    j_serve.make_local_mesh = make_local_mesh
    kept = []
    cls = j_serve.Scheduler
    j_serve.Scheduler = lambda *a, **kw: kept.append(cls(*a, **kw)) or kept[-1]
    done = j_serve.main(json.loads(sys.argv[1]))
    print(json.dumps({"devices": len(jax.devices()), "sharding": kept[0].health()["sharding"],
                      "tokens": {r.rid: list(map(int, r.out)) for r in done}}))
""")


# ------------------------------------------------------- the CLI's --data/--model
def test_cli_data_model_1x1_matches_reference(monkeypatch, capsys):
    def make_local_mesh(data: int = 1, model: int = 1):
        return jax.make_mesh((data, model), ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)

    monkeypatch.setattr(j_serve, "make_local_mesh", make_local_mesh)
    kept = {}

    def keep(mod, side):
        cls = mod.Scheduler

        def make(*a, **kw):
            kept[side] = cls(*a, **kw)
            return kept[side]

        monkeypatch.setattr(mod, "Scheduler", make)

    keep(j_serve, "ref")
    keep(t_serve, "port")
    argv = ["--arch", "qwen3-0.6b_smoke", "--requests", "2", "--prompt-len", "5", "--max-new",
            "3", "--max-batch", "2", "--capacity", "16", "--kv-layout", "paged", "--block-size",
            "4", "--kv-dtype", "int8", "--policy", "attn.*=int8,*=bf16", "--seed", "2",
            "--data", "1", "--model", "1"]
    ref = j_serve.main(argv)
    ref_out = capsys.readouterr().out
    rc = JRunConfig(dtype="float32", param_dtype="float32", remat="none")
    params = params_from_reference(jax.tree.map(np.asarray, j_init(
        j_get_config("qwen3-0.6b_smoke"), rc, jax.random.PRNGKey(2))), device="cpu")
    port = t_serve.main(argv + ["--device", "cpu"], params=params)
    port_out = capsys.readouterr().out
    assert {r.rid: r.out for r in port} == {r.rid: r.out for r in ref}
    shard = kept["port"].health()["sharding"]
    assert shard == kept["ref"].health()["sharding"]
    assert shard["dropped_rules"] == {"batch": ("pod", "data"),
                                      "group": ("pod", "data", "model"),
                                      "group_data": ("pod", "data")}
    strip = lambda out: [ln.split(" in ")[0] for ln in out.splitlines()
                         if not ln.startswith("  latency:")]
    assert strip(port_out) == strip(ref_out)


def test_cli_data_model_2x4_matches_reference(capsys):
    """``--data 2 --model 4`` serves on a rank pool of 8 gloo ranks (the
    port's sharded serve); the reference CLI serves GSPMD on 8 forced host
    devices (an ``Auto``-axes mesh, ROADMAP C4). The tokens are equal, and
    the port's ``sharding:`` line prints the reference's
    ``health()["sharding"]``."""
    arch = "deepseek-v2-lite-16b_smoke"
    argv = ["--arch", arch, "--requests", "3", "--prompt-len", "6", "--max-new", "4",
            "--max-batch", "4", "--capacity", "32", "--block-size", "4", "--prefill-chunk",
            "5", "--seed", "3", "--kv-layout", "paged", "--kv-dtype", "int8", "--policy",
            "mla.*=int8,moe.*=int2,mlp.*=int2,*=bf16", "--data", "2", "--model", "4"]
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(HERE, "..", "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", _REFERENCE_CLI, json.dumps(argv)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    ref = json.loads(out.stdout.strip().splitlines()[-1])
    assert ref["devices"] == 8
    rc = JRunConfig(dtype="float32", param_dtype="float32", remat="none")
    params = params_from_reference(jax.tree.map(np.asarray, j_init(
        j_get_config(arch), rc, jax.random.PRNGKey(3))), device="cpu")
    try:
        port = t_serve.main(argv + ["--mesh-backend", "gloo", "--device", "cpu"], params=params)
    finally:
        close_rank_pool()
    lines = capsys.readouterr().out.splitlines()
    assert {str(r.rid): list(r.out) for r in port} == ref["tokens"]
    assert any(ln.startswith("  mesh: dp=2 tp=4 devices=8 ") for ln in lines)
    s = ref["sharding"]
    rules = {k: tuple(v) for k, v in s["dropped_rules"].items()}
    assert rules
    assert [ln for ln in lines if ln.startswith("  sharding:")] == [
        f"  sharding: replicated_dims={s['replicated_dims']} dropped_rules={rules}"]
