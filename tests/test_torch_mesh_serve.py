"""Port parity for sharded serving (``repro_torch.parallel.serve_mesh`` on
``torch.distributed``), mirroring the reference's ``tests/test_mesh_serve.py``
with its configs, policies, run config and requests.

The port's mesh is ``dp·tp`` gloo ranks on the CPU (``launch/mesh.py``),
this process being rank 0; the module's cases share one 2×4 rank pool. The
gates, on the reference test's GQA config (2 layers, d 64, 8 / 4 heads) and
on ``deepseek-v2-lite-16b_smoke``:

- the sharded (dp=2, tp=4) Scheduler's greedy tokens, ``cycles_by_bits``
  and per-request energy equal the reference's single-device Scheduler
  (paged and dense) and the port's, on the reference's ``PRNGKey(0)``
  weights; the dense layout too;
- the per-rank cycle attribution sums exactly to the totals;
- quantized gathers move at most bits/16 of their bf16 equivalent;
- the MoE drops equal the single-device capture's, step for step;
- the fallback step runs sharded (a persistent NaN row), and a mesh with
  speculative decoding is refused;
- against the reference's own 8-device mesh (a subprocess with
  ``--xla_force_host_platform_device_count=8``), ``comms_summary()`` per
  (label, bits) and ``device_attribution()`` are equal exactly. The
  reference meters a collective once per traced layer body, so a scanned
  group of layers counts once; the port counts every layer's, and the
  subprocess runs the reference with ``scan_layers=False``, where both
  count every layer (ROADMAP C).
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

from repro.configs import get_config
from repro.configs.base import ModelConfig, RunConfig
from repro.models.transformer import init_caches as j_init_caches
from repro.models.transformer import model_spec
from repro.parallel.sharding import materialize
from repro.quant.capture import tree_scalars
from repro.serve.scheduler import Request as JRequest
from repro.serve.scheduler import Scheduler as JScheduler
from repro.serve.scheduler import build_mixed_step as j_build_mixed_step
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import get_config as t_get_config
from repro_torch.interop import params_from_reference
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import RankPool, close_rank_pool, rank_pool
from repro_torch.models import init_caches as t_init_caches
from repro_torch.parallel import serve_mesh as t_sm
from repro_torch.quant.capture import scalar_totals
from repro_torch.serve import Request, Scheduler
from repro_torch.serve.faults import FaultEvent, FaultPlan
from repro_torch.serve.scheduler import build_mixed_step as t_build_mixed_step

torch.set_float32_matmul_precision("highest")
HERE = os.path.dirname(os.path.abspath(__file__))
GQA_KW = dict(name="gqa_mesh_test", family="dense", attn_type="gqa", num_layers=2, d_model=64,
              num_heads=8, num_kv_heads=4, d_ff=128, vocab_size=128, tie_embeddings=False)
GQA_POLICY = "attn.*=int8,mlp.*=int2,*=bf16"
MLA_POLICY = "mla.*=int8,moe.*=int2,mlp.*=int2,*=bf16"
RC_KW = dict(kv_cache_dtype="int8", block_size=8, dtype="float32", param_dtype="float32",
             prefill_chunk=8)
_RUNS: dict = {}


@pytest.fixture(scope="module", autouse=True)
def _rank_pool():
    """One 2×4 gloo pool for the module's cases, stopped at its end."""
    yield
    close_rank_pool()


def _cfgs(arch):
    if arch == "gqa":
        return ModelConfig(**GQA_KW), TModelConfig(**GQA_KW), GQA_POLICY
    return (get_config("deepseek-v2-lite-16b_smoke"), t_get_config("deepseek-v2-lite-16b_smoke"),
            MLA_POLICY)


def _params(arch):
    """The reference test's weights (``materialize`` at PRNGKey(0)) in both
    packages."""
    cfg, _, _ = _cfgs(arch)
    params = materialize(model_spec(cfg), jax.random.PRNGKey(0), jnp.float32)
    return params, params_from_reference(jax.tree.map(np.asarray, params), device="cpu")


def _prompts(vocab, n_req, seed=7):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, vocab, rng.integers(3, 14))] for _ in range(n_req)]


def _run_ref(arch, layout="paged", n_req=6):
    cfg, _, policy = _cfgs(arch)
    rc = RunConfig(quant_policy=policy, kv_layout=layout, **RC_KW)
    s = JScheduler(cfg, rc, _params(arch)[0], capacity=64, max_batch=4, track_energy=True)
    for i, p in enumerate(_prompts(cfg.vocab_size, n_req)):
        s.submit(JRequest(rid=i, prompt=p, max_new=6))
    while s.tick() or any(x is not None for x in s.slots) or s.admission.pending():
        pass
    return s


def _run_port(arch, mesh, layout="paged", n_req=6, **kw):
    _, cfg, policy = _cfgs(arch)
    rc = TRunConfig(quant_policy=policy, kv_layout=layout, **RC_KW)
    s = Scheduler(cfg, rc, _params(arch)[1], capacity=64, max_batch=4, track_energy=True,
                  device="cpu", mesh=mesh, mesh_backend="gloo" if mesh else None, **kw)
    for i, p in enumerate(_prompts(cfg.vocab_size, n_req)):
        s.submit(Request(rid=i, prompt=p, max_new=6))
    s.run()
    return s


def _mesh_run(arch):
    """The sharded 2×4 paged run of ``arch``, shared by the cases that
    read it."""
    if arch not in _RUNS:
        _RUNS[arch] = _run_port(arch, "2,4")
    return _RUNS[arch]


def _tokens(s):
    return {r.rid: list(r.out) for r in s.finished}


def _energy(s):
    return {e["rid"]: (e["cycles"], e["energy_j"]) for e in s.energy_summary()}


# ------------------------------------------------------------ bit-exactness
@pytest.mark.parametrize("arch", ["gqa", "mla"])
def test_sharded_bit_exact_and_attribution(arch):
    """dp=2 × tp=4 greedy decode: tokens, per-bits cycle totals and
    per-request energy equal the reference's single-device paged AND dense
    runs and the port's single-device run; the attribution sums exactly;
    quantized gathers beat bf16 by the policy's bits/16."""
    ref_paged, ref_dense = _run_ref(arch), _run_ref(arch, "dense")
    port = _run_port(arch, None)
    mesh = _mesh_run(arch)

    assert _tokens(mesh) == _tokens(port) == _tokens(ref_paged) == _tokens(ref_dense)
    assert mesh.cycles_by_bits == port.cycles_by_bits == ref_paged.cycles_by_bits
    assert _energy(mesh) == _energy(ref_paged) == _energy(port)
    assert mesh.final_kv_lens == ref_paged.final_kv_lens
    mesh.mgr.check_invariants()

    att = mesh.device_attribution()
    assert set(att) == set(mesh.cycles_by_bits)
    for bits, shares in att.items():
        assert shares.shape == (2, 4)
        assert int(shares.sum()) == mesh.cycles_by_bits[bits]["serial_cycles"]

    comms = mesh.comms_summary()["by_bits"]
    # by (label, bits): every gathered GEMM's local feature count packs here
    quantized = {k: r for k, r in mesh.comms.items() if k[1] < 16}
    assert quantized, "no quantized collectives metered"
    for (_, b), r in quantized.items():
        assert r["payload_bytes"] * 16 <= r["bf16_bytes"] * b
    ic = mesh.interconnect_report()
    assert ic["energy_j"] > 0 and set(ic["by_bits"]) == set(comms)

    h = mesh.health()
    assert (h["mesh"]["dp"], h["mesh"]["tp"], h["mesh"]["devices"]) == (2, 4, 8)
    assert h["mesh"]["backend"] == "gloo"
    assert h["mesh"]["comms"]["bytes_moved"] > 0
    assert port.health()["mesh"] == {"enabled": False}
    drops = h["mesh"]["moe_dropped_tokens"]
    assert isinstance(drops, int) and drops == mesh.moe_dropped_tokens
    assert drops == sum(port.tick_dropped_tokens) == sum(mesh.tick_dropped_tokens)
    if arch == "mla":
        assert drops > 0 and 16 in comms      # the expert outputs gather at full precision
    assert mesh.cache_stats() == port.cache_stats()


def test_sharded_dense_layout_bit_exact():
    """The dense (batch-sharded) KV layout shards over dp without the pool
    write gather: still the single-device tokens and cycles."""
    ref = _run_ref("gqa", "dense", n_req=4)
    shd = _run_port("gqa", "2,4", "dense", n_req=4)
    assert _tokens(shd) == _tokens(ref)
    assert shd.cycles_by_bits == ref.cycles_by_bits
    assert not any(k[0].startswith("gather:kv.") for k in shd.comms)


def test_moe_drops_match_single_device_step():
    """One mesh step's drop counter equals the single-device capture's
    summed ``moe.dropped_tokens`` scalars for the same batch, in both
    packages."""
    cfg, tcfg, policy = _cfgs("mla")
    rc = RunConfig(quant_policy=policy, kv_layout="paged", **RC_KW)
    trc = TRunConfig(quant_policy=policy, kv_layout="paged", **RC_KW)
    params, tparams = _params("mla")
    B, W = 4, 8
    tokens = np.random.default_rng(1).integers(0, 256, (B, W)).astype(np.int32)
    pos = np.zeros((B,), np.int32)
    lens = np.full((B,), W, np.int32)
    tables = np.full((B, 8), 32, np.int32)
    for b in range(B):
        for j in range(3):
            tables[b, j] = b * 3 + j
    args = tuple(jnp.asarray(a) for a in (tokens, pos, lens, tables))
    step = jax.jit(j_build_mixed_step(cfg, rc, with_stats=True))
    _, _, tree = step(params, j_init_caches(cfg, rc, B, 64, num_pages=32), *args)
    single = sum(int(np.asarray(s.value).sum()) for name, s in tree_scalars(tree)
                 if name.endswith("moe.dropped_tokens"))

    tstep = t_build_mixed_step(tcfg, trc, with_stats=True)
    _, _, cap = tstep(tparams, t_init_caches(tcfg, trc, B, 64, num_pages=32, device="cpu"),
                      *(torch.from_numpy(a) for a in (tokens, pos, lens, tables)))
    assert scalar_totals(cap)["moe.dropped_tokens"] == single

    spec = t_sm.MeshSpec(2, 4)
    pool = rank_pool(spec, backend="gloo", device="cpu")
    sources = [t_sm.TreeShard(t_sm.shard_params(spec, tparams, *divmod(r, 4))) for r in range(8)]
    eid = pool.attach(sources, cfg=tcfg, rc=trc, spec=spec, max_batch=B, capacity=64,
                      num_pages=32, with_stats=False, impl="auto")
    res = pool.call(("step", eid, "main", tokens, pos, lens, tables, None))
    raw = pool.engine.step.stack_raw(pool.engine.capture, [r["stats"] for r in res])
    assert not raw.entries                      # a scalars-only capture: no stats computed
    assert pool.engine.step.moe_drops(raw) == single > 0
    assert pool.engine.step.comms_for(W) == res[0]["meter"] != {}
    pool.call(("detach", eid))


@pytest.mark.parametrize("arch", ["gqa", "mla"])
def test_dryrun_meta_step_matches_the_pools_meter(arch):
    """The dry-run's rank-0 program (``launch.dryrun.serve_program``: the
    sharded step on meta tensors, its collectives on ``MetaGroup``s)
    records the collective calls and bytes by (label, bits) that rank 0 of
    the real 2×4 gloo pool records for the same step, and holds the real
    rank's weight and cache bytes."""
    _, tcfg, policy = _cfgs(arch)
    trc = TRunConfig(quant_policy=policy, kv_layout="paged", **RC_KW)
    _, tparams = _params(arch)
    B, W = 4, 8
    tokens = np.random.default_rng(2).integers(0, tcfg.vocab_size, (B, W)).astype(np.int32)
    pos = np.array([0, 3, 0, 9], np.int32)
    lens = np.array([W, 1, 5, 1], np.int32)
    tables = np.arange(B * 8, dtype=np.int32).reshape(B, 8) % 32
    spec = t_sm.MeshSpec(2, 4)
    pool = rank_pool(spec, backend="gloo", device="cpu")
    sources = [t_sm.TreeShard(t_sm.shard_params(spec, tparams, *divmod(r, 4))) for r in range(8)]
    eid = pool.attach(sources, cfg=tcfg, rc=trc, spec=spec, max_batch=B, capacity=64,
                      num_pages=32, with_stats=True, impl="auto")
    real = pool.call(("step", eid, "main", tokens, pos, lens, tables, None))[0]["meter"]
    held = sum(t.numel() * t.element_size() for t in _leaves(
        (pool.engine.params, pool.engine.caches)))
    pool.call(("detach", eid))

    cell = dryrun.serve_program(tcfg, trc, spec, B, W, 64, num_pages=32)
    meter = cell.run()
    assert meter == {f"{label}@{bits}": r for (label, bits), r in real.items()} != {}
    assert sum(t.numel() * t.element_size() for t in _leaves(cell.state)) == held


def _leaves(tree):
    from repro_torch.tree import leaves

    return [t for t in leaves(tree) if isinstance(t, torch.Tensor)]


def test_fallback_step_runs_sharded():
    """A row whose logits stay non-finite moves to the ``*=bf16`` fallback
    step, which every rank runs on its shard (its gathered GEMMs at full
    precision); the tokens, ticks and counters equal the single-device
    run's under the same fault plan."""
    plan = FaultPlan([FaultEvent(t, "nan_logits", 0) for t in range(1, 40)])
    port = _run_port("gqa", None, n_req=2, faults=plan)
    mesh = _run_port("gqa", "2,4", n_req=2, faults=plan)
    assert _tokens(mesh) == _tokens(port)
    assert all(len(o) == 6 for o in _tokens(mesh).values())
    assert mesh.fallback_retries == port.fallback_retries >= 1
    assert (mesh.nan_events, mesh.ticks, mesh.clock) == (port.nan_events, port.ticks, port.clock)
    assert mesh.cycles_by_bits == port.cycles_by_bits
    # the fallback's bf16 gathers are not metered (the reference meters the
    # main step only): every metered gather is at the policy's bits
    assert 16 not in mesh.comms_summary()["by_bits"]


def test_mesh_refuses_speculative_decoding():
    _, cfg, policy = _cfgs("gqa")
    rc = TRunConfig(quant_policy=policy, kv_layout="paged", spec_gamma=2, draft_policy="*=int2",
                    **RC_KW)
    with pytest.raises(NotImplementedError, match="speculative decoding on a mesh"):
        Scheduler(cfg, rc, _params("gqa")[1], capacity=64, max_batch=4, device="cpu",
                  mesh="2,4", mesh_backend="gloo")


def test_backend_and_device_are_the_callers():
    """nccl puts rank r on cuda:r and refuses fewer cards than ranks, naming
    gloo; nothing switches backend or device on its own, and a mesh without
    a named backend is refused."""
    with pytest.raises(ValueError, match="gloo"):
        RankPool(t_sm.MeshSpec(2, 4), backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="nccl"):
        RankPool(t_sm.MeshSpec(2, 4), backend="mpi", device="cpu")
    _, cfg, policy = _cfgs("gqa")
    with pytest.raises(ValueError, match="gloo"):
        Scheduler(cfg, TRunConfig(quant_policy=policy, **RC_KW), _params("gqa")[1], capacity=64,
                  max_batch=4, device="cpu", mesh="2,4", mesh_backend="nccl")
    with pytest.raises(ValueError, match="name one"):
        Scheduler(cfg, TRunConfig(quant_policy=policy, **RC_KW), _params("gqa")[1], capacity=64,
                  max_batch=4, device="cpu", mesh="2,4")


_REFERENCE_MESH = textwrap.dedent("""
    import json, os, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs.base import ModelConfig, RunConfig
    from repro.models.transformer import model_spec
    from repro.parallel.sharding import materialize
    from repro.serve.scheduler import Request, Scheduler

    kw, rc_kw, policy, prompts = json.loads(sys.argv[1])
    cfg = ModelConfig(**kw)
    rc = RunConfig(quant_policy=policy, kv_layout="paged", scan_layers=False, **rc_kw)
    params = materialize(model_spec(cfg), jax.random.PRNGKey(0), jnp.float32)
    s = Scheduler(cfg, rc, params, capacity=64, max_batch=4, track_energy=True, mesh="2,4")
    for i, p in enumerate(prompts):
        s.submit(Request(rid=i, prompt=p, max_new=6))
    while s.tick() or any(x is not None for x in s.slots) or s.admission.pending():
        pass
    print(json.dumps({
        "devices": jax.device_count(),
        "tokens": {r.rid: list(r.out) for r in s.finished},
        "cycles": {b: v for b, v in s.cycles_by_bits.items()},
        "comms": [[k[0], k[1], v] for k, v in sorted(s.comms.items())],
        "attribution": {b: a.tolist() for b, a in s.device_attribution().items()},
    }))
""")


def test_comms_and_attribution_match_reference_8_device_mesh():
    """The reference's own 2×4 mesh (8 host devices, its layer scan off so
    it meters every layer) and the port's 2×4 ranks, on the same weights
    and requests: tokens, cycles, every (label, bits) collective record and
    the per-device attribution, exactly."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(HERE, "..", "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    arg = json.dumps([GQA_KW, RC_KW, GQA_POLICY, _prompts(GQA_KW["vocab_size"], 6)])
    out = subprocess.run([sys.executable, "-c", _REFERENCE_MESH, arg], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    ref = json.loads(out.stdout.strip().splitlines()[-1])
    assert ref["devices"] == 8
    mesh = _mesh_run("gqa")
    assert {str(k): v for k, v in _tokens(mesh).items()} == ref["tokens"]
    assert {str(k): v for k, v in mesh.cycles_by_bits.items()} == ref["cycles"]
    assert [[k[0], k[1], v] for k, v in sorted(mesh.comms.items())] == ref["comms"]
    assert {str(b): a.tolist() for b, a in mesh.device_attribution().items()} == \
        ref["attribution"]
