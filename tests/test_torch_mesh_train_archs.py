"""Port parity for dp×tp training on every arch (``repro_torch.parallel.train_mesh``):
the Mamba mixer cut over ``inner`` (``in_proj``'s paired cut, the
row-parallel ``x_proj``'s sum), the hybrid block, hubert's gelu MLP and
audio frontend, the sub-blocks tp does not divide run whole on every rank,
and sequence parallelism (``seq -> model``).

Against the reference's single-device ``Trainer`` (its jitted step, its
``PRNGKey(0)`` weights carried across by ``interop.params_from_reference``,
the same numpy batches), over 3 f32 steps, the loss to 1e-5 relative and
every gathered parameter leaf to 1e-4 relative L2, as
``test_torch_mesh_train.py`` holds qwen3 and deepseek-v2-lite:

- ``falcon-mamba-7b_smoke``, ``hymba-1.5b_smoke`` and
  ``hubert-xlarge_smoke`` at 2×2;
- ``smollm-360m_smoke`` (3 / 1 heads) at 1×2 and ``qwen2-vl-7b_smoke`` (4 / 2)
  at 1×4: attention runs whole on every rank;
- ``seq -> model`` on ``qwen3-0.6b_smoke``, ``deepseek-v2-lite-16b_smoke``
  and ``falcon-mamba-7b_smoke`` at 2×2.

Then: the CLI trains falcon-mamba on a 2×2 gloo mesh; ``validate`` counts the
widths computed whole in ``replicated_dims`` as ``spec_for`` counts them, and
``compute_cuts`` leaves exactly those sub-blocks uncut; sequence parallelism
refuses a sequence tp does not divide, naming both numbers; a rules table
sharding the sequence over ``data`` is refused.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig, get_config
from repro.models import init as j_init
from repro.train import Trainer as JTrainer
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import ShapeConfig as TShapeConfig
from repro_torch.configs.base import get_config as t_get_config
from repro_torch.data import make_batches
from repro_torch.interop import params_from_reference
from repro_torch.launch.mesh import close_rank_pool, make_local_mesh
from repro_torch.launch.train import main as train_main
from repro_torch.parallel import train_mesh as tm
from repro_torch.parallel.sharding import ReplicatedDimWarning, spec_for, use_mesh
from repro_torch.train import Trainer

torch.set_float32_matmul_precision("highest")
STEPS = 3
RC_KW = dict(dtype="float32", param_dtype="float32", remat="none", lr=1e-2, warmup_steps=5,
             total_steps=60)
SP = {"sharding_overrides": {"seq": "model"}}
LOSS_TOL = 1e-5
PARAM_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _rank_pool():
    """The module's pools (one at a time), stopped at its end."""
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


CASES = [("falcon-mamba-7b_smoke", (2, 2), False), ("hymba-1.5b_smoke", (2, 2), False),
         ("hubert-xlarge_smoke", (2, 2), False), ("smollm-360m_smoke", (1, 2), False),
         ("qwen2-vl-7b_smoke", (1, 4), False), ("qwen3-0.6b_smoke", (2, 2), True),
         ("deepseek-v2-lite-16b_smoke", (2, 2), True), ("falcon-mamba-7b_smoke", (2, 2), True)]


@pytest.mark.parametrize("arch,mesh,sp", [
    pytest.param(a, m, sp, id=f"{a}-{m[0]}x{m[1]}{'-sp' if sp else ''}") for a, m, sp in CASES])
def test_mesh_trainer_matches_reference(arch, mesh, sp):
    """3 steps of the mesh Trainer against the reference's single-device
    Trainer on its own weights and the same batches; every rank holds its
    share."""
    rc, trc = RunConfig(**RC_KW), TRunConfig(**RC_KW, **(SP if sp else {}))
    cfg, tcfg = get_config(arch), t_get_config(arch)
    batches = _batches(arch)
    jt = JTrainer(cfg, rc, seed=0, log_fn=_quiet)
    p0 = params_from_reference(jax.tree.map(np.asarray, j_init(cfg, rc, jax.random.PRNGKey(0))),
                               "cpu")
    jt.run(iter([{k: jnp.asarray(v) for k, v in b.items()} for b in batches]), STEPS)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", ReplicatedDimWarning)
        mt = Trainer(tcfg, trc, device="cpu", params=p0, mesh=mesh, mesh_backend="gloo",
                     log_fn=_quiet)
    mt.run(iter([{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]), STEPS)
    np.testing.assert_allclose([h["loss"] for h in mt.history],
                               [h["loss"] for h in jt.history], rtol=LOSS_TOL)
    got = mt.gather_state("params")
    want = _flat_ref(jt.state["params"])
    assert set(got) == {"params/" + n for n in want}
    bad = {n: e for n in want if (e := _rel_l2(got["params/" + n].numpy(), want[n])) > PARAM_TOL}
    assert not bad, bad
    for r in mt.resident_bytes():
        assert 0 < r["state_bytes"] <= r["share_bytes"], r
    meter = mt.rank_steps[-1][0]["meter"]
    if sp:
        # a gather of the sequence into every block and the head, a
        # reduce-scatter out of every cut block and the embedding; each
        # with its backward
        calls = {k: r["calls"] for k, r in meter.items()}
        assert calls["tp_all_gather:seq"] == calls["tp_reduce_scatter:seq_bwd"]
        assert calls["tp_reduce_scatter:seq"] + calls["tp_reduce_scatter:embed"] == \
            calls["tp_all_gather:seq_bwd"]
    if tcfg.family == "ssm":
        assert meter["tp_all_reduce:ssm_x_proj"]["calls"] == tcfg.num_layers


def test_launch_train_ssm_on_a_mesh(tmp_path):
    """``--data 2 --model 2 --mesh-backend gloo`` trains falcon-mamba (its
    mixer cut over ``inner``) and resumes from its checkpoint."""
    argv = ["--arch", "falcon-mamba-7b_smoke", "--steps", "3", "--seq-len", "16",
            "--global-batch", "4", "--device", "cpu", "--data", "2", "--model", "2",
            "--mesh-backend", "gloo", "--ckpt-dir", str(tmp_path)]
    t = train_main(argv)
    assert t.step == 3
    assert all(np.isfinite(h["loss"]) and h["loss"] > 1.0 for h in t.history)
    assert all("tp_all_reduce:ssm_x_proj" in r["meter"] for r in t.rank_steps[-1])
    assert train_main(argv).step == 3


# (arch, tp): the widths tp does not divide, by logical axis
REPLICATED = [
    ("smollm-360m_smoke", 2, {"heads", "kv_heads"}),
    ("qwen2-vl-7b_smoke", 4, {"kv_heads"}),
    ("hymba-1.5b", 2, {"heads", "kv_heads", "vocab"}),
    ("qwen3-0.6b", 16, {"kv_heads"}),
    ("qwen3-14b", 16, {"heads", "kv_heads"}),
    ("hubert-xlarge", 16, {"vocab"}),
    ("falcon-mamba-7b", 16, set()),
    ("deepseek-v2-lite-16b", 16, set()),
]


@pytest.mark.parametrize("arch,tp,names", REPLICATED)
def test_replicated_dims_count_what_spec_for_replicates(arch, tp, names):
    """``validate`` under a mesh context adds one ``replicated_dims`` (and
    warns) for each compute width tp does not divide, as ``spec_for``
    counts a dim it replicates; ``compute_cuts`` runs exactly the
    sub-blocks of those widths whole."""
    cfg, rc = t_get_config(arch), TRunConfig()
    mesh = make_local_mesh(1, tp)
    with warnings.catch_warnings(record=True) as w, use_mesh(mesh) as ctx:
        warnings.simplefilter("always")
        tm.validate(cfg, rc, mesh)
    assert ctx.replicated_dims == len(names) == sum(
        issubclass(x.category, ReplicatedDimWarning) for x in w)
    assert {name for name, _, _ in ctx.dropped} == names
    with use_mesh(mesh) as ref:
        for name, n, _ in tm._compute_dims(cfg):
            spec_for((name,), (n,))
    assert ref.replicated_dims == ctx.replicated_dims
    whole = {"heads": "attn", "kv_heads": "attn", "vocab": "vocab", "inner": "ssm",
             "mlp": "mlp", "experts": "moe"}
    kinds = {k for _, _, k in tm._compute_dims(cfg)}
    assert tm.compute_cuts(cfg, tp) == kinds - {whole[n] for n in names}
    tm.validate(cfg, rc, mesh)      # no context: nothing counted, nothing raised


def test_sequence_parallelism_refusals():
    """A sequence tp does not divide is refused naming both numbers; a rules
    table sharding the sequence over ``data`` is refused."""
    arch = "qwen3-0.6b_smoke"
    tcfg = t_get_config(arch)
    mt = Trainer(tcfg, TRunConfig(**RC_KW, **SP), device="cpu", mesh=(1, 2),
                 mesh_backend="gloo", log_fn=_quiet)
    b = _batches(arch, n=1, S=15)[0]
    with pytest.raises(ValueError, match="a sequence of 15 tokens does not divide by 2"):
        mt.run(iter([{k: torch.from_numpy(v) for k, v in b.items()}]), 1)
    with pytest.raises(NotImplementedError, match="seq -> 'data'"):
        tm.validate(tcfg, TRunConfig(sharding_overrides={"seq": "data"}), make_local_mesh(2, 2))
