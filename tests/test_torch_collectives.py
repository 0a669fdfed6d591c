"""Port parity for the mesh's building blocks (``repro_torch.parallel``)
against the reference's ``repro.parallel`` on the same numpy inputs, in one
process with no rank started: the wire packing's bytes, the mesh spec and
its validation, the per-rank model view, the partition rules on the
reference test's GQA config and on ``deepseek-v2-lite-16b_smoke`` (params,
plain and surgered, and caches in both layouts), the shards they cut and
the shards ``InitShards`` draws, the stats merge and the exact split of the
cycle attribution, and ``BlockManager.table_shard`` on both packages'
managers under the reference's hypothesis strategy."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import PartitionSpec as P

from repro.configs import get_config
from repro.configs.base import ModelConfig, RunConfig
from repro.core.tugemm import TuGemmStats as JTuGemmStats
from repro.models.transformer import init_caches as j_init_caches
from repro.models.transformer import model_spec
from repro.parallel import collectives as j_coll
from repro.parallel import serve_mesh as j_sm
from repro.parallel.sharding import materialize
from repro.quant import apply_surgery as j_apply_surgery
from repro.quant.capture import CapturedGemm as JCapturedGemm
from repro.serve.cache import BlockManager as JBlockManager
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import get_config as t_get_config
from repro_torch.core.tugemm import TuGemmStats
from repro_torch.interop import params_from_reference
from repro_torch.models import init as t_init
from repro_torch.models import init_caches as t_init_caches
from repro_torch.parallel import collectives as t_coll
from repro_torch.parallel import serve_mesh as t_sm
from repro_torch.quant import apply_surgery as t_apply_surgery
from repro_torch.quant.capture import Capture, CapturedGemm, CapturedScalar
from repro_torch.serve.cache import BlockManager as TBlockManager

GQA_KW = dict(name="gqa_mesh_test", family="dense", attn_type="gqa", num_layers=2, d_model=64,
              num_heads=8, num_kv_heads=4, d_ff=128, vocab_size=128, tie_embeddings=False)
GQA, T_GQA = ModelConfig(**GQA_KW), TModelConfig(**GQA_KW)
GQA_POLICY = "attn.*=int8,mlp.*=int2,*=bf16"
MLA_POLICY = "mla.*=int8,moe.*=int2,mlp.*=int2,*=bf16"
RC_KW = dict(kv_cache_dtype="int8", block_size=8, dtype="float32", param_dtype="float32",
             prefill_chunk=8)
SPEC = t_sm.MeshSpec(2, 4)


def _cfgs(arch):
    if arch == "gqa":
        return GQA, T_GQA, GQA_POLICY
    return (get_config("deepseek-v2-lite-16b_smoke"), t_get_config("deepseek-v2-lite-16b_smoke"),
            MLA_POLICY)


def _trees(arch, policy=None, surgery=False):
    """The reference test's weights (``materialize`` at PRNGKey(0)) in both
    packages, surgered under ``policy`` if asked."""
    cfg, tcfg, pol = _cfgs(arch)
    params = materialize(model_spec(cfg), jax.random.PRNGKey(0), jnp.float32)
    tparams = params_from_reference(jax.tree.map(np.asarray, params), device="cpu")
    if surgery:
        rc, trc = RunConfig(quant_policy=policy, **RC_KW), TRunConfig(quant_policy=policy, **RC_KW)
        params, tparams = j_apply_surgery(cfg, rc, params), t_apply_surgery(tcfg, trc, tparams)
    return params, tparams


# ------------------------------------------------------------- wire packing
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("features", [16, 15, 12, 6])
def test_pack_wire_bytes_match_reference(bits, features):
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    q = np.random.default_rng(bits * 100 + features).integers(
        lo, hi + 1, (3, 5, features)).astype(np.int8)
    assert t_coll.wire_bits(bits, features) == j_coll.wire_bits(bits, features)
    want = np.asarray(j_coll.pack_wire(jnp.asarray(q), bits))
    got = t_coll.pack_wire(torch.from_numpy(q), bits).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    back = t_coll.unpack_wire(torch.from_numpy(got), bits, features).numpy()
    np.testing.assert_array_equal(back, q)
    np.testing.assert_array_equal(
        back, np.asarray(j_coll.unpack_wire(jnp.asarray(want), bits, features)))


def test_collective_record_counts_like_reference():
    a, b = t_coll.CollectiveRecord(), j_coll.CollectiveRecord()
    for args in ((96, 24, 0), (1, 0, 12), (640, 640, 0)):
        a.add(*args)
        b.add(*args)
    assert vars(a) == vars(b)


# --------------------------------------------------------------- mesh spec
def test_as_spec_forms():
    assert t_sm.as_spec("2,4") == t_sm.MeshSpec(2, 4)
    assert t_sm.as_spec((2, 4)) == t_sm.MeshSpec(2, 4)
    assert t_sm.as_spec(t_sm.MeshSpec(1, 2)) == t_sm.MeshSpec(1, 2)
    assert t_sm.MeshSpec(2, 4).devices == 8
    with pytest.raises(ValueError):
        t_sm.as_spec("2,4,8")
    with pytest.raises(TypeError):
        t_sm.as_spec(8)


def test_validate_rejects_bad_divisibility():
    rc = TRunConfig(quant_policy=GQA_POLICY, **RC_KW)
    with pytest.raises(ValueError, match="num_heads"):
        t_sm.validate(T_GQA.replace(num_heads=6, num_kv_heads=6), rc, SPEC, 4)
    with pytest.raises(ValueError, match="max_batch 3 not divisible by dp=2"):
        t_sm.validate(T_GQA, rc, SPEC, 3)
    with pytest.raises(ValueError, match="d_ff"):
        t_sm.validate(T_GQA.replace(d_ff=126), rc, SPEC, 4)
    mla = t_get_config("deepseek-v2-lite-16b_smoke")
    with pytest.raises(ValueError, match="num_experts"):
        t_sm.validate(mla.replace(num_experts=6), rc, t_sm.MeshSpec(1, 4), 4)
    t_sm.validate(mla, rc, SPEC, 4)
    t_sm.validate(T_GQA, rc, SPEC, 4, world=8)
    # the reference's message, with this process's one JAX device as the world
    with pytest.raises(ValueError) as ref:
        j_sm.validate(GQA, RunConfig(quant_policy=GQA_POLICY, **RC_KW), j_sm.MeshSpec(64, 64), 64)
    with pytest.raises(ValueError, match="devices") as port:
        t_sm.validate(T_GQA, rc, t_sm.MeshSpec(64, 64), 64, world=jax.device_count())
    assert str(port.value).split(" (")[0] == str(ref.value).split(" (")[0]


@pytest.mark.parametrize("arch", ["gqa", "mla"])
def test_local_config_matches_reference(arch):
    cfg, tcfg, _ = _cfgs(arch)
    for dp, tp in ((2, 4), (1, 2), (2, 1)):
        a = t_sm.local_config(tcfg, t_sm.MeshSpec(dp, tp))
        b = j_sm.local_config(cfg, j_sm.MeshSpec(dp, tp))
        assert (a.num_heads, a.num_kv_heads, a.resolved_head_dim, a.num_experts) == (
            b.num_heads, b.num_kv_heads, b.resolved_head_dim, b.num_experts)


# ---------------------------------------------------------- partition rules
def _ref_specs(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))
    return {"/".join(j_sm._path_keys(path)): tuple(p) for path, p in flat}


def _port_specs(tree) -> dict:
    out = {}
    t_sm._map_keys(lambda keys, s: out.__setitem__("/".join(keys), s), tree)
    return out


@pytest.mark.parametrize("arch,surgery", [("gqa", False), ("mla", False), ("gqa", True),
                                          ("mla", True)])
def test_param_partition_rules_match_reference(arch, surgery):
    """Which leaves shard over tp, on which axis, for every leaf of the
    model tree (kernel, qkernel, qscale and bias alike)."""
    _, _, policy = _cfgs(arch)
    surg = policy.replace("mlp.*=int2", "mlp.*=int2:prequant").replace(
        "moe.*=int2", "moe.*=int2:prequant")
    params, tparams = _trees(arch, surg, surgery)
    want = _ref_specs(j_sm.param_pspecs(j_sm.MeshSpec(2, 4), params))
    got = t_sm.param_pspecs(SPEC, tparams)
    assert got == want
    assert any(s for s in got.values()), "nothing shards"
    if surgery:
        assert any("qkernel" in k and s for k, s in got.items())


@pytest.mark.parametrize("arch", ["gqa", "mla"])
@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_cache_partition_rules_match_reference(arch, layout):
    cfg, tcfg, policy = _cfgs(arch)
    rc = RunConfig(quant_policy=policy, kv_layout=layout, **RC_KW)
    trc = TRunConfig(quant_policy=policy, kv_layout=layout, **RC_KW)
    kw = dict(num_pages=16) if layout == "paged" else {}
    want = _ref_specs(j_sm.cache_pspecs(j_sm.MeshSpec(2, 4), rc, j_init_caches(cfg, rc, 4, 64,
                                                                                **kw)))
    caches = t_init_caches(tcfg, trc, 4, 64, device="cpu", **kw)
    assert t_sm.cache_pspecs(SPEC, trc, caches) == want
    # each rank's cut is the cache it builds from its own model view
    local = t_init_caches(t_sm.local_config(tcfg, SPEC), trc,
                          4 if layout == "paged" else 2, 64, device="cpu", **kw)
    cut = t_sm.shard_caches(SPEC, trc, caches, 1, 3)
    shapes = lambda tree: _port_specs(t_sm._map_keys(lambda _, x: tuple(x.shape), tree))  # noqa
    assert shapes(cut) == shapes(local)


@pytest.mark.parametrize("arch", ["gqa", "mla"])
def test_shards_partition_every_leaf(arch):
    """Rank (d, t)'s shard of each leaf is part t of tp along its rule's
    axis: the parts concatenate back to the leaf, replicated leaves are
    the leaf itself, and every dp row holds the same shards."""
    _, tparams = _trees(arch)
    axes = t_sm.param_pspecs(SPEC, tparams)
    full = _port_specs(t_sm._map_keys(lambda _, x: x, tparams))
    shards = [_port_specs(t_sm.shard_params(SPEC, tparams, d, t))
              for d in range(SPEC.dp) for t in range(SPEC.tp)]
    for name, leaf in full.items():
        spec = axes[name]
        if not spec:
            assert all(s[name] is leaf or torch.equal(s[name], leaf) for s in shards)
            continue
        ax = spec.index("model")
        for d in range(SPEC.dp):
            parts = [shards[d * SPEC.tp + t][name] for t in range(SPEC.tp)]
            assert all(p.is_contiguous() for p in parts)
            assert torch.equal(torch.cat(parts, dim=ax), leaf)


@pytest.mark.parametrize("arch", ["qwen3-0.6b_smoke", "deepseek-v2-lite-16b_smoke"])
def test_init_shards_draw_the_sliced_init(arch):
    """A rank drawing its own shard leaf by leaf gets exactly its cut of
    ``init``'s tree from the same generator."""
    cfg = t_get_config(arch)
    rc = TRunConfig(quant_policy=GQA_POLICY, **RC_KW)
    spec = t_sm.MeshSpec(2, 2)
    full = t_init(cfg, rc, torch.Generator().manual_seed(3), device="cpu")
    for d, t in ((0, 0), (1, 1)):
        got = _port_specs(t_sm.InitShards(cfg, rc, 3).params(spec, d, t, "cpu"))
        want = _port_specs(t_sm.shard_params(spec, full, d, t))
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in want)


# -------------------------------------------------------------- stats merge
def _raw_entry(rng, name, dp, tp, lead, K, rows=6, cols=5):
    """One GEMM's raw (dp, tp) stats from random per-rank int operands, in
    both packages' stats types."""
    step = np.zeros((dp, tp) + lead + (K,), np.int64)
    ma = np.zeros((dp, tp) + lead, np.int64)
    am = np.zeros((dp, tp) + lead, np.int64)
    for d in range(dp):
        for t in range(tp):
            a = rng.integers(-7, 8, lead + (rows, K))
            b = rng.integers(-7, 8, lead + (K, cols))
            amax_a, amax_b = np.abs(a).max(-2), np.abs(b).max(-1)
            step[d, t] = amax_a * np.maximum(amax_b, 1)
            ma[d, t] = np.maximum(np.abs(a).max((-1, -2)), np.abs(b).max((-1, -2)))
            am[d, t] = np.abs(a).max((-1, -2))
    j = JCapturedGemm(name, rows, K, cols, JTuGemmStats(step, step.sum(-1), step.max(-1), ma, am),
                      4)
    t = CapturedGemm(name, rows, K, cols, TuGemmStats(step, step.sum(-1), step.max(-1), ma, am),
                     4)
    return j, t


def test_merge_stats_matches_reference():
    """The port's merge of a raw (dp, tp) capture equals the reference's
    ``ShardedStep._merge_gemm`` field for field: a column-parallel GEMM, a
    gathered one, and an expert-parallel stack (dp-max, then tp-concat)."""
    rng = np.random.default_rng(0)
    dp, tp = 2, 4
    entries = [_raw_entry(rng, "attn.q", dp, tp, (), 12), _raw_entry(rng, "mlp.down", dp, tp, (), 9),
               _raw_entry(rng, "moe.up", dp, tp, (3,), 7)]
    cfg = t_get_config("deepseek-v2-lite-16b_smoke")
    step = t_sm.ShardedStep(cfg, TRunConfig(quant_policy=MLA_POLICY, **RC_KW), t_sm.MeshSpec(dp, tp))
    ref = types.SimpleNamespace(spec=j_sm.MeshSpec(dp, tp), ep=True)
    raw = Capture([t for _, t in entries],
                  [CapturedScalar("moe.dropped_tokens", np.arange(dp * tp).reshape(dp, tp))])
    merged = step.merge_stats(raw)
    for (j, _), got in zip(entries, merged.entries):
        want = j_sm.ShardedStep._merge_gemm(ref, j)
        assert (got.name, got.M, got.K, got.N, got.bits) == (want.name, want.M, want.K, want.N,
                                                             want.bits)
        for a, b in zip(got.stats, want.stats):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(merged.scalars[0].value) == 0 + 4 == step.moe_drops(raw)
    load = step.device_serial_by_bits(raw)
    assert load[4].shape == (dp, tp)
    assert int(load[4].sum()) == sum(int(np.asarray(e.stats.serial_cycles).sum())
                                     for _, e in entries)


@pytest.mark.parametrize("total,weights", [(10, [1, 1, 1]), (1000003, [5, 0, 2, 9, 1, 1, 3, 7]),
                                           (7, [0, 0]), (0, [1, 2]), (123456789, [3] * 8)])
def test_split_exact_matches_reference(total, weights):
    got = t_sm.ShardedStep.split_exact(total, weights)
    np.testing.assert_array_equal(got, j_sm.ShardedStep.split_exact(total, weights))
    assert int(got.sum()) == total


# -------------------------------------------------------------- table shards
@settings(deadline=None, max_examples=40)
@given(
    tp=st.integers(1, 8),
    lens=st.lists(st.integers(0, 40), min_size=1, max_size=6),
)
def test_table_shard_partitions_global_table(tp, lens):
    """Every live table entry appears in exactly one tp group's shard (no
    page owned by two groups, none lost), and the port's shards are the
    reference's."""
    slots = len(lens)
    mgr, ref = TBlockManager(64, 8, slots, 48), JBlockManager(64, 8, slots, 48)
    for i, ln in enumerate(lens):
        mgr.extend(i, ln)
        ref.extend(i, ln)
    shards = [mgr.table_shard(r, tp) for r in range(tp)]
    for r in range(tp):
        np.testing.assert_array_equal(shards[r], ref.table_shard(r, tp))
    trash = mgr.trash
    for pos in np.ndindex(*mgr.tables.shape):
        page = int(mgr.tables[pos])
        owners = [r for r in range(tp) if int(shards[r][pos]) != trash]
        if page == trash:
            assert owners == []
        else:
            assert len(owners) == 1
            assert int(shards[owners[0]][pos]) == page
            assert page % tp == owners[0]


def test_table_shard_rejects_bad_rank():
    mgr = TBlockManager(16, 8, 2, 48)
    with pytest.raises(ValueError, match="out of range"):
        mgr.table_shard(4, 4)
