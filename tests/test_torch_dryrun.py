"""Port parity for the dry-run (``repro_torch.launch.dryrun`` and
``roofline.op_cost``).

FLOPs: the port's meta FLOPs of a step against the reference's
``parse_hlo(jax.jit(step).lower(...).compile().as_text()).flops`` for the
same step, lowered with no mesh (the C4 breakage is in ``jax.make_mesh``),
``scan_layers=False``:

- the mixed serving step (4 rows × 16 columns, a paged int8 pool of 64
  tokens a row) on ``qwen3-0.6b_smoke`` under ``*=bf16`` and
  ``attn.*=int8,mlp.*=int2,*=bf16``, and on ``deepseek-v2-lite-16b_smoke``:
  equal;
- the train step (2 × 32 tokens, remat ``block``) on ``qwen3-0.6b_smoke``
  under both policies: the port's FLOPs are the reference's plus one
  QK^T product per attention layer, exactly. The eager flash backward
  recomputes the scores that XLA's CSE shares between the remat recompute
  and the custom backward; at this shape that is 1.35% (``*=bf16``) and
  2.63% (the mixed policy, whose quantized GEMMs leave attention a larger
  share) of the reference's FLOPs;
- ``deepseek-v2-lite-16b_smoke``'s train step: the gap is printed; it is
  the same attention recompute (1.94% under ``*=bf16``).

A production cell: ``deepseek-v2-lite-16b × decode_32k`` on 16×16 prices
(``[ok]``, a row priced on ``h100``) and ``qwen3-0.6b × decode_32k`` fails
with its kv-head refusal; the train cells the training mesh once refused
(sequence parallelism, a tp that does not divide the heads) price. The
collective parity against real gloo runs is in ``test_torch_mesh_train.py``
/ ``test_torch_mesh_serve.py``, whose pools the cases share.
"""

import json

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import get_config as j_get_config
from repro.models import init_caches as j_init_caches
from repro.models.model import abstract_params as j_abstract_params
from repro.parallel.state_sharding import abstract_train_state as j_abstract_train_state
from repro.roofline.hlo_parse import parse_hlo
from repro.serve.scheduler import build_mixed_step as j_build_mixed_step
from repro.train.train_step import build_train_step as j_build_train_step
from repro_torch.configs.base import SHAPES
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import get_config as t_get_config
from repro_torch.launch import dryrun
from repro_torch.models import init_caches as t_init_caches
from repro_torch.models.model import abstract_params as t_abstract_params
from repro_torch.parallel.state_sharding import abstract_train_state as t_abstract_train_state
from repro_torch.roofline.op_cost import count_ops
from repro_torch.serve.scheduler import build_mixed_step as t_build_mixed_step
from repro_torch.train.train_step import build_train_step as t_build_train_step

MIXED = "attn.*=int8,mlp.*=int2,*=bf16"
B, W, CAP = 4, 16, 64
TB, TS = 2, 32
KW = dict(dtype="float32", param_dtype="float32", kv_layout="paged", kv_cache_dtype="int8")


def _ref_flops(fn, *args) -> float:
    return parse_hlo(jax.jit(fn).lower(*args).compile().as_text()).flops


def _mixed_pair(arch, policy):
    rc = JRunConfig(remat="none", scan_layers=False, quant_policy=policy, **KW)
    cfg = j_get_config(arch)
    i32 = lambda *s: jax.ShapeDtypeStruct(s, jnp.int32)
    caches = jax.eval_shape(lambda: j_init_caches(cfg, rc, B, CAP))
    ref = _ref_flops(j_build_mixed_step(cfg, rc), j_abstract_params(cfg, rc), caches,
                     i32(B, W), i32(B), i32(B), i32(B, CAP // rc.block_size))
    trc, tcfg = TRunConfig(remat="none", quant_policy=policy, **KW), t_get_config(arch)
    m = lambda *s: torch.empty(s, dtype=torch.int32, device="meta")
    with count_ops() as cost:
        t_build_mixed_step(tcfg, trc)(t_abstract_params(tcfg, trc),
                                      t_init_caches(tcfg, trc, B, CAP, device="meta"),
                                      m(B, W), m(B), m(B), m(B, CAP // trc.block_size))
    return cost.flops, ref


def _train_pair(arch, policy):
    kw = dict(dtype="float32", param_dtype="float32", remat="block", quant_policy=policy)
    rc, cfg = JRunConfig(scan_layers=False, **kw), j_get_config(arch)
    i32 = lambda *s: jax.ShapeDtypeStruct(s, jnp.int32)
    ref = _ref_flops(j_build_train_step(cfg, rc), j_abstract_train_state(cfg, rc),
                     {"tokens": i32(TB, TS), "labels": i32(TB, TS)})
    trc, tcfg = TRunConfig(**kw), t_get_config(arch)
    m = lambda *s: torch.empty(s, dtype=torch.int32, device="meta")
    with count_ops() as cost:
        t_build_train_step(tcfg, trc)(t_abstract_train_state(tcfg, trc),
                                      {"tokens": m(TB, TS), "labels": m(TB, TS)})
    return cost.flops, ref


@pytest.mark.parametrize("arch,policy", [("qwen3-0.6b_smoke", "*=bf16"),
                                         ("qwen3-0.6b_smoke", MIXED),
                                         ("deepseek-v2-lite-16b_smoke", "*=bf16")])
def test_mixed_step_flops_equal_reference(arch, policy):
    port, ref = _mixed_pair(arch, policy)
    print(f"{arch} {policy}: port {port:.0f} reference {ref:.0f}")
    assert port == ref > 0
    assert abs(port - ref) <= 0.02 * ref


@pytest.mark.parametrize("policy", ["*=bf16", MIXED])
def test_train_step_flops_are_reference_plus_score_recompute(policy):
    arch = "qwen3-0.6b_smoke"
    port, ref = _train_pair(arch, policy)
    cfg = t_get_config(arch)
    recompute = cfg.num_layers * 2 * TB * cfg.num_heads * TS * TS * cfg.resolved_head_dim
    print(f"{arch} {policy}: port {port:.0f} reference {ref:.0f} "
          f"gap {(port - ref) / ref:.4%} (scores recomputed: {recompute})")
    assert port == ref + recompute


def test_train_step_flops_gap_mla_moe():
    """``deepseek-v2-lite-16b_smoke``: the gap is the eager backward's
    attention recompute, as for GQA; printed, held under 2%."""
    port, ref = _train_pair("deepseek-v2-lite-16b_smoke", "*=bf16")
    gap = (port - ref) / ref
    print(f"deepseek-v2-lite-16b_smoke *=bf16 train: port {port:.0f} reference {ref:.0f} "
          f"gap {gap:.4%}")
    assert 0 < gap < 0.02


def test_production_cell_prices_and_refusal_fails(tmp_path, capsys):
    rc = dryrun.main(["--arch", "deepseek-v2-lite-16b", "--shape", "decode_32k",
                      "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0 and "[ok]   deepseek-v2-lite-16b×decode_32k×single:" in out
    row = json.loads((tmp_path / "deepseek-v2-lite-16b_decode_32k_single.json").read_text())
    assert row["hw"] == "h100" and row["chips"] == 256 and row["mesh"] == "16x16"
    assert row["hlo_flops_per_chip"] > 0 and row["collective_bytes_per_chip"] > 0
    assert row["fits"] == (row["peak_bytes_per_chip"] <= 80e9)
    assert row["peak_bytes_per_chip"] >= row["argument_bytes_per_chip"] > 0
    assert set(row["collectives"]) <= {"all-reduce", "all-gather"}
    assert row["dominant"] in ("compute", "memory", "collective")
    assert "gather:moe.down@16" in row["collectives_by_label"]
    assert row["dropped_rules"] == {"batch": ["pod", "data"], "group": ["pod", "data", "model"],
                                    "group_data": ["pod", "data"]}

    rc = dryrun.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 1
    assert ("[FAIL] qwen3-0.6b×decode_32k×single: tp=16 must divide num_heads=16 and "
            "num_kv_heads=8 (head-group KV sharding)") in out
    assert "  SKIP qwen3-0.6b×long_500k:" in out


@pytest.mark.parametrize("arch,shape,words", [
    ("falcon-mamba-7b", "decode_32k", "not chunk-resumable"),
    ("hubert-xlarge", "prefill_32k", "encoder-only"),
])
def test_refused_cells_name_their_cause(arch, shape, words):
    with pytest.raises(dryrun.Refused, match=words):
        dryrun.run_cell(arch, SHAPES[shape], multi_pod=False)


@pytest.mark.parametrize("arch,replicated", [("deepseek-v2-lite-16b", 0), ("qwen2-vl-7b", 2)])
def test_train_cells_once_refused_now_price(arch, replicated):
    """The train cells the training mesh refused (the ``seq -> model``
    override; qwen2-vl's 28 heads and 4 kv heads on model=16) price on
    16×16: sequence parallelism's gathers and reduce-scatters are on the
    row's collectives, one reduce-scatter backward a gather forward, and
    the widths computed whole count in its
    ``replicated_dims`` (the state's specs replicate none here)."""
    row = dryrun.run_cell(arch, SHAPES["train_4k"], multi_pod=False)
    assert row["hlo_flops_per_chip"] > 0 and row["collective_bytes_per_chip"] > 0
    assert row["peak_bytes_per_chip"] >= row["argument_bytes_per_chip"] > 0
    labels = row["collectives_by_label"]
    assert {"tp_all_gather:seq", "tp_reduce_scatter:seq", "tp_reduce_scatter:seq_bwd",
            "tp_all_gather:seq_bwd"} <= set(labels)
    # remat block: a block's gathers run again in its recompute; the head's once
    assert labels["tp_all_gather:seq"]["calls"] == \
        2 * labels["tp_reduce_scatter:seq_bwd"]["calls"] - 1
    assert row["replicated_dims"] == replicated


def test_live_cells_and_skips_are_the_references():
    from repro.configs.base import SHAPES as J_SHAPES

    cells = [(a, s.name) for a, s in dryrun.live_cells()]
    assert len(cells) == 10 * len(J_SHAPES) - len(dryrun.SKIPS) == 31
    assert not set(cells) & set(dryrun.SKIPS)
