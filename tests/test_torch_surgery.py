"""Port parity for offline prequantization (``repro_torch.quant.surgery``):
``apply_surgery`` on ``qwen3-0.6b_smoke`` gives the reference's surgered
tree — the same paths, identical packed ``qkernel`` bytes, bit-identical
``qscale`` and the same ``QBits`` — and the policy checks accept and reject
what the reference's do: a path-level prequant divergence runs once its
leaves are packed, a dynamic divergence raises ``PolicyError``."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig, get_config
from repro.models import init as j_init
from repro.quant import apply_surgery as j_apply_surgery
from repro.quant import plan_surgery as j_plan_surgery
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import get_config as t_get_config
from repro_torch.interop import flat_leaves, params_from_reference
from repro_torch.models import KVView, forward, init_caches
from repro_torch.quant import QBits, apply_surgery, plan_surgery
from repro_torch.quant.policy import PolicyError

torch.set_float32_matmul_precision("highest")
ARCH = "qwen3-0.6b_smoke"
RC_KW = dict(dtype="float32", param_dtype="float32", remat="none", prefill_chunk=5,
             kv_cache_dtype="int8", kv_layout="paged", block_size=4)
POLICIES = [
    "attn.*=int8:unfused,mlp.*=int2:prequant:unfused,*=bf16",
    "attn.*=int8,mlp.*=int2:prequant,*=bf16",
    "attn.*=int4:prequant,mlp.down=int8:prequant,mlp.*=int2,*=bf16",
    "groups.*.attn.wq=int2:prequant,attn.*=int8,*=bf16",
]


@pytest.fixture(scope="module")
def ref_params():
    cfg = get_config(ARCH)
    return j_init(cfg, RunConfig(**RC_KW), jax.random.PRNGKey(0))


def _port(ref_params):
    return params_from_reference(jax.tree.map(np.asarray, ref_params), device="cpu")


@pytest.mark.parametrize("policy", POLICIES)
def test_surgered_tree_is_the_reference_tree(ref_params, policy):
    rc = RunConfig(quant_policy=policy, **RC_KW)
    want = flat_leaves(jax.tree.map(np.asarray, j_apply_surgery(get_config(ARCH), rc,
                                                                ref_params)))
    got = flat_leaves(apply_surgery(t_get_config(ARCH), TRunConfig(quant_policy=policy,
                                                                   **RC_KW),
                                    _port(ref_params)))
    assert got.keys() == want.keys()
    packed = [k for k in got if k.endswith(".qbits")]
    assert packed, "the policy packs at least one leaf"
    for k, v in want.items():
        if isinstance(v, QBits):
            assert got[k] == v, k
        else:
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    # packed leaves stack along the layer axis: qkernel (L, Kp, N), qscale (L, N)
    L = get_config(ARCH).num_layers
    for k in packed:
        base = k[: -len(".qbits")]
        assert got[base + ".qkernel"].shape[0] == L and got[base + ".qscale"].ndim == 2


def test_plan_surgery_matches_reference(ref_params):
    policy = "attn.*=int8:unfused,mlp.*=int2:prequant:unfused,*=bf16"
    rc = RunConfig(quant_policy=policy, **RC_KW)
    want = j_plan_surgery(get_config(ARCH), rc, ref_params)
    got = plan_surgery(t_get_config(ARCH), TRunConfig(quant_policy=policy, **RC_KW),
                       _port(ref_params))
    fields = ("path", "gemm_name", "selected", "shape", "bits", "mode")
    assert ([tuple(getattr(e, f) for f in fields) for e in got.entries]
            == [tuple(getattr(e, f) for f in fields) for e in want.entries])
    assert got.bits_used == want.bits_used == (8, 2)


def _forward(cfg, rc, params):
    B, S = 2, 3
    caches = init_caches(cfg, rc, B, 16, device="cpu")
    tables = torch.arange(B * 4, dtype=torch.int32).reshape(B, 4)
    view = KVView(pos=torch.zeros(B, dtype=torch.int32),
                  lens=torch.full((B,), S, dtype=torch.int32), tables=tables,
                  block_size=rc.block_size, layout=rc.kv_layout)
    tokens = torch.arange(B * S, dtype=torch.int32).reshape(B, S)
    return forward(cfg, rc, params, {"tokens": tokens}, caches=caches,
                   cache_pos=view.pos, kv_view=view)[0]


def test_path_divergent_prequant_requires_packed_leaf(ref_params):
    cfg = t_get_config(ARCH)
    rc = TRunConfig(quant_policy="groups.*.attn.wq=int2:prequant,attn.*=int8,*=bf16", **RC_KW)
    params = _port(ref_params)
    with pytest.raises(PolicyError, match="not packed"):
        _forward(cfg, rc, params)
    packed = apply_surgery(cfg, rc, params)
    assert packed["groups"][0]["k0"]["attn"]["wq"]["qbits"] == QBits(2)
    assert torch.isfinite(_forward(cfg, rc, packed)).all()


def test_dynamic_path_divergence_raises(ref_params):
    cfg = t_get_config(ARCH)
    rc = TRunConfig(quant_policy="groups.*.attn.wq=int2,attn.*=int8,*=bf16", **RC_KW)
    params = _port(ref_params)
    with pytest.raises(PolicyError, match="share a single"):
        apply_surgery(cfg, rc, params)
    with pytest.raises(PolicyError, match="share a single"):
        _forward(cfg, rc, params)


def test_stale_packed_bits_and_typos_raise(ref_params):
    cfg = t_get_config(ARCH)
    rc8 = TRunConfig(quant_policy="*=int8:prequant", **RC_KW)
    p8 = apply_surgery(cfg, rc8, _port(ref_params))
    assert apply_surgery(cfg, rc8, p8) is not None        # same policy: idempotent
    with pytest.raises(PolicyError, match="packed at 8 bits"):
        apply_surgery(cfg, dataclasses.replace(rc8, quant_policy="*=int4:prequant"), p8)
    with pytest.raises(PolicyError, match="zero GEMMs"):
        apply_surgery(cfg, dataclasses.replace(rc8, quant_policy="atn.*=int8,*=bf16"),
                      _port(ref_params))


def test_surgered_reference_tree_carries_across(ref_params):
    """``params_from_reference`` maps the reference's QBits markers to the
    port's, so a tree surgered by the reference serves in the port exactly
    as one the port surgered itself."""
    policy = "attn.*=int8:unfused,mlp.*=int2:prequant:unfused,*=bf16"
    cfg = t_get_config(ARCH)
    rc = TRunConfig(quant_policy=policy, **RC_KW)
    carried = params_from_reference(
        jax.tree.map(np.asarray, j_apply_surgery(get_config(ARCH),
                                                 RunConfig(quant_policy=policy, **RC_KW),
                                                 ref_params)), device="cpu")
    own = apply_surgery(cfg, rc, _port(ref_params))
    assert isinstance(carried["groups"][0]["k0"]["ffn"]["w_up"]["qbits"], QBits)
    a, b = flat_leaves(carried), flat_leaves(own)
    assert a.keys() == b.keys()
    assert all((a[k] == b[k]) if isinstance(a[k], QBits) else np.array_equal(a[k], b[k])
               for k in a)
    assert torch.equal(_forward(cfg, rc, carried), _forward(cfg, rc, own))


# ------------------------------------------------------- the MLA + MoE slice
DS_ARCH = "deepseek-v2-lite-16b_smoke"
DS_POLICIES = [
    "mla.*=int8,moe.*=int2:prequant,mlp.*=int2:prequant,*=bf16",
    "mla.*=int8:prequant,moe.shared.*=int4:prequant,moe.*=int2:prequant,*=int8:prequant",
]


@pytest.fixture(scope="module")
def ds_params():
    return j_init(get_config(DS_ARCH), RunConfig(**RC_KW), jax.random.PRNGKey(0))


@pytest.mark.parametrize("policy", DS_POLICIES)
def test_mla_moe_surgered_tree_is_the_reference_tree(ds_params, policy):
    """Byte-identical surgered trees on deepseek-v2-lite-16b_smoke, the
    expert stacks packed to (L, E, Kp, N) with (L, E, N) scales; MLA's w_uk
    / w_uv and the router stay float."""
    rc = RunConfig(quant_policy=policy, **RC_KW)
    ref_tree = jax.tree.map(np.asarray, j_apply_surgery(get_config(DS_ARCH), rc, ds_params))
    want = flat_leaves(ref_tree)
    got = flat_leaves(apply_surgery(t_get_config(DS_ARCH), TRunConfig(quant_policy=policy,
                                                                      **RC_KW),
                                    _port(ds_params)))
    # the reference's surgered tree carried across by interop is the same tree
    carried = flat_leaves(params_from_reference(ref_tree, device="cpu"))
    assert got.keys() == want.keys() == carried.keys()
    for k, v in want.items():
        if isinstance(v, QBits):
            assert got[k] == v and carried[k] == v, k
        else:
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
            np.testing.assert_array_equal(carried[k], v, err_msg=k)
    cfg = get_config(DS_ARCH)
    for g in ("w_gate", "w_up", "w_down"):
        qk = got[f"groups.0.k1.ffn.experts.{g}.qkernel"]
        assert qk.ndim == 4 and qk.shape[:2] == (1, cfg.num_experts)
        assert got[f"groups.0.k1.ffn.experts.{g}.qscale"].shape[:2] == (1, cfg.num_experts)
    for k in ("w_uk.kernel", "w_uv.kernel"):
        assert f"groups.0.k0.attn.{k}" in got
    assert "groups.0.k1.ffn.router.kernel" in got


def test_mla_moe_gemm_names_match_reference(ds_params):
    """plan_surgery names every linear as the reference does: mla.q / dkv /
    o, moe.gate / up / down on the expert stacks, moe.shared.*, mlp.* on the
    dense layer, lm_head; w_uk, w_uv and the router are not GEMMs here."""
    policy = "mla.*=int8,moe.*=int2:prequant,mlp.*=int2:prequant,*=bf16"
    rc = RunConfig(quant_policy=policy, **RC_KW)
    want = j_plan_surgery(get_config(DS_ARCH), rc, ds_params)
    got = plan_surgery(t_get_config(DS_ARCH), TRunConfig(quant_policy=policy, **RC_KW),
                       _port(ds_params))
    fields = ("path", "gemm_name", "selected", "shape", "bits", "mode")
    assert ([tuple(getattr(e, f) for f in fields) for e in got.entries]
            == [tuple(getattr(e, f) for f in fields) for e in want.entries])
    names = {e.gemm_name for e in got.entries}
    assert names == {"mla.q", "mla.dkv", "mla.o", "mlp.gate", "mlp.up", "mlp.down",
                     "moe.gate", "moe.up", "moe.down", "moe.shared.gate", "moe.shared.up",
                     "moe.shared.down", "lm_head"}
