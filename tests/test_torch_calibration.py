"""Port parity for static-scale calibration (the paper's Fig 5 method):
``repro_torch.quant.calibration`` and the static-scale branch of
``quant.qlinear.gemm`` against the reference's, on ``qwen3-0.6b_smoke``
and ``deepseek-v2-lite-16b_smoke`` (whose expert GEMMs run as one (E, M, K)
stack in the port and as a vmap of ``dense`` in the reference), the
reference's weights carried across by ``repro_torch.interop``.

- The registries one calibration forward builds agree within 1e-6
  relative: each is a max of |x| over activations that carry the two
  frameworks' float-order differences.
- Under one registry (the reference's, handed to both), every
  ``GemmRecord`` of a ``collecting()`` forward is identical — max |q| and
  cycles — and the hidden state is within the f32 tolerance of
  ``tests/test_torch_archs.py`` (``atol=rtol=2e-5``).
- A name absent from the registry runs dynamic; a static scale overrides a
  per-token rule and is taken as ``reg[name] / hi``; bf16 GEMMs are not
  observed; the contexts nest and restore on exit, exceptions included.
- ``repro_torch.edge_deployment`` on the reference's weights and the same
  numpy tokens gives the reference example's records, profiles and tile
  plans exactly and its cosines within f32 rounding.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig, get_config
from repro.models import forward as j_forward
from repro.models import init as j_init
from repro.quant import calibration as j_cal
from repro.quant.qlinear import GemmBackend as JBackend
from repro.quant.qlinear import gemm as j_gemm
from repro.quant.stats import collecting as j_collecting
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import get_config as t_get_config
from repro_torch.interop import params_from_reference
from repro_torch.kernels import ops
from repro_torch.models import forward, input_batch
from repro_torch.quant import calibration as t_cal
from repro_torch.quant.qlinear import GemmBackend
from repro_torch.quant.qlinear import gemm as t_gemm
from repro_torch.quant.stats import collecting

torch.set_float32_matmul_precision("highest")
ARCHS = ["qwen3-0.6b_smoke", "deepseek-v2-lite-16b_smoke"]
RC_KW = dict(dtype="float32", param_dtype="float32", remat="none")
TOL = dict(atol=2e-5, rtol=2e-5)
B, S = 2, 12


def _tokens(cfg, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    """The arch's weights in both packages, the reference's calibration
    registry under ``*=int8`` and the port's, on one batch."""
    arch = request.param
    cfg, tcfg = get_config(arch), t_get_config(arch)
    rc = RunConfig(quant_policy="*=int8", **RC_KW)
    trc = TRunConfig(quant_policy="*=int8", **RC_KW)
    params = j_init(cfg, rc, jax.random.PRNGKey(0))
    tparams = params_from_reference(jax.tree.map(np.asarray, params), device="cpu")
    calib = _tokens(cfg, 1)
    with j_cal.calibrating() as jreg:
        h, _, _ = j_forward(cfg, rc, params, {"tokens": jnp.asarray(calib)})
        jax.block_until_ready(h)
    with t_cal.calibrating() as treg:
        forward(tcfg, trc, tparams, input_batch(tcfg, torch.from_numpy(calib).long()))
    return arch, params, tparams, dict(jreg), dict(treg)


def test_registries_match_reference(setup):
    arch, _, _, jreg, treg = setup
    assert treg.keys() == jreg.keys() and len(treg) >= 4
    if arch.startswith("deepseek"):
        assert any(k.startswith("moe.") for k in treg)
    for k, v in jreg.items():
        np.testing.assert_allclose(treg[k], v, rtol=1e-6, atol=0, err_msg=k)


def test_static_scale_records_match_reference(setup):
    """One registry (the reference's) given to both packages: the collector's
    records identical, clipping included, and the hidden states within TOL.
    The records are compared as multisets: the reference's host callbacks
    are unordered, so XLA may emit one layer's q, k and v in any order."""
    arch, params, tparams, jreg, _ = setup
    cfg, tcfg = get_config(arch), t_get_config(arch)
    policy = "*=int8:stats"
    rc, trc = RunConfig(quant_policy=policy, **RC_KW), TRunConfig(quant_policy=policy, **RC_KW)
    toks = _tokens(cfg, 2)
    with j_cal.static_scales(jreg), j_collecting() as jcol:
        jh, _, _ = j_forward(cfg, rc, params, {"tokens": jnp.asarray(toks)})
        jax.block_until_ready(jh)
    with t_cal.static_scales(jreg), collecting() as tcol:
        th, _, _ = forward(tcfg, trc, tparams, input_batch(tcfg, torch.from_numpy(toks).long()))
    assert len(tcol.records) == len(jcol.records) > 0
    got = [dataclasses.astuple(r) for r in tcol.records]
    want = [dataclasses.astuple(r) for r in jcol.records]
    assert sorted(got) == sorted(want)
    # static scales are what lets max |q| fall below the top code
    assert min(r.max_abs for r in tcol.records) < 127
    assert tcol.profile().expected_max() == jcol.profile().expected_max()
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)


def _operands(seed, shape=(6, 16), n=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal((shape[-1], n)).astype(np.float32)
    return x, w


def test_absent_name_runs_dynamic_and_static_overrides_per_token():
    x, w = _operands(3)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    be, jbe = GemmBackend("int8", act_scale="token"), JBackend("int8", act_scale="token")
    dyn = t_gemm(tx, tw, backend=be, name="a")
    with t_cal.static_scales({"b": 0.5}), ops.counting_dispatches() as log:
        same = t_gemm(tx, tw, backend=be, name="a")
    assert torch.equal(same, dyn) and log == ["fused_scales", "matmul_fused"]
    # a registry value below the absmax clips; the port equals the reference
    reg = {"a": float(np.abs(x).max()) / 3}
    with t_cal.static_scales(reg), ops.counting_dispatches() as log:
        st = t_gemm(tx, tw, backend=be, name="a")
    assert log == ["scale_w", "matmul_fused"]
    with j_cal.static_scales(reg):
        jst = j_gemm(jnp.asarray(x), jnp.asarray(w), backend=jbe, name="a")
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
    assert not torch.equal(st, dyn)
    # the static sx is the per-tensor reg / hi (a division), whatever act_scale
    sx = torch.tensor(reg["a"] / 127, dtype=torch.float32)
    want = ops.matmul_fused(tx, tw, sx=sx, sw=tw.abs().amax(0).clamp_min(1e-8) * (1 / 127),
                            bits=8, impl="torch")
    np.testing.assert_array_equal(st.numpy(), want.numpy())
    # the unfused pipeline takes the same static sx
    with t_cal.static_scales(reg):
        un = t_gemm(tx, tw, backend=GemmBackend("int8", fused=False, act_scale="token"), name="a")
    np.testing.assert_array_equal(un.numpy(), st.numpy())


def test_expert_stack_matches_reference_vmap():
    """An (E, M, K) expert stack: one observed absmax over every expert (the
    reference's vmapped callback folds each expert into one running max),
    then one static sx shared by the experts and per-expert weight scales."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    x[1] *= 4
    w = rng.standard_normal((3, 16, 8)).astype(np.float32)
    jbe = JBackend("int2")

    def jcall(xe, we):
        return j_gemm(xe, we, backend=jbe, name="moe.e")

    with j_cal.calibrating() as jreg:
        jax.block_until_ready(jax.vmap(jcall)(jnp.asarray(x), jnp.asarray(w)))
    with t_cal.calibrating() as treg:
        t_gemm(torch.from_numpy(x), torch.from_numpy(w), backend=GemmBackend("int2"), name="moe.e")
    assert dict(treg) == dict(jreg) == {"moe.e": float(np.abs(x).max())}
    reg = {"moe.e": float(np.abs(x).max()) / 2}
    with j_cal.static_scales(reg):
        jy = jax.vmap(jcall)(jnp.asarray(x), jnp.asarray(w))
    for fused in (True, False):
        with t_cal.static_scales(reg):
            ty = t_gemm(torch.from_numpy(x), torch.from_numpy(w),
                        backend=GemmBackend("int2", fused=fused), name="moe.e")
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


def test_bf16_gemms_are_not_observed():
    x, w = _operands(6)
    with t_cal.calibrating() as reg:
        t_gemm(torch.from_numpy(x), torch.from_numpy(w), name="head")
        t_gemm(torch.from_numpy(x), torch.from_numpy(w), backend=GemmBackend("int8"),
               name="attn.wq")
    assert set(reg) == {"attn.wq"}
    assert reg["attn.wq"] == float(np.abs(x).max())


def test_contexts_nest_and_restore():
    assert t_cal.active_observer() is None and t_cal.active_scales() is None
    with t_cal.calibrating() as outer:
        with t_cal.calibrating() as inner:
            assert t_cal.active_observer() is inner
            t_cal.observe("a", torch.tensor([-3.0, 1.0]))
        assert t_cal.active_observer() is outer and "a" not in outer
        t_cal.observe("a", torch.tensor([2.0]))
        t_cal.observe("a", torch.tensor([0.5]))
        assert outer == {"a": 2.0} and inner == {"a": 3.0}
        with t_cal.static_scales({"a": 1.0}):
            with pytest.raises(RuntimeError):
                with t_cal.static_scales({"b": 2.0}):
                    assert t_cal.active_scales() == {"b": 2.0}
                    raise RuntimeError
            assert t_cal.active_scales() == {"a": 1.0}
        assert t_cal.active_scales() is None
        with pytest.raises(KeyError):
            with t_cal.calibrating():
                raise KeyError
        assert t_cal.active_observer() is outer
    assert t_cal.active_observer() is None
    t_cal.observe("a", torch.ones(2))   # no observer: a no-op


def test_edge_deployment_runs_on_cpu(capsys):
    """The port's edge-deployment study end to end on the CPU, against the
    reference example's steps on the same weights (the reference's
    ``PRNGKey(0)`` draw carried across) and the same numpy tokens: the
    static-scale calibration at 8, 4 and 2 bits, the Fig 5 records and
    profiles exactly, the hidden-state cosines within f32 rounding, the
    tile plans exactly, and the example's two asserts (int8 cosine above
    0.99, int8 above int2)."""
    from repro.core.tiling import GemmTask as JTask
    from repro.core.tiling import TileConfig as JTile
    from repro.core.tiling import plan_workload as j_plan
    from repro_torch import edge_deployment

    cfg = get_config(edge_deployment.ARCH)
    rc_f = RunConfig(**RC_KW)
    params = j_init(cfg, rc_f, jax.random.PRNGKey(0))
    tparams = params_from_reference(jax.tree.map(np.asarray, params), device="cpu")
    out = edge_deployment.main(device="cpu", params=tparams)

    def fwd(rc, seed):
        toks = edge_deployment._tokens(t_get_config(cfg.name), seed, "cpu").numpy()
        h, _, _ = j_forward(cfg, rc, params, {"tokens": jnp.asarray(toks.astype(np.int32))})
        return jax.block_until_ready(h)

    h_ref = fwd(rc_f, 1)
    profs = {}
    for bits in (8, 4, 2):
        with j_cal.calibrating() as reg:
            fwd(RunConfig(quant_policy=f"*=int{bits}", **RC_KW), 2)
        with j_cal.static_scales(reg), j_collecting(bitwidth=bits) as jcol:
            h_q = fwd(RunConfig(quant_policy=f"*=int{bits}:stats", **RC_KW), 1)
        profs[bits] = jcol.profile()
        cos = float((h_ref * h_q).sum()
                    / jnp.maximum(jnp.linalg.norm(h_ref) * jnp.linalg.norm(h_q), 1e-9))
        tcol = out["profiles"][bits]
        assert len(tcol.records) == len(jcol.records) == 14, bits
        assert (sorted(dataclasses.astuple(r) for r in tcol.records)
                == sorted(dataclasses.astuple(r) for r in jcol.records)), bits
        assert tcol.profile().expected_max() == profs[bits].expected_max(), bits
        np.testing.assert_allclose(out["cosine"][bits], cos, rtol=1e-5, atol=0, err_msg=str(bits))

    full = get_config(edge_deployment.PLAN_ARCH)
    d, hd, h, kv, ff, L = (full.d_model, full.resolved_head_dim, full.num_heads,
                           full.num_kv_heads, full.d_ff, full.num_layers)
    tasks = [JTask("qkv+o", 1, d, (h + 2 * kv) * hd + h * hd, count=L),
             JTask("mlp", 1, d, 2 * ff, count=L), JTask("mlp_down", 1, ff, d, count=L),
             JTask("lm_head", 1, d, full.vocab_size, count=1)]
    assert len(out["plans"]) == 6
    for (variant, bits), rep in out["plans"].items():
        want = j_plan(tasks, JTile(variant=variant, S=16, bitwidth=bits, units=64),
                      profile=profs[8])
        assert dataclasses.asdict(rep) == dataclasses.asdict(want), (variant, bits)

    assert out["cosine"][8] > 0.99 and out["cosine"][8] > out["cosine"][2]
    assert out["profiles"][8].profile().expected_max() < 127
    assert "[edge_deployment] OK" in capsys.readouterr().out
