"""Port parity: one prefill tick and one decode tick of the mixed step on
``qwen3-0.6b_smoke`` over the paged int8 KV pool, reference (jitted JAX)
against the port (plain PyTorch versions on the CPU), with the reference's
weights carried across by ``repro_torch.interop``.

Tolerance on logits: ``atol=rtol=1e-5`` — f32 on both sides; the two
frameworks order sums (matmuls, RMS-norm means, attention) differently and
their exp/sin/cos/rsqrt differ in the last bit, nothing else. Under the
slice's mixed int8/int2 policy the per-bitwidth cycle totals must be
identical: no quantization code may flip.

The int8 KV codes must be identical too. Their per-token scales are held
to ``rtol=1e-6`` (a few f32 ulps): the amax they come from carries the
float-order differences above, and the reference writes
``max(amax, 1e-8) / 127.0``, which XLA compiles inside the jitted step into
a multiply by the f32 reciprocal of 127, while the port keeps the division
form of the reference's source (and matches its eager result bit for bit,
tests/test_torch_quant.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig, get_config
from repro.models import init as j_init
from repro.models import init_caches as j_init_caches
from repro.quant.capture import tree_totals_by_bits as j_totals
from repro.serve.cache import BlockManager
from repro.serve.scheduler import build_mixed_step as j_build
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import get_config as t_get_config
from repro_torch.interop import caches_from_reference, params_from_reference, to_numpy
from repro_torch.models import init_caches as t_init_caches
from repro_torch.quant.capture import tree_totals_by_bits as t_totals
from repro_torch.serve.scheduler import build_mixed_step as t_build

torch.set_float32_matmul_precision("highest")
ARCH = "qwen3-0.6b_smoke"
RC_KW = dict(dtype="float32", param_dtype="float32", remat="none", prefill_chunk=5,
             kv_cache_dtype="int8", kv_layout="paged", block_size=4)


def _ticks(policy):
    cfg, tcfg = get_config(ARCH), t_get_config(ARCH)
    rc = RunConfig(quant_policy=policy, **RC_KW)
    trc = TRunConfig(quant_policy=policy, **RC_KW)
    params = j_init(cfg, rc, jax.random.PRNGKey(0))
    tparams = params_from_reference(jax.tree.map(np.asarray, params), device="cpu")
    B, W, cap = 3, 5, 16
    mgr = BlockManager(B * cap // 4, 4, B, cap)
    lens = np.array([5, 3, 0], np.int32)
    for b in range(B):
        mgr.extend(b, int(lens[b]) + 1)
    tables = mgr.tables.copy()
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, W)).astype(np.int32)
    dec = np.array([[7], [9], [0]], np.int32)
    dlens = (lens > 0).astype(np.int32)
    ticks = [(tokens, np.zeros(B, np.int32), lens), (dec, lens, dlens)]

    caches = j_init_caches(cfg, rc, B, cap, num_pages=mgr.num_pages)
    tcaches = caches_from_reference(jax.tree.map(np.asarray, caches), device="cpu")
    jstep = jax.jit(j_build(cfg, rc, with_stats=True))
    tstep = t_build(tcfg, trc, with_stats=True)
    out = []
    for tok, pos, ln in ticks:
        caches, jl, jtree = jstep(params, caches, jnp.asarray(tok), jnp.asarray(pos),
                                  jnp.asarray(ln), jnp.asarray(tables))
        tcaches, tl, tcap = tstep(tparams, tcaches, torch.from_numpy(tok),
                                  torch.from_numpy(pos), torch.from_numpy(ln),
                                  torch.from_numpy(tables))
        out.append((np.asarray(jl), tl.numpy(), j_totals(jtree), t_totals(tcap),
                    jax.tree.map(np.asarray, caches), to_numpy(tcaches)))
    return out, lens


@pytest.mark.parametrize("policy", ["*=bf16", "attn.*=int8,mlp.*=int2,*=bf16"])
def test_mixed_step_logits_match_reference(policy):
    ticks, lens = _ticks(policy)
    live = lens > 0
    for jl, tl, jt, tt, jc, tc in ticks:
        np.testing.assert_allclose(tl[live], jl[live], atol=1e-5, rtol=1e-5)
        assert jt == tt
        if policy != "*=bf16":
            assert set(tt) == {8, 2} and all(v["serial_cycles"] > 0 for v in tt.values())
        jk, tk = jc[0]["k0"], tc[0]["k0"]
        # every page but the trash page (the last), which takes padded writes
        for name in ("k", "v"):
            np.testing.assert_array_equal(jk[name][:, :-1], tk[name][:, :-1], err_msg=name)
        for name in ("k_scale", "v_scale"):
            np.testing.assert_allclose(tk[name][:, :-1], jk[name][:, :-1], rtol=1e-6, atol=0)


def _old_draws(cfg, dtype):
    """The CPU draws as the port made them before leaves were drawn on their
    generator's device: one seeded CPU generator, each linear leaf an f32
    ``randn * 0.02`` cast to ``dtype``, norms ones, in tree order."""
    from repro_torch.models.transformer import plan_groups

    gen = torch.Generator().manual_seed(0)
    d, h, kv, hd, ff = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
                        cfg.d_ff)
    draw = lambda *s: (torch.randn(s, generator=gen, dtype=torch.float32) * 0.02).to(dtype)  # noqa
    out = {"embed.embedding": draw(cfg.vocab_size, d)}
    for gi, g in enumerate(plan_groups(cfg)):
        L = g.repeats
        for j in range(len(g.kinds)):
            pre = f"groups.{gi}.k{j}."
            for n, shape in (("attn.wq", (d, h * hd)), ("attn.wk", (d, kv * hd)),
                             ("attn.wv", (d, kv * hd)), ("attn.wo", (h * hd, d)),
                             ("ffn.w_gate", (d, ff)), ("ffn.w_up", (d, ff)),
                             ("ffn.w_down", (ff, d))):
                out[pre + n + ".kernel"] = draw(L, *shape)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_cpu_generator_keeps_its_values(dtype):
    """A CPU generator draws every leaf as before, bit for bit (the CPU
    tests' and qwen3-0.6b's card weights depend on them)."""
    from repro_torch.interop import flat_leaves
    from repro_torch.models import init

    name = {torch.float32: "float32", torch.bfloat16: "bfloat16"}[dtype]
    cfg = t_get_config(ARCH)
    got = flat_leaves(init(cfg, TRunConfig(dtype=name, param_dtype=name, kv_layout="paged"),
                           torch.Generator().manual_seed(0), device="cpu"))
    want = {k: v.view(torch.int16) if v.dtype == torch.bfloat16 else v
            for k, v in _old_draws(cfg, dtype).items()}
    kernels = {k for k in got if k.endswith(".kernel") or k.endswith(".embedding")}
    assert kernels == set(want)
    for k in kernels:
        np.testing.assert_array_equal(got[k], want[k].numpy(), err_msg=k)
    norms = [k for k in got if k.endswith(".scale")]
    assert norms and all((got[k] == (16256 if dtype == torch.bfloat16 else 1.0)).all()
                         for k in norms)


def test_init_mla_moe_tree_matches_reference_layout():
    """deepseek-v2-lite-16b_smoke: the port's init gives the reference's
    paths and shapes, and each leaf's init: norms ones, linears std 0.02,
    the router std 0.02/sqrt(d_model)."""
    from repro_torch.interop import flat_leaves
    from repro_torch.models import init

    arch = "deepseek-v2-lite-16b_smoke"
    cfg = get_config(arch)
    rc = RunConfig(dtype="float32", param_dtype="float32", kv_layout="paged")
    want = flat_leaves(jax.tree.map(np.asarray, j_init(cfg, rc, jax.random.PRNGKey(0))))
    got = flat_leaves(init(t_get_config(arch), TRunConfig(dtype="float32",
                                                          param_dtype="float32",
                                                          kv_layout="paged"), device="cpu"))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
        if k.endswith(".scale"):
            assert (got[k] == 1).all(), k
        elif got[k].size > 1000:
            std = 0.02 / cfg.d_model ** 0.5 if ".router." in k else 0.02
            assert abs(got[k].std() / std - 1) < 0.1, (k, got[k].std())
