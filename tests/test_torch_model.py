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
