"""Port parity for MLA (DeepSeek-V2's multi-head latent attention) on the
paged KV pool: ``repro_torch.models.attention.mla_attention`` and the mixed
step of ``deepseek-v2-lite-16b_smoke`` against the reference (jitted JAX on
the CPU; the port's plain versions), reference weights carried across by
``repro_torch.interop``.

Tolerances: outputs and logits ``atol=rtol=1e-5`` (f32 on both sides; the
frameworks order sums differently — the absorbed ``w_uk`` / ``w_uv``
einsums, RMS norms, attention — and their exp/sin/cos/rsqrt differ in the
last bit). The int8 ``ckv`` / ``kr`` codes must be identical, their
per-token scales within ``rtol=1e-6`` (ROADMAP C3: XLA compiles the
reference's division by 127 into a reciprocal multiply). The f32 pools are
held to the output tolerance. Under a quantized policy the per-bitwidth
cycle totals must be identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig, get_config
from repro.models import KVView as JKVView
from repro.models import init as j_init
from repro.models import init_caches as j_init_caches
from repro.models.attention import mla_attention as j_mla
from repro.models.transformer import backend_from as j_backend_from
from repro.quant.capture import tree_totals_by_bits as j_totals
from repro.serve.cache import BlockManager
from repro.serve.scheduler import build_mixed_step as j_build
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import get_config as t_get_config
from repro_torch.interop import caches_from_reference, params_from_reference, to_numpy
from repro_torch.kernels import ops
from repro_torch.models import KVView, init_caches
from repro_torch.models.attention import mla_attention as t_mla
from repro_torch.models.transformer import backend_from as t_backend_from
from repro_torch.quant.capture import tree_totals_by_bits as t_totals
from repro_torch.serve.scheduler import build_mixed_step as t_build

torch.set_float32_matmul_precision("highest")
ARCH = "deepseek-v2-lite-16b_smoke"
RC_KW = dict(dtype="float32", param_dtype="float32", remat="none", prefill_chunk=5,
             kv_layout="paged", block_size=4)
TOL = dict(atol=1e-5, rtol=1e-5)


def _pools_equal(jc: dict, tc: dict, int8: bool) -> None:
    """Every page but the trash page (the last, which takes padded writes)."""
    for name in ("ckv", "kr"):
        if int8:
            np.testing.assert_array_equal(tc[name][..., :-1, :, :], jc[name][..., :-1, :, :],
                                          err_msg=name)
            np.testing.assert_allclose(tc[name + "_scale"][..., :-1, :],
                                       jc[name + "_scale"][..., :-1, :], rtol=1e-6, atol=0)
        else:
            np.testing.assert_allclose(tc[name][..., :-1, :, :], jc[name][..., :-1, :, :],
                                       **TOL)


@pytest.mark.parametrize("kv_dtype", ["int8", "float32"])
@pytest.mark.parametrize("policy", ["*=bf16", "mla.*=int8,*=bf16"])
def test_mla_attention_on_paged_pools_matches_reference(kv_dtype, policy):
    """One MLA layer twice over the same pool: a prefill of 6 / 3 / 0 tokens
    from position 0, then a 1-token step; the pools after each write and
    the layer outputs of the live rows agree."""
    cfg, tcfg = get_config(ARCH), t_get_config(ARCH)
    rc = RunConfig(quant_policy=policy, kv_cache_dtype=kv_dtype, **RC_KW)
    trc = TRunConfig(quant_policy=policy, kv_cache_dtype=kv_dtype, **RC_KW)
    params = j_init(cfg, rc, jax.random.PRNGKey(1))
    p = jax.tree.map(lambda a: np.asarray(a)[0], params["groups"][0]["k0"]["attn"])
    tp = params_from_reference(p, device="cpu")
    B, bs, MB = 3, 4, 3
    caches = jax.tree.map(lambda a: a[0], j_init_caches(cfg, rc, B, bs * MB,
                                                        num_pages=B * MB)[0]["k0"])
    tcaches = caches_from_reference(jax.tree.map(np.asarray, caches), device="cpu")
    tables = np.arange(B * MB, dtype=np.int32).reshape(B, MB)
    rng = np.random.default_rng(3)
    steps = [(np.zeros(B, np.int32), np.array([6, 3, 0], np.int32), 6),
             (np.array([6, 3, 0], np.int32), np.array([1, 1, 0], np.int32), 1)]
    for pos, lens, S in steps:
        x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        positions = pos[:, None] + np.arange(S, dtype=np.int32)[None]
        jview = JKVView(jnp.asarray(pos), jnp.asarray(lens), jnp.asarray(tables), bs, "paged")
        jy, caches = j_mla(cfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                           jnp.asarray(positions), backend=j_backend_from(rc), cache=caches,
                           kv_view=jview)
        view = KVView(pos=torch.from_numpy(pos), lens=torch.from_numpy(lens),
                      tables=torch.from_numpy(tables), block_size=bs)
        ops.reset_counts()
        ty = t_mla(tcfg, tp, torch.from_numpy(x), torch.from_numpy(positions).long(),
                   backend=t_backend_from(trc), cache=tcaches, kv_view=view)
        assert ops.path_counts()["mla.paged"] == {"torch": 1}
        _pools_equal(jax.tree.map(np.asarray, caches), to_numpy(tcaches), kv_dtype == "int8")
        for b in range(B):
            n = int(lens[b])
            np.testing.assert_allclose(ty[b, :n].numpy(), np.asarray(jy)[b, :n], **TOL)
    ops.reset_counts()


def _ticks(policy):
    """A prefill tick (rows of 5, 3 and 0 tokens) and a decode tick of the
    mixed step in both packages, jitted reference against the port."""
    cfg, tcfg = get_config(ARCH), t_get_config(ARCH)
    rc = RunConfig(quant_policy=policy, kv_cache_dtype="int8", **RC_KW)
    trc = TRunConfig(quant_policy=policy, kv_cache_dtype="int8", **RC_KW)
    params = j_init(cfg, rc, jax.random.PRNGKey(0))
    tparams = params_from_reference(jax.tree.map(np.asarray, params), device="cpu")
    B, W, cap = 3, 5, 16
    mgr = BlockManager(B * cap // 4, 4, B, cap)
    lens = np.array([5, 3, 0], np.int32)
    for b in range(B):
        mgr.extend(b, int(lens[b]) + 1)
    tables = mgr.tables.copy()
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, W)).astype(np.int32)
    ticks = [(tokens, np.zeros(B, np.int32), lens),
             (np.array([[7], [9], [0]], np.int32), lens, (lens > 0).astype(np.int32))]
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


@pytest.mark.parametrize("policy", ["*=bf16", "mla.*=int8,*=int2",
                                    "mla.*=int8,moe.*=int2,mlp.*=int2,*=bf16"])
def test_mla_moe_mixed_step_matches_reference(policy):
    ticks, lens = _ticks(policy)
    live = lens > 0
    for jl, tl, jt, tt, jc, tc in ticks:
        np.testing.assert_allclose(tl[live], jl[live], **TOL)
        assert jt == tt
        if policy != "*=bf16":
            assert set(tt) == {8, 2} and all(v["serial_cycles"] > 0 for v in tt.values())
        # the group's three blocks: the dense layer 0 and two MoE layers
        for blk in ("k0", "k1", "k2"):
            _pools_equal(jc[0][blk], tc[0][blk], True)


def test_mla_caches_carry_across():
    """The reference's MLA pools (int8 codes and scales, and f32 pools)
    become the port's tree of the same paths, shapes and bytes."""
    for kv in ("int8", "bfloat16"):
        cfg = get_config(ARCH)
        rc = RunConfig(kv_cache_dtype=kv, **RC_KW)
        jc = jax.tree.map(np.asarray, j_init_caches(cfg, rc, 2, 8, num_pages=4))
        tc = caches_from_reference(jc, device="cpu")
        want = init_caches(t_get_config(ARCH), TRunConfig(kv_cache_dtype=kv, **RC_KW), 2, 8,
                           num_pages=4, device="cpu")
        for g, (a, b) in enumerate(zip(tc, want)):
            for blk in a:
                assert a[blk].keys() == b[blk].keys() == jc[g][blk].keys()
                for n in a[blk]:
                    assert a[blk][n].shape == b[blk][n].shape and a[blk][n].dtype == b[blk][n].dtype


def test_mla_moe_incremental_matches_one_step():
    """Prefill of T tokens then one-token steps give the hidden states of one
    step over all the tokens (the reference's incremental-vs-full test on
    the paged path): f32, bf16 GEMMs, dropless capacity (capacity depends on
    the step width, so different widths would drop different tokens)."""
    from repro_torch.models import forward, init
    from repro_torch.serve.cache import BlockManager as TBlockManager

    cfg = t_get_config(ARCH).replace(capacity_factor=16.0)
    rc = TRunConfig(kv_cache_dtype="float32", **RC_KW)
    params = init(cfg, rc, device="cpu")
    B, T, extra, cap = 2, 8, 4, 16
    toks = torch.randint(0, cfg.vocab_size, (B, T + extra),
                         generator=torch.Generator().manual_seed(0))
    mgr = TBlockManager(B * cap // 4, 4, B, cap)
    for b in range(B):
        mgr.extend(b, T + extra)
    tables = torch.from_numpy(mgr.tables.copy())

    def run(chunks):
        caches = init_caches(cfg, rc, B, cap, num_pages=mgr.num_pages, device="cpu")
        pos, hs = 0, []
        for n in chunks:
            p = torch.full((B,), pos, dtype=torch.int32)
            view = KVView(pos=p, lens=torch.full((B,), n, dtype=torch.int32), tables=tables,
                          block_size=4)
            h, caches, _ = forward(cfg, rc, params, {"tokens": toks[:, pos:pos + n]},
                                   caches=caches, cache_pos=p, kv_view=view)
            hs.append(h)
            pos += n
        return torch.cat(hs, dim=1)

    full = run([T + extra])
    inc = run([T] + [1] * extra)
    np.testing.assert_allclose(inc[:, T:].numpy(), full[:, T:].numpy(), atol=1e-4, rtol=1e-4)
