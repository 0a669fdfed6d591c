"""Port parity for the MoE slice: the expert axis of the fused GEMM and of
the stats assembly, and ``repro_torch.models.moe.moe_ffn`` against the
reference's ``repro.models.moe`` on ``deepseek-v2-lite-16b_smoke``, on the
same seeded numpy inputs (the reference on its XLA path, the port on its
plain versions on the CPU).

Exact (integers, dtypes included): the batched plain ``tugemm_fused``
against E single calls and against the reference's vmapped fused oracle
(y, ca, rb); ``ops.matmul_fused`` / ``tugemm_stats`` over experts against
single calls; the router's top-k indices, every group's dispatch slots
(``dest``), the drop count and the expert GEMMs' stats with their leading
(E,) axis, under fused and unfused expert rules (the unfused route's own
parity against the reference's vmap is ``tests/test_torch_unfused_experts.py``).
The MoE output is held to 1e-5 absolute + 1e-5 relative in f32:
the router's f32 softmax may differ from XLA's by an ulp, which moves the
gate weights by as much."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig, get_config
from repro.kernels.ref import fused_gemm_ref as j_fused_gemm_ref
from repro.models import init as j_init
from repro.models import moe as j_moe
from repro.quant import capture as j_capture
from repro.quant.qlinear import GemmBackend as JBackend
from repro.quant.qlinear import dense as j_dense
from repro.quant.quantize import fused_scales as j_fused_scales
from repro.quant.surgery import forward_with_stats
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import get_config as t_get_config
from repro_torch.interop import params_from_reference, tensor_from_numpy
from repro_torch.kernels import ops
from repro_torch.kernels.packing import PLANES
from repro_torch.kernels.tugemm_fused import tugemm_fused
from repro_torch.kernels.unary_stats import tugemm_stats
from repro_torch.models import moe as t_moe
from repro_torch.models import KVView, forward, init_caches
from repro_torch.quant import capture as t_capture
from repro_torch.quant.qlinear import GemmBackend as TBackend
from repro_torch.quant.qlinear import QBits as TQBits
from repro_torch.quant.qlinear import dense as t_dense
from repro_torch.quant.quantize import fused_scales as t_fused_scales

torch.set_float32_matmul_precision("highest")
ARCH = "deepseek-v2-lite-16b_smoke"
RC_KW = dict(dtype="float32", param_dtype="float32", remat="none", prefill_chunk=5,
             kv_cache_dtype="int8", kv_layout="paged", block_size=4)
OUT_TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return tensor_from_numpy(np.asarray(a), device="cpu")


# ------------------------------------------------- the fused GEMM over experts
MODES = [("quant", 8), ("quant", 2), ("int8", 8), ("packed", 2), ("packed", 4)]


def _expert_operands(E, M, K, N, mode, bits, seed, per_token=False):
    """x (E, M, Kx) f32 with empty experts and slots, w (E, Kw, N), sx, sw."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((E, M, K)).astype(np.float32)
    x[:, M - 2:] = 0            # empty slots
    x[1] = 0                    # an expert that received no token
    xt = torch.from_numpy(x)
    if mode == "quant":
        w = torch.from_numpy((rng.standard_normal((E, K, N)) * 0.1).astype(np.float32))
        sx, sw = t_fused_scales(xt, w, bits, per_token)
        return xt, w, sx, sw
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    wq = torch.from_numpy(rng.integers(lo, hi + 1, (E, K, N)).astype(np.int8))
    w = torch.stack([ops.pack_weights(wi, bits) for wi in wq]) if mode == "packed" else wq
    sx = t_fused_scales(xt, torch.ones(E, K, N), bits, per_token)[0]
    sw = torch.from_numpy((rng.random((E, N)) * 0.01 + 1e-3).astype(np.float32))
    return xt, w, sx, sw


def _kernel_args(x, w, sx, sw, mode, bits):
    planes = PLANES[bits] if mode == "packed" else 1
    Kx = planes * w.shape[-2]
    if x.shape[-1] < Kx:
        x = torch.nn.functional.pad(x, (0, Kx - x.shape[-1]))
    E, M = x.shape[:2]
    sx3 = sx.reshape(E, -1, 1) if sx.numel() > E else sx.reshape(E, 1, 1)
    return x, w, sx3, sw.reshape(E, 1, -1)


@pytest.mark.parametrize("mode,bits", MODES)
@pytest.mark.parametrize("per_token", [False, True])
def test_batched_plain_fused_is_e_single_calls(mode, bits, per_token):
    """tugemm_fused's plain version over a leading expert axis equals E calls
    of today's single-GEMM plain version, bit for bit (y, ca, rb)."""
    E, M, K, N = 5, 12, 70, 33
    x, w, sx, sw = _kernel_args(*_expert_operands(E, M, K, N, mode, bits, 3, per_token),
                                mode, bits)
    kw = dict(bits=bits, w_mode=mode, collect_stats=True, out_dtype=torch.float32)
    bias = torch.from_numpy(np.random.default_rng(4).standard_normal((E, N)).astype(np.float32))
    y, ca, rb = tugemm_fused(x, w, sx, sw, bias, impl="torch", **kw)
    assert y.shape == (E, M, N) and ca.shape[0] == rb.shape[0] == E
    for e in range(E):
        ye, cae, rbe = tugemm_fused(x[e], w[e], sx[e], sw[e], bias[e], impl="torch", **kw)
        assert torch.equal(y[e], ye) and torch.equal(ca[e], cae) and torch.equal(rb[e], rbe)


@pytest.mark.parametrize("mode,bits", MODES)
def test_batched_plain_fused_matches_reference_vmap(mode, bits):
    """The same batched call against the reference's fused oracle vmapped
    over the experts: y exact, ca and rb exact in logical K order."""
    E, M, K, N = 4, 8, 64, 40
    x, w, sx, sw = _kernel_args(*_expert_operands(E, M, K, N, mode, bits, 5), mode, bits)
    y, ca, rb = tugemm_fused(x, w, sx, sw, None, bits=bits, w_mode=mode, collect_stats=True,
                             out_dtype=torch.float32, impl="torch")
    fn = lambda xi, wi, sxi, swi: j_fused_gemm_ref(  # noqa: E731
        xi, wi, sxi, swi, bits=bits, w_mode=mode, collect_stats=True)
    jy, jca, jrb = jax.vmap(fn)(*(jnp.asarray(t.numpy()) for t in (x, w, sx, sw)))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(ca.reshape(E, -1).numpy(), np.asarray(jca))
    np.testing.assert_array_equal(rb.transpose(1, 2).reshape(E, -1).numpy(), np.asarray(jrb))


@pytest.mark.parametrize("w_quantized", [False, True])
def test_matmul_fused_over_experts_is_one_call(w_quantized):
    """ops.matmul_fused on an expert stack: one recorded call, one plain
    fused call and one plain stats assembly, with TuGemmStats fields that
    stack the E single calls' fields exactly."""
    E, M, K, N, bits = 4, 6, 48, 20, 2
    mode = "packed" if w_quantized else "quant"
    x, w, sx, sw = _expert_operands(E, M, K, N, mode, bits, 7)
    ops.reset_counts()
    y, st = ops.matmul_fused(x, w, sx=sx, sw=sw, bits=bits, w_quantized=w_quantized,
                             collect_stats=True, name="t.experts")
    counts = ops.kernel_counts()
    assert ops.path_counts() == {"t.experts": {"torch": 1}}
    assert counts["tugemm_fused"]["plain_calls"] == 1
    assert counts["tugemm_stats"]["plain_calls"] == 1
    assert st.serial_cycles.shape == (E,) and st.step_cycles.shape == (E, K)
    for e in range(E):
        ye, se = ops.matmul_fused(x[e], w[e], sx=sx[e], sw=sw[e], bits=bits,
                                  w_quantized=w_quantized, collect_stats=True)
        assert torch.equal(y[e], ye)
        for f, fe in zip(st, se):
            assert f[e].dtype == fe.dtype and torch.equal(f[e], fe)
    ops.reset_counts()


@pytest.mark.parametrize("planes", [1, 4])
@pytest.mark.parametrize("Kw", [16, 64, 200, 352, 512, 1408, 2048, 10944])
def test_expert_split_plan_covers_k(planes, Kw):
    """The plan of one launch over 64 experts: the widest tile; every K
    chunk in exactly one block of a cluster of at most 16; one plane in
    clusters of a power of two."""
    from repro_torch.kernels.tugemm_fused import BNS, KC, MAX_SPLITS, split_plan

    bn, splits, chunks = split_plan(16, 1408, Kw, planes, 132, 2, 64)
    k_chunks = -(-Kw // KC)
    assert bn == BNS[0] and 1 <= splits <= MAX_SPLITS
    assert splits * chunks >= k_chunks > (splits - 1) * chunks
    if planes == 1:
        assert splits & (splits - 1) == 0


def test_expert_split_plan_at_deepseek_shapes():
    """The swept plans at deepseek-v2-lite's expert GEMMs (PERF.md)."""
    from repro_torch.kernels.tugemm_fused import split_plan

    assert split_plan(16, 1408, 2048, 1, 132, 2, 64) == (128, 16, 2)
    assert split_plan(16, 2048, 1408, 1, 132, 2, 64) == (128, 8, 3)
    assert split_plan(16, 1408, 512, 4, 132, 2, 64) == (128, 1, 8)
    assert split_plan(16, 2048, 352, 4, 132, 2, 64) == (128, 1, 6)


def test_tugemm_stats_over_experts_is_e_assemblies():
    E, planes, Kw, K = 3, 4, 9, 34
    g = torch.Generator().manual_seed(0)
    ca = torch.randint(0, 3, (E, planes, Kw), generator=g, dtype=torch.int32)
    rb = torch.randint(0, 3, (E, Kw, planes), generator=g, dtype=torch.int32)
    got = tugemm_stats(ca, rb, K, impl="torch")
    for e in range(E):
        for f, fe in zip(got, tugemm_stats(ca[e], rb[e], K, impl="torch")):
            assert f[e].dtype == fe.dtype and torch.equal(f[e], fe)


def test_expert_scales_match_reference_vmap():
    """fused_scales over an expert stack: one scale per expert over its
    whole buffer (an empty expert through amax_to_scale's guard) and one
    per column per expert, bit for bit with the reference's vmap."""
    x, w, _, _ = _expert_operands(4, 8, 32, 16, "quant", 2, 9)
    sx, sw = t_fused_scales(x, w, 2)
    jsx, jsw = jax.vmap(lambda xi, wi: j_fused_scales(xi, wi, 2))(jnp.asarray(x.numpy()),
                                                                   jnp.asarray(w.numpy()))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx))
    np.testing.assert_array_equal(sw.numpy(), np.asarray(jsw))


@pytest.mark.parametrize("w_quantized", [False, True])
def test_expert_dense_matches_reference_vmap(w_quantized):
    """qlinear.dense on an expert stack (raw, or surgered into a packed
    leaf) against the reference's vmap of dense with return_stats: y and
    every stats field exact."""
    from repro.quant.surgery import _prequant_leaf as j_prequant_leaf
    from repro_torch.quant.surgery import _prequant_leaf as t_prequant_leaf

    x, w, _, _ = _expert_operands(4, 8, 64, 24, "quant", 2, 11)
    be = JBackend("int2", "prequant" if w_quantized else "dynamic")
    jw = jnp.asarray(w.numpy())
    if w_quantized:
        jleaf = j_prequant_leaf(jw, 2)
        from repro.quant.qlinear import QBits as JQBits
        jleaf["qbits"] = JQBits(2)
        tleaf = {**t_prequant_leaf(w, 2)}
        from repro_torch.quant.qlinear import QBits
        tleaf["qbits"] = QBits(2)
        fn = lambda qk, qs, xi: j_dense(  # noqa: E731
            {"qkernel": qk, "qscale": qs, "qbits": jleaf["qbits"]}, xi, backend=be,
            name="moe.gate", return_stats=True)
        jy, jst = jax.vmap(fn)(jleaf["qkernel"], jleaf["qscale"], jnp.asarray(x.numpy()))
    else:
        tleaf = {"kernel": w}
        fn = lambda wi, xi: j_dense({"kernel": wi}, xi, backend=be, name="moe.gate",  # noqa
                                    return_stats=True)
        jy, jst = jax.vmap(fn)(jw, jnp.asarray(x.numpy()))
    y, st = t_dense(tleaf, x, backend=TBackend("int2", "prequant" if w_quantized else "dynamic"),
                    name="moe.gate", return_stats=True)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    for f, jf in zip(st, jst):
        np.testing.assert_array_equal(f.numpy(), np.asarray(jf))


def test_unfused_expert_rule_raises():
    """An unfused rule on an expert stack no longer raises: it runs the
    unfused route (per-expert scales, one int8 GEMM over the experts), which
    equals the fused route's y and stats bit for bit, as on a 2-D GEMM."""
    x, w, _, _ = _expert_operands(2, 4, 16, 8, "quant", 8, 1)
    y, st = t_dense({"kernel": w}, x, backend=TBackend("int8", fused=False), name="moe.up",
                    return_stats=True)
    fy, fst = t_dense({"kernel": w}, x, backend=TBackend("int8"), name="moe.up",
                      return_stats=True)
    assert y.shape == (2, 4, 8) and torch.equal(y, fy)
    for f, ff in zip(st, fst):
        assert torch.equal(f, ff)


def test_unfused_packed_expert_rule_raises():
    """A surgered expert stack under an unfused rule no longer raises: the
    packed GEMM over the experts gives the fused rule's y on the same leaf,
    bit for bit."""
    x, w, _, sw = _expert_operands(2, 4, 16, 8, "packed", 2, 1)
    leaf = {"qkernel": w, "qscale": sw, "qbits": TQBits(2)}
    yu = t_dense(leaf, x, backend=TBackend("int2", "prequant", fused=False), name="moe.up")
    y = t_dense(leaf, x, backend=TBackend("int2", "prequant"), name="moe.up")
    assert y.shape == (2, 4, 8) and y.isfinite().all() and torch.equal(yu, y)


# ------------------------------------------------------------------ moe_ffn
@pytest.fixture(scope="module")
def layer():
    """The smoke model's first MoE layer (reference params) and a (3, 7, D)
    input whose last row is all padding token 0, as an idle row is."""
    cfg = get_config(ARCH)
    params = j_init(cfg, RunConfig(**RC_KW), jax.random.PRNGKey(0))
    p = jax.tree.map(lambda a: np.asarray(a)[0], params["groups"][0]["k1"]["ffn"])
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 7, cfg.d_model)).astype(np.float32)
    x[2] = x[2, :1]               # one repeated row, like a padded idle row
    return p, x


def _ref_moe(cfg, p, x, policy):
    jp = jax.tree.map(jnp.asarray, p)
    rc = RunConfig(quant_policy=policy, **RC_KW)
    from repro.models.transformer import backend_from

    with j_capture.capture_stats() as cap:
        y, aux = j_moe.moe_ffn(cfg, jp, jnp.asarray(x), backend=backend_from(rc))
    return y, aux, cap


@pytest.mark.parametrize("capacity_factor", [None, 16.0])
@pytest.mark.parametrize("policy", ["*=int2", "moe.*=int8,*=bf16", "*=int2:unfused",
                                    "moe.*=int8:unfused,*=bf16"])
def test_moe_ffn_matches_reference(layer, capacity_factor, policy):
    p, x = layer
    cfg, tcfg = get_config(ARCH), t_get_config(ARCH)
    if capacity_factor is not None:
        cfg, tcfg = (c.replace(capacity_factor=capacity_factor) for c in (cfg, tcfg))
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    cap = j_moe.moe_capacity(cfg, S)
    assert t_moe.moe_capacity(tcfg, S) == cap

    # router: the same logits -> the same top-k indices, exactly
    jlog = j_dense({"kernel": jnp.asarray(p["router"]["kernel"])}, jnp.asarray(x),
                   backend=JBackend("bf16"), name="moe.router")
    jprobs = jax.nn.softmax(jlog.astype(jnp.float32), axis=-1)
    _, jidx = jax.lax.top_k(jprobs, k)
    tp = params_from_reference(p, device="cpu")
    tlog = t_dense(tp["router"], _t(x), backend=TBackend("bf16"), name="moe.router")
    tidx = torch.topk(t_moe.router_probs(tlog), k, dim=-1).indices
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))

    # dispatch: every group's slots and rows
    jxin, jdest = jax.vmap(lambda xg, ig: j_moe._dispatch_group(xg, ig, E, cap))(
        jnp.asarray(x), jidx)
    txin, tdest = t_moe._dispatch_group(_t(x), tidx, E, cap)
    np.testing.assert_array_equal(tdest.numpy(), np.asarray(jdest))
    np.testing.assert_array_equal(txin.numpy(), np.asarray(jxin))

    # the whole layer under a capture
    jy, jaux, jcap = _ref_moe(cfg, p, x, policy)
    trc = TRunConfig(quant_policy=policy, **RC_KW)
    from repro_torch.models.transformer import backend_from

    with t_capture.capture_stats() as tcap:
        ty, taux = t_moe.moe_ffn(tcfg, tp, _t(x), backend=backend_from(trc))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **OUT_TOL)
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-6)

    jdrops = [int(s.value) for _, s in j_capture.tree_scalars(jcap.tree)]
    assert [int(s.value) for s in tcap.scalars] == jdrops
    assert t_capture.scalar_totals(tcap) == {"moe.dropped_tokens": sum(jdrops)}
    if capacity_factor is None:
        assert sum(jdrops) > 0                    # the default capacity drops
    else:
        assert sum(jdrops) == 0                   # dropless

    jents = {e.name: e for _, e in j_capture.tree_entries(jcap.tree)}
    tents = {e.name: e for e in tcap.entries}
    assert tents.keys() == jents.keys()
    assert "moe.router" not in tents
    for name in ("moe.gate", "moe.up", "moe.down"):
        te, je = tents[name], jents[name]
        assert (te.M, te.K, te.N, te.bits) == (je.M, je.K, je.N, je.bits) == (
            te.M, te.K, te.N, te.bits)
        assert te.M == B * cap
        assert te.stats.serial_cycles.shape == (E,)
        for f, jf in zip(te.stats, je.stats):
            np.testing.assert_array_equal(f.numpy(), np.asarray(jf), err_msg=name)


def test_routing_hook_records_and_forces(layer):
    """``moe.routing``: recording leaves the layer as it is and yields the
    router's own top-k ids; forcing those ids changes nothing, bit for bit;
    forcing the same experts in another order moves only the combine's
    summation order (f32 tolerance 1e-6); forcing other experts routes by
    them and the output changes."""
    from repro_torch.models.transformer import backend_from

    p, x = layer
    tcfg = t_get_config(ARCH)
    E, k = tcfg.num_experts, tcfg.num_experts_per_tok
    tp = params_from_reference(p, device="cpu")
    be = backend_from(TRunConfig(quant_policy="*=int2", **RC_KW))
    free, free_aux = t_moe.moe_ffn(tcfg, tp, _t(x), backend=be)
    with t_moe.routing() as seen:
        y, aux = t_moe.moe_ffn(tcfg, tp, _t(x), backend=be)
    tlog = t_dense(tp["router"], _t(x), backend=TBackend("bf16"), name="moe.router")
    assert len(seen) == 1
    assert torch.equal(seen[0], torch.topk(t_moe.router_probs(tlog), k, dim=-1).indices)
    assert torch.equal(y, free) and torch.equal(aux, free_aux)
    assert t_moe._ROUTING is None

    with t_moe.routing(seen) as again:
        y = t_moe.moe_ffn(tcfg, tp, _t(x), backend=be)[0]
    assert torch.equal(again[0], seen[0]) and torch.equal(y, free)

    rolled = [torch.roll(seen[0], 1, dims=-1)]
    with t_moe.routing(rolled) as again:
        y = t_moe.moe_ffn(tcfg, tp, _t(x), backend=be)[0]
    assert torch.equal(again[0], rolled[0])
    np.testing.assert_allclose(y.numpy(), free.numpy(), rtol=1e-6, atol=1e-6)

    other = [(seen[0] + 1) % E]
    with t_moe.routing(other) as again:
        y = t_moe.moe_ffn(tcfg, tp, _t(x), backend=be)[0]
    assert torch.equal(again[0], other[0])
    assert not np.allclose(y.numpy(), free.numpy(), rtol=1e-3, atol=1e-3)


def test_moe_expert_stats_cross_experts():
    """Mirror of the reference's expert-stats test: a whole forward under a
    capture, dropless, int8: the expert GEMMs carry a leading experts axis
    and the router stays bf16; the port's paged forward's totals equal the
    reference's paged forward's."""
    from repro.models import KVView as JKVView
    from repro.models import forward as j_forward
    from repro.models import init_caches as j_init_caches

    cfg = get_config(ARCH).replace(capacity_factor=16.0)
    tcfg = t_get_config(ARCH).replace(capacity_factor=16.0)
    rc = RunConfig(quant_policy="*=int8", **RC_KW)
    params = j_init(cfg, rc, jax.random.PRNGKey(4))
    toks = np.array(jax.random.randint(jax.random.PRNGKey(5), (2, 8), 0, cfg.vocab_size))
    _, _, _, tree = forward_with_stats(cfg, rc, params, {"tokens": jnp.asarray(toks)})
    ref_names = {e.name for _, e in j_capture.tree_entries(tree)}

    B, S = toks.shape
    pos = np.zeros(B, np.int32)
    lens = np.full(B, S, np.int32)
    tables = np.arange(B * 4, dtype=np.int32).reshape(B, 4)
    jview = JKVView(jnp.asarray(pos), jnp.asarray(lens), jnp.asarray(tables), 4, "paged")
    with j_capture.capture_stats() as jcap:
        j_forward(cfg, rc, params, {"tokens": jnp.asarray(toks)},
                  caches=j_init_caches(cfg, rc, B, 16, num_pages=B * 4),
                  cache_pos=jnp.asarray(pos), kv_view=jview)
    ref_tot = j_capture.tree_totals_by_bits(jcap.tree)

    trc = TRunConfig(quant_policy="*=int8", **RC_KW)
    tp = params_from_reference(jax.tree.map(np.asarray, params), device="cpu")
    view = KVView(pos=torch.from_numpy(pos), lens=torch.from_numpy(lens),
                  tables=torch.from_numpy(tables), block_size=4)
    with t_capture.capture_stats() as cap:
        forward(tcfg, trc, tp, {"tokens": torch.from_numpy(toks)},
                caches=init_caches(tcfg, trc, B, 16, num_pages=B * 4, device="cpu"),
                cache_pos=torch.from_numpy(pos), kv_view=view)
    by_name = {}
    for e in cap.entries:
        by_name.setdefault(e.name, e)
    assert set(by_name) == ref_names
    assert {"moe.gate", "moe.up", "moe.down"} <= set(by_name)
    assert "moe.router" not in by_name
    ser = by_name["moe.gate"].stats.serial_cycles
    assert ser.shape == (cfg.num_experts,) and (ser >= 0).all() and ser.sum() > 0
    assert t_capture.tree_totals_by_bits(cap) == ref_tot
