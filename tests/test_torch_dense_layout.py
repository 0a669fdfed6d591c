"""Port parity for the dense KV layout: ``blockwise_attention`` (both
branches), the dense ``kv_cache_write`` / ``kv_cache_read`` forms, the
dense mixed step, and the ``Scheduler`` on ``kv_layout="dense"`` (plain,
speculative, against the legacy Engine), held to the reference on the same
numpy inputs with the reference's weights carried across by
``repro_torch.interop``; plus the refusals the reference makes.

Tolerances, f32 on both sides: attention within ``1e-6`` abs + ``1e-5``
rel (the frameworks order the score and p·V sums differently); cache
writes byte for byte for f32 buffers and int8 codes, int8 scales within a
few ulps (ROADMAP C3: the reference's ``/127.0`` compiles to a reciprocal
multiply); greedy tokens and per-request ``cycles_by_bits`` exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig, get_config
from repro.models import KVView as JKVView
from repro.models import init as j_init
from repro.models import init_caches as j_init_caches
from repro.models.attention import init_kv_cache as j_init_kv_cache
from repro.models.attention import kv_cache_read as j_read
from repro.models.attention import kv_cache_write as j_write
from repro.models.flash import blockwise_attention as j_blockwise
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro.serve import Scheduler as JScheduler
from repro.serve.scheduler import build_mixed_step as j_build
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import get_config as t_get_config
from repro_torch.interop import caches_from_reference, params_from_reference, to_numpy
from repro_torch.models import KVView, init_caches
from repro_torch.models.attention import init_kv_cache, kv_cache_read, kv_cache_write
from repro_torch.models.flash import blockwise_attention
from repro_torch.serve import BlockManager, Engine, Request, Scheduler
from repro_torch.serve.scheduler import build_mixed_step

torch.set_float32_matmul_precision("highest")
QWEN, DS = "qwen3-0.6b_smoke", "deepseek-v2-lite-16b_smoke"
RC_KW = dict(dtype="float32", param_dtype="float32", remat="none", prefill_chunk=5,
             kv_cache_dtype="int8")
POLICY = {QWEN: "attn.*=int8,mlp.*=int2,*=bf16", DS: "mla.*=int8,*=int2"}
SCALE_RTOL = 1e-6     # ROADMAP C3


def _t(a, dtype=None):
    t = torch.from_numpy(np.asarray(a))
    return t if dtype is None else t.to(dtype)


# ------------------------------------------------------ blockwise_attention
ATTN_CASES = [
    # (name, Sq, Skv, H, KV, q_offset, kv_len, window, chunk, causal, softcap)
    ("decode_scalar", 1, 12, 4, 2, 7, 8, None, 1024, True, None),
    ("decode_rows_window", 1, 12, 4, 2, [3, 11, 0], [4, 12, 1], 3, 1024, True, None),
    ("direct_rows", 3, 12, 4, 1, [0, 5, 9], [3, 8, 12], None, 1024, True, None),
    ("scan_scalar", 9, 16, 4, 2, 4, 13, None, 5, True, None),
    ("scan_rows_window", 6, 16, 4, 2, [0, 7, 10], [6, 13, 16], 4, 4, True, None),
    ("scan_softcap", 5, 10, 2, 2, 2, 7, None, 3, True, 30.0),
    ("no_cache_causal", 7, 7, 4, 2, 0, None, None, 3, True, None),
    ("no_cache_window", 7, 7, 4, 4, 0, None, 2, 1024, True, None),
    ("no_cache_encoder", 6, 6, 2, 1, 0, None, None, 4, False, None),
]


@pytest.mark.parametrize("case", ATTN_CASES, ids=[c[0] for c in ATTN_CASES])
def test_blockwise_attention_matches_reference(case):
    """Both branches (``Sq <= 4`` direct, the chunk scan with a padded last
    chunk), scalar and per-row offsets and lengths, windows, GQA, softcap,
    and the no-cache forward."""
    _, Sq, Skv, H, KV, q_off, kv_len, window, chunk, causal, softcap = case
    B = len(q_off) if isinstance(q_off, list) else 2
    rng = np.random.default_rng(Sq * Skv + H)
    hd = 8
    q = rng.normal(size=(B, Sq, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, Skv, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, Skv, KV, hd)).astype(np.float32)
    kw = dict(causal=causal, window=window, chunk=chunk, softcap=softcap)
    jq = np.asarray(q_off, np.int32) if isinstance(q_off, list) else q_off
    jl = None if kv_len is None else np.asarray(kv_len, np.int32)
    want = j_blockwise(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       q_offset=jnp.asarray(jq) if isinstance(q_off, list) else jq,
                       kv_len=None if jl is None else jnp.asarray(jl), **kw)
    tq = _t(jq).int() if isinstance(q_off, list) else q_off
    tl = None if kv_len is None else (_t(jl).int() if isinstance(kv_len, list) else kv_len)
    got = blockwise_attention(_t(q), _t(k), _t(v), q_offset=tq, kv_len=tl, **kw)
    assert got.shape == (B, Sq, H, hd) and got.dtype == torch.float32
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=1e-6, rtol=1e-5)


def test_blockwise_attention_bf16_follows_the_storage_dtype():
    """bf16 operands: q rounded to bf16 before the direct branch's product,
    output in bf16, within a bf16 ulp of the reference."""
    rng = np.random.default_rng(0)
    q = rng.normal(size=(2, 1, 4, 8)).astype(np.float32)
    k = rng.normal(size=(2, 9, 2, 8)).astype(np.float32)
    v = rng.normal(size=(2, 9, 2, 8)).astype(np.float32)
    want = j_blockwise(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
                       jnp.asarray(v, jnp.bfloat16), q_offset=5, kv_len=6)
    got = blockwise_attention(_t(q, torch.bfloat16), _t(k, torch.bfloat16),
                              _t(v, torch.bfloat16), q_offset=5, kv_len=6)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(to_numpy(got), np.asarray(want, np.float32), atol=2 ** -7,
                               rtol=2 ** -7)


# ------------------------------------------------------------- dense cache
def _caches(kv_dtype, B, cap, seed):
    """The same dense k/v cache in both packages, pre-filled with a previous
    occupant's tokens (so dropped writes must leave them as they were)."""
    cfg = get_config(QWEN)
    old = np.random.default_rng(seed).normal(
        size=(B, cap, cfg.num_kv_heads, cfg.resolved_head_dim)).astype(np.float32)
    jc = j_init_kv_cache(cfg, B, cap, kv_dtype)
    jc = j_write(jc, ("k", "v"), (jnp.asarray(old), jnp.asarray(-old)), 0)
    tc = caches_from_reference(jax.tree.map(np.asarray, jc), device="cpu")
    return cfg, jc, tc


def _same_cache(got, want):
    for n, w in want.items():
        w = np.asarray(w)
        g = got[n].numpy()
        if n.endswith("_scale"):
            np.testing.assert_allclose(g, w, rtol=SCALE_RTOL, atol=0, err_msg=n)
        else:
            np.testing.assert_array_equal(g, w, err_msg=n)


@pytest.mark.parametrize("kv_dtype", [jnp.float32, jnp.int8], ids=["f32", "int8"])
@pytest.mark.parametrize("pos,S", [(0, 5), (3, 4), (6, 4), (8, 3)])
def test_scalar_position_write_clamps_like_dynamic_update_slice(kv_dtype, pos, S):
    """The legacy lock-step write: every row at ``pos``, the start clamped
    to ``capacity - S`` (pos 6 and 8 with capacity 8), then the masked read."""
    cfg, jc, tc = _caches(kv_dtype, 2, 8, 1)
    new = np.random.default_rng(2).normal(
        size=(2, S, cfg.num_kv_heads, cfg.resolved_head_dim)).astype(np.float32)
    jc = j_write(jc, ("k", "v"), (jnp.asarray(new), jnp.asarray(2 * new)), pos)
    kv_cache_write(tc, ("k", "v"), (_t(new), _t(2 * new)), pos)
    _same_cache(tc, jc)
    kv_len = min(pos + S, 8)
    for n in ("k", "v"):
        np.testing.assert_allclose(
            to_numpy(kv_cache_read(tc, n, torch.float32, kv_len=kv_len)),
            np.asarray(j_read(jc, n, jnp.float32, kv_len=kv_len)), rtol=SCALE_RTOL, atol=0)


@pytest.mark.parametrize("kv_dtype", [jnp.float32, jnp.int8], ids=["f32", "int8"])
@pytest.mark.parametrize("pos,lens", [
    ([0, 6, 3], [4, 4, 0]),        # row 1 runs past the capacity, row 2 idle
    ([5, 0, 2], [3, 1, 2]),        # row 0's live write ends on capacity - 1
    ([7, 4, 8], [1, 4, 0]),        # decode on the last position; an idle row at cap
])
def test_per_row_dense_write_drops_padding_and_overflow(kv_dtype, pos, lens):
    """The Scheduler's dense write: each row's ``lens[b]`` tokens at its own
    ``pos[b]``; padded columns and columns past the capacity are dropped
    (the reference's ``mode="drop"``), the previous occupant's tokens
    elsewhere untouched, a live write on ``capacity - 1`` kept."""
    B, W, cap = 3, 4, 8
    cfg, jc, tc = _caches(kv_dtype, B, cap, 3)
    new = np.random.default_rng(4).normal(
        size=(B, W, cfg.num_kv_heads, cfg.resolved_head_dim)).astype(np.float32)
    p, l = np.asarray(pos, np.int32), np.asarray(lens, np.int32)
    jview = JKVView(pos=jnp.asarray(p), lens=jnp.asarray(l), tables=None, block_size=4,
                    layout="dense")
    jc = j_write(jc, ("k", "v"), (jnp.asarray(new), jnp.asarray(-new)), None, view=jview)
    view = KVView(pos=_t(p), lens=_t(l), tables=None, block_size=4, layout="dense")
    kv_cache_write(tc, ("k", "v"), (_t(new), _t(-new)), view=view)
    _same_cache(tc, jc)
    kv_len = np.minimum(p + l, cap)
    np.testing.assert_allclose(
        to_numpy(kv_cache_read(tc, "k", torch.float32, kv_len=_t(kv_len))),
        np.asarray(j_read(jc, "k", jnp.float32, kv_len=jnp.asarray(kv_len))),
        rtol=SCALE_RTOL, atol=0)


def test_dense_int8_read_masks_stale_tail():
    """Slot reuse: positions at or beyond kv_len dequantize to exact zeros
    even when the buffer still holds a previous occupant's tokens."""
    cfg = t_get_config(QWEN)
    cache = init_kv_cache(cfg, 2, 8, torch.int8, "cpu")
    full = _t(np.random.default_rng(0).normal(
        size=(2, 8, cfg.num_kv_heads, cfg.resolved_head_dim)).astype(np.float32))
    kv_cache_write(cache, ("k",), (full,), 0)                # old occupant: 8 tokens
    out = kv_cache_read(cache, "k", torch.float32, kv_len=_t(np.array([3, 5], np.int32)))
    assert out[0, :3].abs().sum() > 0
    assert (out[0, 3:] == 0).all() and (out[1, 5:] == 0).all()
    assert (out[0, 3:].view(torch.int32) == 0).all()         # +0.0, not -0.0


def test_paged_write_read_matches_dense():
    """Tokens scattered through a block table read back identical to the
    dense layout at every live position (int8: the same per-token scales)."""
    cfg = t_get_config(QWEN)
    capacity, bs, B = 12, 4, 2
    kv = _t(np.random.default_rng(7).normal(
        size=(B, 6, cfg.num_kv_heads, cfg.resolved_head_dim)).astype(np.float32))
    pos, lens = _t(np.array([0, 2], np.int32)), _t(np.array([6, 3], np.int32))
    dense = init_kv_cache(cfg, B, capacity, torch.int8, "cpu")
    kv_cache_write(dense, ("k",), (kv,), view=KVView(pos, lens, None, bs, "dense"))
    out_d = kv_cache_read(dense, "k", torch.float32, kv_len=pos + lens)
    mgr = BlockManager(B * capacity // bs, bs, B, capacity)
    assert mgr.extend(0, 6) and mgr.extend(1, 5)
    pool = init_kv_cache(cfg, mgr.num_pages + 1, bs, torch.int8, "cpu")
    view_p = KVView(pos, lens, _t(mgr.tables.copy()), bs, "paged")
    kv_cache_write(pool, ("k",), (kv,), view=view_p)
    out_p = kv_cache_read(pool, "k", torch.float32, view=view_p)
    assert torch.equal(out_d, out_p[:, :capacity])


# ------------------------------------------------------------ mixed steps
@pytest.mark.parametrize("arch", [QWEN, DS])
def test_dense_mixed_step_matches_reference_and_paged(arch):
    """One mixed step over dense rows (a prefill chunk, a decode row, an
    idle row) after a warm-up step: the reference's logits and caches, and
    the port's own paged step's logits (which attend through the paged
    kernel's plain version: another float order, so within 1e-5, not bit
    for bit as the reference's two layouts are)."""
    cfg, tcfg = get_config(arch), t_get_config(arch)
    rc, trc = RunConfig(**RC_KW), TRunConfig(**RC_KW)
    params = j_init(cfg, rc, jax.random.PRNGKey(2))
    tparams = params_from_reference(jax.tree.map(np.asarray, params), device="cpu")
    cap, bs = 16, 4
    rng = np.random.default_rng(0)
    warm = rng.integers(0, cfg.vocab_size, (3, 7)).astype(np.int32)
    tokens = rng.integers(0, cfg.vocab_size, (3, 5)).astype(np.int32)
    pos, lens = np.array([3, 7, 0], np.int32), np.array([5, 1, 0], np.int32)
    wl = np.array([3, 7, 0], np.int32)
    zero = np.zeros(3, np.int32)

    step_j = j_build(cfg, rc)
    jc = j_init_caches(cfg, rc, 3, cap)
    jc, _ = step_j(params, jc, jnp.asarray(warm), jnp.asarray(zero), jnp.asarray(wl), None)
    jc, want = step_j(params, jc, jnp.asarray(tokens), jnp.asarray(pos), jnp.asarray(lens), None)

    step_t = build_mixed_step(tcfg, trc)
    tc = init_caches(tcfg, trc, 3, cap, device="cpu")
    tc, _ = step_t(tparams, tc, _t(warm), _t(zero), _t(wl), None)
    tc, got = step_t(tparams, tc, _t(tokens), _t(pos), _t(lens), None)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=1e-5, rtol=1e-5)

    trc_p = dataclasses.replace(trc, kv_layout="paged", block_size=bs)
    mgr = BlockManager(3 * cap // bs, bs, 3, cap)
    assert mgr.extend(0, 8) and mgr.extend(1, 8)
    tables = _t(mgr.tables.copy())
    step_p = build_mixed_step(tcfg, trc_p)
    tp = init_caches(tcfg, trc_p, 3, cap, device="cpu")
    tp, _ = step_p(tparams, tp, _t(warm), _t(zero), _t(wl), tables)
    tp, got_p = step_p(tparams, tp, _t(tokens), _t(pos), _t(lens), tables)
    live = lens > 0
    np.testing.assert_allclose(to_numpy(got_p)[live], to_numpy(got)[live], atol=1e-5,
                               rtol=1e-5)


# -------------------------------------------------------------- scheduler
def _serve(pkg, arch, params, prompts, *, max_new=4, max_batch=3, capacity=32, rc_kw=None,
           **kw):
    rc = (RunConfig if pkg == "ref" else TRunConfig)(**dict(RC_KW, **(rc_kw or {})))
    cfg = (get_config if pkg == "ref" else t_get_config)(arch)
    extra = {} if pkg == "ref" else {"device": "cpu"}
    s = (JScheduler if pkg == "ref" else Scheduler)(
        cfg, rc, params, capacity=capacity, max_batch=max_batch, **kw, **extra)
    req = JRequest if pkg == "ref" else Request
    for rid, p in enumerate(prompts):
        s.submit(req(rid=rid, prompt=list(p), max_new=max_new))
    s.run()
    return s, {r.rid: list(r.out) for r in s.finished}


def _weights(arch, seed=0):
    params = j_init(get_config(arch), RunConfig(**RC_KW), jax.random.PRNGKey(seed))
    return params, params_from_reference(jax.tree.map(np.asarray, params), device="cpu")


def _prompts(vocab, n, seed=1, step=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, 4 + step * i).tolist() for i in range(n)]


@pytest.mark.parametrize("arch", [QWEN, DS])
def test_dense_scheduler_matches_reference(arch):
    """The paged-pool Scheduler on the dense layout: more requests than
    slots, prompts over several chunks, the mixed int8/int2 policy: greedy
    tokens, KV lengths, ticks and per-request ``cycles_by_bits``
    identical to the reference's dense Scheduler."""
    params, tparams = _weights(arch)
    prompts = _prompts(get_config(arch).vocab_size, 5)
    kw = dict(rc_kw={"quant_policy": POLICY[arch]}, track_energy=True)
    js, jo = _serve("ref", arch, params, prompts, **kw)
    ts, to = _serve("port", arch, tparams, prompts, **kw)
    assert ts.mgr is None
    assert to == jo
    assert ts.final_kv_lens == js.final_kv_lens and ts.ticks == js.ticks
    cyc = {e["rid"]: e["cycles_by_bits"] for e in ts.energy_summary()}
    assert cyc == {e["rid"]: e["cycles_by_bits"] for e in js.energy_summary()}
    assert all(set(c) == {8, 2} and min(c.values()) > 0 for c in cyc.values())
    assert ts.cycles_by_bits == js.cycles_by_bits


def test_dense_scheduler_health_and_cache_stats():
    """``health()["pool"]`` and ``cache_stats()`` report the dense layout
    and its reservation as the reference's do."""
    params, tparams = _weights(QWEN)
    prompts = _prompts(256, 3)
    js, _ = _serve("ref", QWEN, params, prompts)
    ts, _ = _serve("port", QWEN, tparams, prompts)
    assert ts.cache_stats() == js.cache_stats()
    assert ts.cache_stats()["layout"] == "dense"
    assert ts.cache_stats()["reserved_tokens"] == 3 * 32
    th, jh = ts.health(), js.health()
    assert th["pool"] == jh["pool"] == {"layout": "dense"}
    assert th["prefix_cache"] == jh["prefix_cache"]


def test_scheduler_matches_legacy_engine_greedy():
    """Same-length prompts admitted together: the dense Scheduler's greedy
    output equals the legacy Engine's, in the port and in the reference
    (the shared-position counter is only right in this regime)."""
    rc_kw = {"prefill_chunk": 8}
    params, tparams = _weights(QWEN, seed=4)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, 6).tolist() for _ in range(3)]
    rc = TRunConfig(**dict(RC_KW, **rc_kw))
    eng = Engine(t_get_config(QWEN), rc, tparams, capacity=32, max_batch=3, device="cpu")
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=list(p), max_new=5))
    eng.run()
    out_legacy = {r.rid: r.out for r in eng.slots if r is not None}
    _, out_sched = _serve("port", QWEN, tparams, prompts, max_new=5, rc_kw=rc_kw)
    _, out_ref = _serve("ref", QWEN, params, prompts, max_new=5, rc_kw=rc_kw)
    assert out_sched == out_legacy == out_ref


def test_spec_greedy_matches_nonspec_dense_layout():
    """The dense layout speculates too (rollback is length bookkeeping:
    length-masked reads hide the rolled-back tail): the speculative tokens
    equal the plain run's, and drafted / accepted counts, KV lengths and
    tokens equal the reference's."""
    rc_kw = {"quant_policy": "attn.*=int8,*=int2", "prefill_chunk": 3}
    params, tparams = _weights(QWEN)
    prompts = _prompts(256, 3, step=3)
    _, out_ns = _serve("port", QWEN, tparams, prompts, max_new=6, rc_kw=rc_kw)
    spec_kw = dict(rc_kw, spec_gamma=2)
    ts, out_sp = _serve("port", QWEN, tparams, prompts, max_new=6, rc_kw=spec_kw)
    js, out_ref = _serve("ref", QWEN, params, prompts, max_new=6, rc_kw=spec_kw)
    assert out_sp == out_ns == out_ref
    assert ts.drafted_tokens > 0
    assert (ts.drafted_tokens, ts.accepted_draft_tokens) == (js.drafted_tokens,
                                                             js.accepted_draft_tokens)
    assert ts.final_kv_lens == js.final_kv_lens


# --------------------------------------------------------------- refusals
def _message(fn):
    with pytest.raises(Exception) as e:
        fn()
    return type(e.value), str(e.value)


def test_refusals_match_reference():
    """The legacy Engine refuses the paged layout and speculative decoding,
    the Scheduler refuses SSM and hybrid stacks, and prefix caching on the
    dense layout is refused: the reference's exception types and texts."""
    cfgs = {a: (get_config(a), t_get_config(a)) for a in
            (QWEN, "falcon-mamba-7b_smoke", "hymba-1.5b_smoke")}
    cases = [
        (QWEN, dict(kv_layout="paged", block_size=4), "engine"),
        (QWEN, dict(spec_gamma=2), "engine"),
        ("falcon-mamba-7b_smoke", {}, "scheduler"),
        ("hymba-1.5b_smoke", {}, "scheduler"),
        (QWEN, dict(prefix_cache=True), "scheduler"),
    ]
    for arch, kw, what in cases:
        jcfg, tcfg = cfgs[arch]
        rc, trc = RunConfig(**dict(RC_KW, **kw)), TRunConfig(**dict(RC_KW, **kw))
        if what == "engine":
            want = _message(lambda: JEngine(jcfg, rc, params={}, capacity=16, max_batch=1))
            got = _message(lambda: Engine(tcfg, trc, params={}, capacity=16, max_batch=1,
                                          device="cpu"))
        else:
            want = _message(lambda: JScheduler(jcfg, rc, {}, capacity=16, max_batch=1))
            got = _message(lambda: Scheduler(tcfg, trc, {}, capacity=16, max_batch=1,
                                             device="cpu"))
        assert got[0].__name__ == want[0].__name__ and got[1] == want[1], (arch, kw)
