"""Port parity for the legacy dense-slot ``Engine`` (the reference's
``serve/engine.py`` and ``tests/test_serve.py``): one-shot B=1 prefill into
fresh caches copied into the slot, lock-step decode at one shared
position, per-slot meters, plain PyTorch versions on the CPU.

The acceptance gate: on ``falcon-mamba-7b_smoke`` (SSM), ``hymba-1.5b_smoke``
(hybrid), ``qwen3-0.6b_smoke`` and ``qwen2-vl-7b_smoke`` (M-RoPE), unquantized f32 and under
``attn.*=int8,ssm.*=int8,mlp.*=int2,*=bf16`` (a rule that names no GEMM of
an arch is dropped for it), with more requests than slots and a
``max_new=1`` request, the port's Engine gives the reference Engine's
greedy tokens and per-request ``cycles_by_bits``, identically, with the
reference's weights carried across by ``repro_torch.interop``. Temperature
> 0 draws come from the port's Philox streams (ROADMAP C7) and are held to
their properties instead."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig, get_config
from repro.models import init as j_init
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import get_config as t_get_config
from repro_torch.interop import flat_leaves, params_from_reference
from repro_torch.kernels import ops
from repro_torch.models import init, init_caches
from repro_torch.quant.capture import tree_totals_by_bits
from repro_torch.serve import Engine, Request, build_decode, build_prefill

torch.set_float32_matmul_precision("highest")
SSM, HYBRID, QWEN = "falcon-mamba-7b_smoke", "hymba-1.5b_smoke", "qwen3-0.6b_smoke"
QWEN2VL = "qwen2-vl-7b_smoke"     # M-RoPE: (3, B, S) positions t = h = w at prefill and decode
RC_KW = dict(dtype="float32", param_dtype="float32", remat="none")
MIXED = "attn.*=int8,ssm.*=int8,mlp.*=int2,*=bf16"
# MIXED with the rules that name no GEMM of the arch dropped
POLICIES = {SSM: "ssm.*=int8,*=bf16", HYBRID: MIXED, QWEN: "attn.*=int8,mlp.*=int2,*=bf16",
            QWEN2VL: "attn.*=int8,mlp.*=int2,*=bf16"}
BITS = {SSM: {8}, HYBRID: {8, 2}, QWEN: {8, 2}, QWEN2VL: {8, 2}}


def _weights(arch, rc_kw, seed=0):
    params = j_init(get_config(arch), RunConfig(**rc_kw), jax.random.PRNGKey(seed))
    return params, params_from_reference(jax.tree.map(np.asarray, params), device="cpu")


def _run(pkg, arch, rc_kw, params, reqs, *, capacity=32, max_batch=2, **kw):
    """``reqs``: [(prompt, max_new)]. Returns (engine, {rid: tokens})."""
    if pkg == "ref":
        eng = JEngine(get_config(arch), RunConfig(**rc_kw), params, capacity=capacity,
                      max_batch=max_batch, **kw)
        req = JRequest
    else:
        eng = Engine(t_get_config(arch), TRunConfig(**rc_kw), params, capacity=capacity,
                     max_batch=max_batch, device="cpu", **kw)
        req = Request
    for rid, (p, n) in enumerate(reqs):
        eng.submit(req(rid=rid, prompt=list(p), max_new=n))
    done = eng.run()
    return eng, {r.rid: list(r.out) for r in done}


def _requests(vocab):
    """Five requests on two slots: a 2-token prompt (shorter than
    ``ssm_conv - 1``), a ``max_new=1`` one, and lengths that move the shared
    position up."""
    rng = np.random.default_rng(1)
    lens, news = (5, 2, 7, 3, 5), (4, 1, 3, 5, 4)
    return [(rng.integers(0, vocab, n).tolist(), m) for n, m in zip(lens, news)]


@pytest.mark.parametrize("policy", ["f32", "mixed"])
@pytest.mark.parametrize("arch", [SSM, HYBRID, QWEN, QWEN2VL])
def test_engine_greedy_tokens_and_cycles_match_reference(arch, policy):
    rc_kw = dict(RC_KW, kv_cache_dtype="int8")
    if policy == "mixed":
        rc_kw["quant_policy"] = POLICIES[arch]
    params, tparams = _weights(arch, rc_kw)
    reqs = _requests(get_config(arch).vocab_size)
    je, jo = _run("ref", arch, rc_kw, params, reqs, track_energy=True)
    te, to = _run("port", arch, rc_kw, tparams, reqs, track_energy=True)
    assert to == jo
    assert te.pos == je.pos
    assert [len(to[r]) for r in range(5)] == [n for _, n in reqs]
    got = {e["rid"]: e["cycles_by_bits"] for e in te.energy_summary()}
    want = {e["rid"]: e["cycles_by_bits"] for e in je.energy_summary()}
    assert got == want
    if policy == "mixed":
        assert all(set(c) == BITS[arch] and min(c.values()) > 0 for c in got.values())
    # the pool after the run: KV codes, scales and SSM state as the reference's
    want_c = flat_leaves(jax.tree.map(np.asarray, je.caches))
    got_c = flat_leaves(te.caches)
    assert got_c.keys() == want_c.keys()
    for k, v in want_c.items():
        np.testing.assert_allclose(got_c[k], v, atol=1e-5, rtol=1e-5, err_msg=k)


def test_short_prompt_conv_state_is_the_reference_s():
    """A prompt shorter than ``ssm_conv - 1`` (3) tokens returns a conv
    state of its own length (2 rows). The Engine copies it into the first
    2 rows of the slot's conv window; the third keeps the previous
    occupant's row, exactly as the reference's ``dynamic_update_slice``
    leaves it, and the next decode step reads that stale row."""
    rc_kw = dict(RC_KW)
    params, tparams = _weights(SSM, rc_kw)
    rng = np.random.default_rng(2)
    first, short = rng.integers(0, 256, 6).tolist(), rng.integers(0, 256, 2).tolist()
    engines = []
    for pkg, p in (("ref", params), ("port", tparams)):
        eng, _ = _run(pkg, SSM, rc_kw, p, [(first, 2)], max_batch=1)
        stale = np.asarray(eng.caches[0]["k0"]["conv"])[:, 0, 2].copy()
        eng.submit((JRequest if pkg == "ref" else Request)(rid=1, prompt=short, max_new=3))
        eng._admit()
        conv = np.asarray(eng.caches[0]["k0"]["conv"])[:, 0]
        assert not np.array_equal(conv[:, 2], np.zeros_like(conv[:, 2]))
        np.testing.assert_array_equal(conv[:, 2], stale)      # the old occupant's row
        eng.run()
        engines.append((eng, conv, list(eng.finished_requests[-1].out)))
    (je, jconv, jout), (te, tconv, tout) = engines
    np.testing.assert_allclose(tconv, jconv, atol=1e-6, rtol=1e-5)
    assert tout == jout


def test_engine_continuous_batching():
    """More requests than slots: the queue drains, slots are reused, every
    request finishes with its tokens."""
    rc_kw = dict(RC_KW)
    _, tparams = _weights(QWEN, rc_kw, seed=1)
    eng, out = _run("port", QWEN, rc_kw, tparams,
                    [([1 + rid, 2, 3], 4) for rid in range(5)], capacity=64)
    assert not eng.queue
    assert sorted(out) == list(range(5)) and all(len(o) == 4 for o in out.values())
    assert all(r.done for r in eng.finished_requests)


def test_int8_kv_cache_close_to_fp():
    """int8 KV adds noise, but the prefill logits keep their ranking."""
    cfg = t_get_config(QWEN)
    rc = TRunConfig(**RC_KW)
    rc8 = dataclasses.replace(rc, kv_cache_dtype="int8")
    params = init(cfg, rc, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 12), generator=torch.Generator().manual_seed(3))

    def last_logits(r):
        caches = init_caches(cfg, r, 2, 13, device="cpu")
        return build_prefill(cfg, r)(params, caches, {"tokens": toks})[1]

    corr = np.corrcoef(last_logits(rc).numpy().ravel(), last_logits(rc8).numpy().ravel())[0, 1]
    assert corr > 0.98, corr


def test_quantized_decode_matches_fp32_within_dequant_tolerance():
    """Lock-step decode with int8 GEMMs tracks the f32 engine's logits, and
    the stats builders return one capture per step with cycles."""
    cfg = t_get_config(QWEN)
    rc = TRunConfig(**RC_KW)
    rc_q = dataclasses.replace(rc, quant_policy="*=int8")
    params = init(cfg, rc, torch.Generator().manual_seed(7), device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 6), generator=torch.Generator().manual_seed(8))

    def roll(r, with_stats):
        caches = init_caches(cfg, r, 2, 10, device="cpu")
        dec = build_decode(cfg, r, with_stats=with_stats)
        out = build_prefill(cfg, r, with_stats=with_stats)(params, caches, {"tokens": toks})
        caches, logits = out[0], out[1]
        steps, caps = [logits], []
        for i in range(3):
            nxt = torch.argmax(logits, -1).to(torch.int32)[:, None]
            out = dec(params, caches, nxt, 6 + i)
            caches, logits = out[0], out[1]
            if with_stats:
                caps.append(out[2])
            steps.append(logits)
        return steps, caps

    ref, _ = roll(rc, False)
    got, caps = roll(rc_q, True)
    for lf, lq in zip(ref, got):
        assert np.corrcoef(lf.numpy().ravel(), lq.numpy().ravel())[0, 1] > 0.98
    assert len(caps) == 3
    for cap in caps:
        (tot,) = tree_totals_by_bits(cap).values()
        assert tot["serial_cycles"] > tot["parallel_cycles"] > 0


def test_engine_per_slot_cycle_stats_monotone():
    """Per-slot meters: cycles strictly increase with every decode step,
    the prefill is charged at admission, finished requests keep theirs."""
    rc_kw = dict(RC_KW, quant_policy="*=int8")
    _, tparams = _weights(QWEN, rc_kw, seed=9)
    eng = Engine(t_get_config(QWEN), TRunConfig(**rc_kw), tparams, capacity=64, max_batch=2,
                 track_energy=True, device="cpu")
    for rid in range(3):
        eng.submit(Request(rid=rid, prompt=[1 + rid, 2, 3], max_new=4))
    hist: dict = {}
    for _ in range(40):
        if not eng.step() and not eng.queue:
            break
        for i, s in enumerate(eng.slots):
            m = eng.meters[i]
            if s is None or s.done or m is None or m.rid != s.rid:
                continue
            hist.setdefault(s.rid, []).append((m.decode_tokens, m.cycles_by_bits()))
    assert len(hist) == 3
    for h in hist.values():
        ser = [sum(c.values()) for _, c in h]
        assert [t for t, _ in h] == sorted(t for t, _ in h)
        assert all(b > a for a, b in zip(ser, ser[1:]))
        assert ser[0] > 0
    summary = eng.energy_summary()
    assert {e["rid"] for e in summary} == {0, 1, 2}
    assert all(e["energy_j"] > 0 and e["latency_s"] > 0 for e in summary)


def test_engine_meters_bucket_cycles_per_bits():
    """A mixed policy's cycles stay in their bitwidth buckets."""
    rc_kw = dict(RC_KW, quant_policy="attn.*=int8,mlp.*=int2,*=bf16")
    _, tparams = _weights(QWEN, rc_kw, seed=9)
    eng, _ = _run("port", QWEN, rc_kw, tparams, [([1 + rid, 2, 3], 3) for rid in range(2)],
                  capacity=64, track_energy=True)
    summary = eng.energy_summary()
    assert {e["rid"] for e in summary} == {0, 1}
    for e in summary:
        assert set(e["cycles_by_bits"]) == {8, 2}
        assert all(c > 0 for c in e["cycles_by_bits"].values())
        assert e["cycles"] == sum(e["cycles_by_bits"].values())
        assert e["energy_j"] > 0 and e["latency_s"] > 0


def test_max_new_one_generates_exactly_one_token():
    """The prefill-sampled token counts toward max_new: the request finishes
    at admission, charged no decode step."""
    rc_kw = dict(RC_KW, quant_policy="*=int8")
    _, tparams = _weights(QWEN, rc_kw, seed=5)
    eng, out = _run("port", QWEN, rc_kw, tparams, [([1, 2, 3], 1)], track_energy=True)
    assert out == {0: out[0]} and len(out[0]) == 1 and eng.finished_requests[0].done
    (m,) = eng.finished_meters
    assert m.decode_tokens == 0 and not m.decode_by_bits and m.prefill_by_bits


def test_decode_step_keeps_its_shapes():
    """Decode at two positions gives (B, V) logits and leaves every cache
    leaf's shape and dtype as it was."""
    cfg = t_get_config(HYBRID)
    rc = TRunConfig(**RC_KW)
    params = init(cfg, rc, device="cpu")
    caches = init_caches(cfg, rc, 2, 32, device="cpu")
    before = {k: (v.shape, v.dtype) for k, v in flat_leaves(caches).items()}
    dec = build_decode(cfg, rc)
    t = torch.ones((2, 1), dtype=torch.int32)
    caches, l1 = dec(params, caches, t, 0)
    caches, l2 = dec(params, caches, t, 1)
    assert l1.shape == l2.shape == (2, cfg.vocab_size)
    assert {k: (v.shape, v.dtype) for k, v in flat_leaves(caches).items()} == before


def test_reset_replays_the_same_run():
    rc_kw = dict(RC_KW)
    _, tparams = _weights(SSM, rc_kw)
    reqs = _requests(256)
    eng, first = _run("port", SSM, rc_kw, tparams, reqs)
    eng.reset()
    assert eng.pos == 0 and not eng.queue and eng.slots == [None, None]
    for rid, (p, n) in enumerate(reqs):
        eng.submit(Request(rid=rid, prompt=list(p), max_new=n))
    assert {r.rid: r.out for r in eng.run()} == first


def test_temperature_draws_are_reproducible():
    """At temperature > 0 each token comes from the request's Philox stream
    at its position: two runs agree, and they are not the greedy tokens."""
    rc_kw = dict(RC_KW)
    _, tparams = _weights(HYBRID, rc_kw)
    reqs = _requests(256)
    _, a = _run("port", HYBRID, rc_kw, tparams, reqs, temperature=0.9, seed=3)
    _, b = _run("port", HYBRID, rc_kw, tparams, reqs, temperature=0.9, seed=3)
    _, g = _run("port", HYBRID, rc_kw, tparams, reqs)
    assert a == b and a != g


@pytest.mark.parametrize("arch", [SSM, HYBRID])
def test_engine_runs_only_the_fused_gemm_and_its_stats(arch):
    """On the CPU every wrapper runs its plain version: a quantized Engine
    serve calls ``tugemm_fused`` and ``tugemm_stats`` (one a quantized
    GEMM) and no other wrapper — no ``flash_paged_decode`` on the dense
    layout — with every call site on the ``torch`` route."""
    rc_kw = dict(RC_KW, kv_cache_dtype="int8", quant_policy=POLICIES[arch])
    _, tparams = _weights(arch, rc_kw)
    ops.reset_counts()
    _run("port", arch, rc_kw, tparams, _requests(256), track_energy=True)
    counts = ops.kernel_counts()
    ran = {k for k, c in counts.items() if c["plain_calls"] or c["launches"]}
    assert ran == {"tugemm_fused", "tugemm_stats"}
    assert counts["tugemm_fused"]["plain_calls"] == counts["tugemm_stats"]["plain_calls"]
    assert {p for v in ops.path_counts().values() for p in v} == {"torch"}
