"""Port parity for speculative decoding (the reference's
``tests/test_spec.py``): the port's ``SpecDecoder`` and speculative
``Scheduler`` ticks, plain PyTorch versions on the CPU.

Greedy runs are held to the reference exactly: the same requests, weights
(carried across by ``repro_torch.interop``) and RunConfig through both
schedulers give the same tokens, final KV lengths, drafted and accepted
counts, ticks, ``health()`` and per-request ``cycles_by_bits`` in the
target and the draft buckets — and the speculative tokens equal the
non-speculative run's. Temperature > 0 cannot match the reference draw for
draw (the port's draws are Philox streams keyed on (seed, rid, position,
stream), the reference's ``jax.random.fold_in``), so rejection sampling is
held to the reference's properties in the port's own streams:
determinism, schedule invariance, identical distributions accept
everything, an impossible proposal is rejected, and with no drafts the
result is the plain STREAM_SAMPLE draw."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig, get_config
from repro.core.report import spec_energy_summary as j_spec_energy_summary
from repro.models import init as j_init
from repro.serve import Request as JRequest
from repro.serve import Scheduler as JScheduler
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import get_config as t_get_config
from repro_torch.interop import params_from_reference
from repro_torch.models import init as t_init
from repro_torch.serve import Request, Scheduler, greedy_accept, rejection_accept
from repro_torch.serve.scheduler import STREAM_SAMPLE, sample

torch.set_float32_matmul_precision("highest")
RC_KW = dict(dtype="float32", param_dtype="float32", remat="none", prefill_chunk=3,
             kv_cache_dtype="int8")
PAGED = dict(kv_layout="paged", block_size=4)
QWEN = "qwen3-0.6b_smoke"
PER_TOKEN = "attn.*=int8:per_token,mlp.*=int2:per_token,*=bf16"


def _prompts(vocab, n=4, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, 4 + 3 * i).tolist() for i in range(n)]


def _serve(pkg, arch, rc_kw, params, prompts, *, max_new=6, max_batch=3, capacity=32, **kw):
    rc = (RunConfig if pkg == "ref" else TRunConfig)(**dict(RC_KW, **rc_kw))
    cfg = (get_config if pkg == "ref" else t_get_config)(arch)
    extra = {} if pkg == "ref" else {"device": "cpu"}
    s = (JScheduler if pkg == "ref" else Scheduler)(
        cfg, rc, params, capacity=capacity, max_batch=max_batch, **kw, **extra)
    req = JRequest if pkg == "ref" else Request
    for rid, p in enumerate(prompts):
        s.submit(req(rid=rid, prompt=list(p), max_new=max_new))
    s.run()
    return s, {r.rid: list(r.out) for r in s.finished}


def _weights(arch, rc_kw):
    cfg = get_config(arch)
    params = j_init(cfg, RunConfig(**dict(RC_KW, **rc_kw)), jax.random.PRNGKey(0))
    return params, params_from_reference(jax.tree.map(np.asarray, params), device="cpu")


def _energy(s):
    return {e["rid"]: (e["cycles_by_bits"], e.get("draft_cycles_by_bits"))
            for e in s.energy_summary()}


def _agree(ref, port):
    """Every decision and meter of the two schedulers."""
    (js, jo), (ts, to) = ref, port
    assert to == jo
    assert ts.final_kv_lens == js.final_kv_lens
    for k in ("drafted_tokens", "accepted_draft_tokens", "ticks", "draft_stale_events",
              "draft_resyncs", "preemptions"):
        assert getattr(ts, k) == getattr(js, k), k
    h = lambda s: {k: v for k, v in s.health().items() if k not in ("kernels", "latency")}
    assert h(ts) == h(js)
    assert ts.cache_stats() == js.cache_stats()
    if ts.track_energy:
        assert _energy(ts) == _energy(js)


# ----------------------------------------------------------- greedy conformance
@pytest.mark.parametrize("arch,policy", [
    (QWEN, "attn.*=int8,*=int2"),
    # per-token scales make verify ≡ decode structurally on deepseek's small
    # logit gaps (the reference's own parametrization)
    ("deepseek-v2-lite-16b_smoke", "mla.*=int8:per_token,*=int2:per_token"),
])
def test_spec_greedy_matches_nonspec_and_reference(arch, policy):
    """Greedy spec decode == greedy plain decode, token for token and in
    final KV lengths, with every page back in the pool; and the port's spec
    run makes the reference's decisions: drafted and accepted counts, ticks,
    and each request's target and draft ``cycles_by_bits``."""
    rc_kw = dict(PAGED, quant_policy=policy)
    params, tparams = _weights(arch, rc_kw)
    prompts = _prompts(get_config(arch).vocab_size)
    spec_kw = dict(rc_kw, spec_gamma=2)
    ref = _serve("ref", arch, spec_kw, params, prompts, track_energy=True)
    port = _serve("port", arch, spec_kw, tparams, prompts, track_energy=True)
    _agree(ref, port)
    s_ns, out_ns = _serve("port", arch, rc_kw, tparams, prompts)
    s_sp, out_sp = port
    assert out_sp == out_ns
    assert s_sp.final_kv_lens == s_ns.final_kv_lens
    assert s_sp.drafted_tokens > 0
    assert 0 <= s_sp.accepted_draft_tokens <= s_sp.drafted_tokens
    s_sp.mgr.check_invariants()
    assert s_sp.mgr.pages_in_use == 0
    assert s_sp.ticks <= s_ns.ticks
    assert all(set(d) == {2} for _, d in _energy(s_sp).values())


def test_spec_max_new_one_never_drafts():
    rc_kw = dict(PAGED, spec_gamma=2)
    cfg = t_get_config(QWEN)
    rc = TRunConfig(**dict(RC_KW, **rc_kw))
    params = t_init(cfg, rc, torch.Generator().manual_seed(5), device="cpu")
    s, out = _serve("port", QWEN, rc_kw, params, [[1, 2, 3]], max_new=1)
    assert len(out[0]) == 1
    assert s.drafted_tokens == 0


def test_verify_columns_equal_decode_steps():
    """The verify step's column j gives the logits a decode step gives at
    the same position (per-token scales, an unquantized head run column by
    column): greedy spec decoding then emits exactly the plain tokens."""
    from repro_torch.models import init_caches
    from repro_torch.serve import build_mixed_step
    from repro_torch.serve.cache import BlockManager

    cfg = t_get_config(QWEN)
    rc = TRunConfig(**dict(RC_KW, **PAGED, quant_policy=PER_TOKEN))
    params = t_init(cfg, rc, torch.Generator().manual_seed(3), device="cpu")
    B, cap, n = 2, 32, 7
    toks = torch.randint(0, cfg.vocab_size, (B, n + 3), generator=torch.Generator().manual_seed(4),
                         dtype=torch.int32)
    outs = []
    for verify in (False, True):
        mgr = BlockManager(B * cap // 4, 4, B, cap)
        for b in range(B):
            mgr.extend(b, n + 3)
        tables = torch.from_numpy(mgr.tables.copy())
        caches = init_caches(cfg, rc, B, cap, num_pages=mgr.num_pages, device="cpu")
        step = build_mixed_step(cfg, rc)
        pos = torch.zeros(B, dtype=torch.int32)
        caches, _ = step(params, caches, toks[:, :n], pos, torch.full((B,), n, dtype=torch.int32),
                         tables)
        if verify:
            vstep = build_mixed_step(cfg, rc, all_logits=True)
            _, lg = vstep(params, caches, toks[:, n:], pos + n, torch.full((B,), 3,
                                                                            dtype=torch.int32),
                          tables)
            outs.append(lg)
        else:
            cols = []
            for j in range(3):
                caches, lg = step(params, caches, toks[:, n + j:n + j + 1], pos + n + j,
                                  torch.ones(B, dtype=torch.int32), tables)
                cols.append(lg)
            outs.append(torch.stack(cols, dim=1))
    assert outs[1].shape == (B, 3, cfg.vocab_size)
    assert torch.equal(outs[0].argmax(-1), outs[1].argmax(-1))
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=1e-5)


# --------------------------------------------------------------- temperature>0
def test_spec_rejection_sampling_deterministic_and_schedule_invariant():
    """Temperature > 0 spec runs are reproducible end to end (draft draws,
    acceptance uniforms, residual draws and bonus samples all come from
    (seed, rid, position, stream) streams) and, under per-token scales, do
    not depend on how many rows share a tick; another seed draws other
    tokens. (The draft runs per-token scales too: under the default
    per-tensor ``*=int2`` its proposals depend on the co-batched rows.)"""
    rc_kw = dict(PAGED, quant_policy=PER_TOKEN, spec_gamma=2, draft_policy="*=int2:per_token")
    cfg = t_get_config(QWEN)
    params = t_init(cfg, TRunConfig(**dict(RC_KW, **rc_kw)), torch.Generator().manual_seed(0),
                    device="cpu")
    prompts = _prompts(cfg.vocab_size, n=3)
    kw = dict(temperature=0.8, seed=5)
    s1, o1 = _serve("port", QWEN, rc_kw, params, prompts, **kw)
    s2, o2 = _serve("port", QWEN, rc_kw, params, prompts, **kw)
    _, narrow = _serve("port", QWEN, rc_kw, params, prompts, max_batch=1, **kw)
    _, other = _serve("port", QWEN, rc_kw, params, prompts, temperature=0.8, seed=6)
    assert o1 == o2 == narrow
    assert other != o1
    assert (s1.drafted_tokens, s1.accepted_draft_tokens) == (
        s2.drafted_tokens, s2.accepted_draft_tokens)
    assert 0 <= s1.accepted_draft_tokens <= s1.drafted_tokens and s1.drafted_tokens > 0
    s1.mgr.check_invariants()
    assert s1.mgr.pages_in_use == 0


def test_greedy_accept_rule():
    am = np.asarray([7, 8, 9, 3])
    assert greedy_accept([], am) == (0, [7])
    assert greedy_accept([7, 8], am) == (2, [7, 8, 9])
    assert greedy_accept([7, 5], am) == (1, [7, 8])
    assert greedy_accept([4, 8], am) == (0, [7])


def test_rejection_accept_matches_plain_sampling_when_no_drafts():
    logits = np.asarray(np.random.default_rng(0).normal(size=(1, 64)), np.float32)
    n, emitted = rejection_accept(3, rid=5, pos0=9, props=[], p_logits=logits,
                                  q_logits=logits[:0], temperature=0.7)
    assert n == 0 and len(emitted) == 1
    want = sample(logits, 0.7, seed=3, rids=[5], positions=[10], stream=STREAM_SAMPLE)[0]
    assert emitted[0] == want


def test_rejection_accept_identical_dists_accepts_everything():
    rng = np.random.default_rng(1)
    p = np.asarray(rng.normal(size=(3, 32)), np.float32)
    props = [int(np.argmax(p[0])), int(np.argmax(p[1]))]
    for seed in range(5):
        n, emitted = rejection_accept(seed, rid=1, pos0=4, props=props, p_logits=p,
                                      q_logits=p[:2], temperature=1.0)
        assert n == 2
        assert emitted[:2] == props and len(emitted) == 3


def test_rejection_accept_impossible_proposal_rejected():
    V = 16
    p = np.full((1, V), -40.0, np.float32)
    p[0, 3] = 10.0                        # target: all mass on 3
    q = np.full((1, V), -40.0, np.float32)
    q[0, 7] = 10.0                        # the draft proposed 7
    for seed in range(5):
        n, emitted = rejection_accept(seed, rid=0, pos0=0, props=[7], p_logits=p,
                                      q_logits=q, temperature=1.0)
        assert n == 0 and emitted == [3]


# ------------------------------------------------------------------- energy
def test_spec_energy_split_by_policy_bits():
    """Draft cycles land in the draft bucket at the draft policy's width
    (int2 only), verify and prefill cycles at the target policy's (int8 and
    int2); the rollup gives the reference's numbers on the same run."""
    rc_kw = dict(PAGED, quant_policy="attn.*=int8,*=int2", spec_gamma=2,
                 draft_policy="*=int2")
    params, tparams = _weights(QWEN, rc_kw)
    prompts = _prompts(get_config(QWEN).vocab_size, n=3)
    ref = _serve("ref", QWEN, rc_kw, params, prompts, track_energy=True)
    port = _serve("port", QWEN, rc_kw, tparams, prompts, track_energy=True)
    _agree(ref, port)
    s, out = port
    assert all(len(v) == 6 for v in out.values())
    for e in s.energy_summary():
        assert set(e["draft_cycles_by_bits"]) == {2}
        assert e["draft_cycles_by_bits"][2] > 0
        assert {2, 8} <= set(e["cycles_by_bits"])
        assert 0.0 < e["draft_energy_j"] < e["energy_j"]
        assert e["target_energy_j"] + e["draft_energy_j"] == pytest.approx(e["energy_j"])
        assert s.finished_meters and e["draft_cycles_by_bits"] == next(
            m for m in s.finished_meters if m.rid == e["rid"]).cycles_by_bits(bucket="draft")
    roll = s.spec_summary()
    want = ref[0].spec_summary()
    assert roll == pytest.approx(want, rel=1e-12)
    assert roll == pytest.approx(j_spec_energy_summary(ref[0].energy_summary()) | {
        k: want[k] for k in ("spec_gamma", "draft_policy", "ticks", "drafted_tokens",
                             "accepted_draft_tokens", "acceptance_rate")}, rel=1e-12)
    assert roll["drafted_tokens"] == s.drafted_tokens > 0
    assert roll["energy_per_accepted_token_j"] > 0
    assert roll["draft_policy"] == "*=int2"


# --------------------------------------------------------- pressure and faults
def test_spec_preemption_under_pool_pressure():
    """A pool far smaller than the worst case drains every request with
    speculation on (γ degrades, recompute preemption rebuilds both pools),
    leak-free, with the reference's decisions."""
    rc_kw = dict(PAGED, quant_policy="attn.*=int8,*=int2", prefill_chunk=4, spec_gamma=2)
    params, tparams = _weights(QWEN, rc_kw)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, get_config(QWEN).vocab_size, 10).tolist() for _ in range(5)]
    kw = dict(max_new=8, num_pages=10)
    ref = _serve("ref", QWEN, rc_kw, params, prompts, **kw)
    port = _serve("port", QWEN, rc_kw, tparams, prompts, **kw)
    _agree(ref, port)
    s, out = port
    s.mgr.check_invariants()
    assert sorted(out) == list(range(5)) and all(len(v) == 8 for v in out.values())
    assert s.preemptions > 0
    assert s.mgr.high_water <= 10 and s.mgr.pages_in_use == 0


def test_spec_draft_stale_falls_back_and_resyncs():
    """Induced draft-pool staleness degrades, never breaks: a stale row
    plain-decodes, the scheduler re-ingests the missing span on the next
    healthy tick, greedy output equals the fault-free spec run, no page
    leaks — and the reference decides the same under the same plan."""
    import repro.serve.faults as j_faults
    from repro_torch.serve.faults import FaultEvent, FaultPlan

    rc_kw = dict(PAGED, spec_gamma=2, draft_policy="*=int2")
    params, tparams = _weights(QWEN, rc_kw)
    prompts = _prompts(get_config(QWEN).vocab_size, n=3)
    s0, clean = _serve("port", QWEN, rc_kw, tparams, prompts, max_new=8)
    ticks = range(2, 2 + 2 * s0.ticks, 2)
    plan = FaultPlan([FaultEvent(t, "draft_stale", slot) for t in ticks for slot in range(3)])
    jplan = j_faults.FaultPlan([j_faults.FaultEvent(t, "draft_stale", slot)
                                for t in ticks for slot in range(3)])
    ref = _serve("ref", QWEN, rc_kw, params, prompts, max_new=8, faults=jplan)
    port = _serve("port", QWEN, rc_kw, tparams, prompts, max_new=8, faults=plan)
    _agree(ref, port)
    s, out = port
    assert out == clean
    assert s.ticks >= s0.ticks
    assert s.draft_stale_events > 0 and s.draft_resyncs > 0 and s.drafted_tokens > 0
    s.mgr.check_invariants()
    assert s.mgr.pages_in_use == 0
    assert s.health()["nan_events"] == 0


def test_spec_nan_quarantine_marks_draft_stale():
    """A NaN on a verify row rolls the row back in both pools (truncate),
    marks its draft stale, retries clean next tick and resyncs: the tokens
    equal the fault-free run's, as in the reference."""
    import repro.serve.faults as j_faults
    from repro_torch.serve.faults import FaultEvent, FaultPlan

    rc_kw = dict(PAGED, quant_policy=PER_TOKEN, spec_gamma=2)
    params, tparams = _weights(QWEN, rc_kw)
    prompts = _prompts(get_config(QWEN).vocab_size, n=3)
    _, clean = _serve("port", QWEN, rc_kw, tparams, prompts, max_new=8)
    events = [(5, 0), (9, 1)]
    ref = _serve("ref", QWEN, rc_kw, params, prompts, max_new=8, faults=j_faults.FaultPlan(
        [j_faults.FaultEvent(t, "nan_logits", r) for t, r in events]))
    port = _serve("port", QWEN, rc_kw, tparams, prompts, max_new=8, faults=FaultPlan(
        [FaultEvent(t, "nan_logits", r) for t, r in events]))
    _agree(ref, port)
    s, out = port
    assert out == clean
    assert s.nan_events >= 1 and s.draft_stale_events >= 1 and s.fallback_retries == 0
    assert s.mgr.pages_in_use == 0


def test_draft_view_rejects_packed_base_tree():
    """The draft view needs float params: a tree the target policy already
    packed would pin target bitwidths under the draft policy. The float tree
    works and packs a second int2 view; a dynamic draft reuses it as is."""
    from repro_torch.quant import apply_surgery
    from repro_torch.quant.policy import PolicyError
    from repro_torch.quant.surgery import draft_quant_view

    cfg = t_get_config(QWEN)
    rc = TRunConfig(**dict(RC_KW, **PAGED, quant_policy="*=int8:prequant", spec_gamma=2))
    params = t_init(cfg, rc, torch.Generator().manual_seed(0), device="cpu")
    packed = apply_surgery(cfg, rc, params)
    with pytest.raises(PolicyError):
        draft_quant_view(cfg, rc, packed)
    rc2 = dataclasses.replace(rc, draft_policy="*=int2:prequant")
    rc_draft, view = draft_quant_view(cfg, rc2, params)
    assert rc_draft.spec_gamma == 0 and rc_draft.draft_policy is None
    leaves = [v for blk in view["groups"][0].values() for v in blk["attn"].values()]
    assert any(x["qbits"].bits == 2 for x in leaves if "qkernel" in x)
    rc_dyn, same = draft_quant_view(cfg, rc, params)
    assert same is params and rc_dyn.quant_policy == "*=int2"


def test_packed_target_serves_spec_from_float_draft_params():
    """A target packed by surgery serves speculatively when the float tree
    comes along as ``draft_params`` (the prequant draft packs it at int2);
    the tokens equal the non-speculative packed serve's."""
    from repro_torch.quant import apply_surgery

    cfg = t_get_config(QWEN)
    pol = "attn.*=int8:per_token,mlp.*=int2:prequant:per_token,*=bf16"
    rc_kw = dict(PAGED, quant_policy=pol)
    params = t_init(cfg, TRunConfig(**dict(RC_KW, **rc_kw)), torch.Generator().manual_seed(0),
                    device="cpu")
    packed = apply_surgery(cfg, TRunConfig(**dict(RC_KW, **rc_kw)), params)
    prompts = _prompts(cfg.vocab_size, n=3)
    _, plain = _serve("port", QWEN, rc_kw, packed, prompts)
    s, out = _serve("port", QWEN, dict(rc_kw, spec_gamma=2, draft_policy="*=int2:prequant"),
                    packed, prompts, draft_params=params)
    assert out == plain and s.drafted_tokens > 0


@pytest.mark.parametrize("where", ["draft", "verify", "cow_drain"])
def test_spec_path_errors_propagate(monkeypatch, where):
    """No fallback hides a kernel: a failed build in the draft or the
    verify step's attention, or a failed copy in the copy-on-write drain,
    raises out of tick() instead of being swallowed or shed."""
    import repro_torch.models.flash as flash
    from repro_torch.kernels.build import BuildError

    cfg = t_get_config(QWEN)
    rc = TRunConfig(**dict(RC_KW, **PAGED, spec_gamma=2, prefix_cache=True))
    params = t_init(cfg, rc, torch.Generator().manual_seed(0), device="cpu")
    s = Scheduler(cfg, rc, params, capacity=32, max_batch=2, device="cpu")
    armed = []
    if where == "cow_drain":
        s.submit(Request(rid=0, prompt=list(range(9)), max_new=2))
        s.run()
        s.mgr.cow_copies.append((0, 1))       # a copy owed to the next step
        err = RuntimeError("CUDA error: unspecified launch failure")

        def failing(*a, **k):
            armed.append(True)
            raise err

        monkeypatch.setattr(torch.Tensor, "index_copy_", failing)
    else:
        err = BuildError("nvcc failed on flash_paged.cu")
        orig = flash.flash_paged_decode

        def attn(*a, **k):
            if armed:
                raise err
            return orig(*a, **k)

        monkeypatch.setattr(flash, "flash_paged_decode", attn)
        owner, name = (s.spec, "_step") if where == "draft" else (s, "_vstep")
        step = getattr(owner, name)

        def arming(*a):
            armed.append(True)
            return step(*a)

        setattr(owner, name, arming)
    s.submit(Request(rid=1, prompt=[3, 1, 4, 1, 5], max_new=4))
    with pytest.raises(type(err), match=str(err).split(":")[0]):
        s.run(max_ticks=50)
    assert armed and not s.admission.rejections
