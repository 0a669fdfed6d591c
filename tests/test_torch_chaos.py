"""Port parity for the chaos suite (the reference's ``tests/test_chaos.py``):
deterministic fault injection, admission control and the degradation
ladder on the port's ``Scheduler`` (plain PyTorch versions on the CPU).

The contract is the reference's — **faults change scheduling, never
results** — and every engine test also runs as a parity test: the
reference's Scheduler and the port's get the same requests, the same
``RunConfig``, the reference's weights carried across by
``repro_torch.interop``, the same admission settings and ``FaultPlan``
seeds, and must agree on greedy tokens, each request's terminal state
(``done``, or the rejection's reason and tick), the ladder's transitions,
``tenant_spent``, every ``health()`` entry but the kernel and latency ones,
and ``cycles_by_bits``. The host-only units (admission, ladder, fault plans,
the allocator's hook) run the reference's assertions on the port's copies.
The speculative variant (draft staleness and its resync) runs as a parity
test too."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import repro.serve.admission as j_adm
import repro.serve.faults as j_faults
from repro.configs.base import RunConfig, get_config
from repro.models import init as j_init
from repro.quant import apply_surgery as j_apply_surgery
from repro.serve import Request as JRequest
from repro.serve import Scheduler as JScheduler
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import get_config as t_get_config
from repro_torch.interop import params_from_reference
from repro_torch.kernels import ops
from repro_torch.kernels.build import BuildError
from repro_torch.quant import apply_surgery as t_apply_surgery
from repro_torch.serve import Request, Scheduler
from repro_torch.serve.admission import (
    LADDER_LEVELS,
    AdmissionController,
    DegradationLadder,
    RejectReason,
)
from repro_torch.serve.cache import BlockManager
from repro_torch.serve.faults import FaultEvent, FaultPlan

torch.set_float32_matmul_precision("highest")
ARCH = "qwen3-0.6b_smoke"
RC_KW = dict(dtype="float32", param_dtype="float32", remat="none",
             kv_layout="paged", block_size=4, prefill_chunk=5)
POLICY = "attn.*=int8,mlp.*=int2,*=bf16"
# the reference's denser-than-default chaos rates (alloc_fail only bites on
# extends that allocate)
CHAOS_RATES = {"alloc_fail": 0.35, "preempt_storm": 0.1, "draft_stale": 0.05,
               "nan_logits": 0.12}


@pytest.fixture(scope="module")
def model():
    """(reference params, port params) of qwen3-0.6b_smoke: the reference's
    init, carried across."""
    cfg = get_config(ARCH)
    params = j_init(cfg, RunConfig(**RC_KW), jax.random.PRNGKey(0))
    return params, params_from_reference(jax.tree.map(np.asarray, params), device="cpu")


def _reqs(cls, n=5, max_new=5, seed=1, **kw):
    """The reference suite's requests, as ``cls`` (either package's)."""
    vocab = get_config(ARCH).vocab_size
    rng = np.random.default_rng(seed)
    out = []
    for rid in range(n):
        r = cls(rid=rid, prompt=rng.integers(0, vocab, 4 + 3 * (rid % 3)).tolist(),
                max_new=max_new)
        for k, v in kw.items():
            setattr(r, k, v)
        out.append(r)
    return out


def _pair(model, *, policy=None, surgery=False, fallback_policy="*=bf16", rc_kw=None,
          draft_params=False, **kw):
    """The reference's and the port's Scheduler over the same weights and
    RunConfig (capacity 32, max_batch 3 unless ``kw`` says otherwise;
    ``rc_kw`` adds RunConfig fields). ``admission`` and ``faults`` in ``kw``
    are factories called with each package's AdmissionController /
    FaultPlan class, so each engine gets its own. ``draft_params`` passes
    each package's float params as the speculative draft's."""
    params, tparams = model
    kw = dict(dict(capacity=32, max_batch=3), **kw)
    adm, faults = kw.pop("admission", None), kw.pop("faults", None)
    out = []
    for pkg in ("ref", "port"):
        rc = (RunConfig if pkg == "ref" else TRunConfig)(
            quant_policy=policy, fallback_policy=fallback_policy, **RC_KW, **(rc_kw or {}))
        cfg = (get_config if pkg == "ref" else t_get_config)(ARCH)
        p = params if pkg == "ref" else tparams
        extra = dict(kw)
        if draft_params:
            extra["draft_params"] = p
        if surgery:
            p = (j_apply_surgery if pkg == "ref" else t_apply_surgery)(cfg, rc, p)
        if adm is not None:
            extra["admission"] = adm(j_adm.AdmissionController if pkg == "ref"
                                     else AdmissionController)
        if faults is not None:
            extra["faults"] = faults(j_faults.FaultPlan if pkg == "ref" else FaultPlan)
        if pkg == "port":
            extra["device"] = "cpu"
        out.append((JScheduler if pkg == "ref" else Scheduler)(cfg, rc, p, **extra))
    return out


def _serve(pair, n=5, max_new=5, **req_kw):
    """Submit the same requests to both engines and run them to the end;
    returns (ref requests, port requests, ref rejections at submit, port's)."""
    out = []
    for s, cls in zip(pair, (JRequest, Request)):
        reqs = _reqs(cls, n=n, max_new=max_new, **req_kw)
        rej = [s.submit(r) for r in reqs]
        s.run(max_ticks=2000)
        out.append((reqs, rej))
    return out[0][0], out[1][0], out[0][1], out[1][1]


def _terminal(reqs):
    return {r.rid: (r.done, None if r.rejected is None else
                    (r.rejected.reason, r.rejected.tick)) for r in reqs}


def _health(s):
    """health() without the kernel counters and the wall-clock latencies,
    which are each package's own."""
    return {k: v for k, v in s.health().items() if k not in ("kernels", "latency")}


def _agree(ref, port, jreqs, treqs):
    """The parity gate: everything the two schedulers decided."""
    assert {r.rid: list(r.out) for r in treqs} == {r.rid: list(r.out) for r in jreqs}
    assert _terminal(treqs) == _terminal(jreqs)
    assert port.ladder.transitions == ref.ladder.transitions
    assert port.admission.tenant_spent == ref.admission.tenant_spent
    assert _health(port) == _health(ref)
    assert port.cycles_by_bits == ref.cycles_by_bits
    if port.track_energy:
        assert ({e["rid"]: e["cycles_by_bits"] for e in port.energy_summary()}
                == {e["rid"]: e["cycles_by_bits"] for e in ref.energy_summary()})
    assert port.final_kv_lens == ref.final_kv_lens


def _assert_clean(s, reqs):
    """The three run-wide invariants every chaos run must satisfy."""
    s.mgr.check_invariants()
    assert s.mgr.pages_in_use == 0, "pages leaked past drain"
    assert s.engine_stalls == 0
    for r in reqs:
        assert r.done or r.rejected is not None, (
            f"request {r.rid} ended without a terminal state")


# ===================================================== admission (host-only)
def test_admission_priority_order_and_fifo():
    adm = AdmissionController()
    rs = _reqs(Request, n=6)
    for r, pri in zip(rs, ["batch", "interactive", "realtime", "batch", "realtime",
                           "interactive"]):
        r.priority = pri
        assert adm.submit(r, now=0) is None
    order = []
    while (r := adm.pop(now=1)) is not None:
        order.append(r.rid)
    # realtime (FIFO) then interactive then batch
    assert order == [2, 4, 1, 5, 0, 3]
    assert adm.admitted == 6


def test_admission_queue_bound_and_tenant_budget():
    adm = AdmissionController(max_queue=2, tenant_budgets={"acme": 20})
    rs = _reqs(Request, n=3, max_new=2, tenant="zeta")
    assert adm.submit(rs[0], 0) is None and adm.submit(rs[1], 0) is None
    rej = adm.submit(rs[2], 0)
    assert rej is not None and rej.reason == RejectReason.QUEUE_FULL
    assert rs[2].rejected is rej

    adm2 = AdmissionController(tenant_budgets={"acme": 11})
    a, b = _reqs(Request, n=2, max_new=2, tenant="acme")  # prompts 4 and 7 tokens
    assert adm2.submit(a, 0) is None                      # cost 6 <= 11
    rej = adm2.submit(b, 0)                               # cost 9: 6+9 > 11
    assert rej is not None and rej.reason == RejectReason.OVER_BUDGET
    # shed-before-run refunds the charge in full
    adm2.shed_class("interactive", now=1)
    assert adm2.tenant_spent["acme"] == 0
    assert adm2.submit(b, 2) is None                      # 9 <= 11 now fits


def test_admission_ttl_sheds_expired_before_run():
    adm = AdmissionController(default_ttl=5)
    a, b = _reqs(Request, n=2)
    adm.submit(a, now=0)
    adm.submit(b, now=4)
    assert a.deadline == 5 and b.deadline == 9
    got = adm.pop(now=7)        # a expired at 5 — shed, never runs
    assert got is b
    assert a.rejected is not None
    assert a.rejected.reason == RejectReason.DEADLINE_EXPIRED
    assert adm.sheds == 1
    assert adm.submit(_reqs(Request, n=1)[0], now=0) is None  # fresh ones fine

    # ttl <= 0 is rejected at submit, before it ever queues
    c = _reqs(Request, n=1)[0]
    c.ttl_ticks = 0
    rej = adm.submit(c, now=3)
    assert rej is not None and rej.reason == RejectReason.DEADLINE_EXPIRED


def test_admission_drain_readmits_only_preempted():
    adm = AdmissionController()
    a, b = _reqs(Request, n=2)
    adm.submit(a, 0)
    adm.submit(b, 0)
    got = adm.pop(1)
    assert got is a and a.admitted
    adm.requeue_front(a)        # preemption path
    adm.draining = True
    assert adm.pop(2, readmit_only=True) is a
    assert adm.pop(3, readmit_only=True) is None   # b never ran: stays queued
    assert adm.flush_pending(RejectReason.SHUTTING_DOWN, 4) == 1
    assert b.rejected.reason == RejectReason.SHUTTING_DOWN


# ======================================================== ladder (host-only)
def test_ladder_escalates_one_level_per_tick_and_relaxes():
    lad = DegradationLadder(relax_after=2)
    assert lad.level == 0
    lad.note_pressure(1, "x")
    lad.note_pressure(1, "x")          # same tick: still one level
    assert lad.level == 1
    lad.note_pressure(2, "x")
    assert lad.level == 2
    lad.note_clean(2)                  # pressure already noted at clock 2
    assert lad.level == 2
    lad.note_clean(3)
    lad.note_clean(4)                  # relax_after=2 clean ticks -> down one
    assert lad.level == 1
    lad.note_clean(5)
    lad.note_clean(6)
    assert lad.level == 0
    names = [(t["from"], t["to"]) for t in lad.transitions]
    assert names == [("healthy", "degrade_gamma"),
                     ("degrade_gamma", "shrink_chunk"),
                     ("shrink_chunk", "degrade_gamma"),
                     ("degrade_gamma", "healthy")]


def test_ladder_floor_and_ceiling():
    lad = DegradationLadder()
    for t in range(1, 5):
        lad.note_pressure(t, "alloc", ceil=3)
    assert lad.level == 3              # pool pressure caps at preempt
    lad.note_pressure(5, "queue_full")
    lad.note_pressure(6, "queue_full")
    assert lad.level == 5              # queue pressure reaches reject
    lad2 = DegradationLadder()
    lad2.escalate_to(1, 3, "preemption")   # floor: never understate remedies
    assert lad2.level == 3
    # the same pressure sequence moves the reference's ladder the same way
    ref = j_adm.DegradationLadder()
    for t in range(1, 5):
        ref.note_pressure(t, "alloc", ceil=3)
    ref.note_pressure(5, "queue_full")
    ref.note_pressure(6, "queue_full")
    assert lad.snapshot() == ref.snapshot()


def test_ladder_effects_and_occupancy():
    lad = DegradationLadder()
    assert lad.gamma_cap(4) == 4
    assert lad.prefill_budget(40, 5) == 40
    for t in range(1, 5):
        lad.note_pressure(t, "q")
        lad.tick()
    assert lad.level == 4
    assert lad.gamma_cap(4) == 0           # shed: no speculation at all
    assert lad.prefill_budget(40, 5) == 5  # one-chunk floor
    lad2 = DegradationLadder()
    lad2.note_pressure(1, "q")
    assert lad2.gamma_cap(4) == 2          # halved per level
    lad2.note_pressure(2, "q")
    assert lad2.prefill_budget(40, 5) == 20
    occ = lad.snapshot()["occupancy"]
    assert sum(occ.values()) == 4 and occ["preempt"] == 1
    assert list(occ) == list(LADDER_LEVELS)


# ========================================================= fault plans
@pytest.mark.parametrize("seed", [0, 1, 2, 7])
def test_fault_plan_deterministic_and_spaced(seed):
    """Same seed, same plan — and the same plan as the reference's copy,
    event for event, under default and chaos rates."""
    a = FaultPlan.generate(seed, horizon=200, max_batch=4)
    b = FaultPlan.generate(seed, horizon=200, max_batch=4)
    assert a.events == b.events and len(a) > 0
    c = FaultPlan.generate(seed + 1, horizon=200, max_batch=4)
    assert a.events != c.events
    last = {}
    for e in a.events:
        if e.kind == "nan_logits":
            assert e.tick - last.get(e.arg, -(1 << 30)) >= 6
            last[e.arg] = e.tick
    assert set(a.describe()["by_kind"]) <= set(
        ("alloc_fail", "preempt_storm", "draft_stale", "nan_logits"))
    with pytest.raises(ValueError):
        FaultEvent(1, "bogus")
    for rates in (None, CHAOS_RATES):
        mine = FaultPlan.generate(seed, horizon=120, max_batch=3, rates=rates)
        ref = j_faults.FaultPlan.generate(seed, horizon=120, max_batch=3, rates=rates)
        assert mine.describe() == ref.describe()
        assert [(e.tick, e.kind, e.arg) for e in mine.events] == \
            [(e.tick, e.kind, e.arg) for e in ref.events]
        assert mine.horizon == ref.horizon and len(mine) == len(ref)
        for t in range(0, 121, 7):
            assert [(e.kind, e.arg) for e in mine.at(t)] == [(e.kind, e.arg) for e in ref.at(t)]
            assert mine.fires(t, "alloc_fail", 1) == ref.fires(t, "alloc_fail", 1)


@settings(max_examples=40, deadline=None)
@given(
    seed=st.integers(0, 10_000),
    pages=st.integers(2, 12),
    ops_=st.lists(st.tuples(st.integers(0, 2), st.integers(0, 2),
                            st.integers(1, 16)), max_size=40),
)
def test_block_manager_invariants_under_random_schedules(seed, pages, ops_):
    """Allocator partition holds under any interleaving of extend/truncate/
    release with an injected-failure hook firing on an arbitrary schedule;
    a hooked-out extend must not mutate anything."""
    rng = np.random.default_rng(seed)
    mgr = BlockManager(num_pages=pages, block_size=4, max_batch=3, capacity=16)
    mgr.fault_hook = lambda slot, new_len: bool(rng.random() < 0.3)
    for op, slot, n in ops_:
        if op == 0:
            before = (mgr.lens.copy(), mgr.blocks_used.copy(), list(mgr.free))
            ok = mgr.extend(slot, max(n, int(mgr.lens[slot])))
            if not ok:
                after = (mgr.lens.copy(), mgr.blocks_used.copy(), list(mgr.free))
                assert all(np.array_equal(x, y) if isinstance(x, np.ndarray)
                           else x == y for x, y in zip(before, after))
        elif op == 1:
            mgr.truncate(slot, int(mgr.lens[slot]) // 2)
        else:
            mgr.release(slot)
        mgr.check_invariants()
    for s in range(3):
        mgr.release(s)
    assert mgr.pages_in_use == 0


# ============================================== engine chaos (fixed seeds)
@pytest.fixture(scope="module")
def baseline(model):
    """Fault-free greedy run of both engines: what the chaos runs must
    match (and the reference's own agreement with the port)."""
    ref, port = _pair(model)
    jreqs, treqs, _, _ = _serve((ref, port))
    _agree(ref, port, jreqs, treqs)
    return {r.rid: list(r.out) for r in treqs}, port.ticks


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chaos_smoke_faults_never_change_results(model, baseline, seed):
    """Generated fault schedule (alloc failures, preemption storms,
    transient NaNs): greedy tokens bit-exact vs the fault-free run,
    allocator partition intact, everything terminates — and every decision
    the reference's engine makes under the same plan."""
    want, ticks = baseline
    plan = lambda cls: cls.generate(seed, horizon=8 * ticks + 50, max_batch=3,
                                    rates=CHAOS_RATES)
    ref, port = _pair(model, faults=plan)
    jreqs, treqs, _, _ = _serve((ref, port))
    _assert_clean(port, treqs)
    _agree(ref, port, jreqs, treqs)
    assert {r.rid: list(r.out) for r in treqs} == want
    h = port.health()
    assert h["clock"] >= h["ticks"]
    # the run actually exercised the fault paths
    assert (port.mgr.injected_failures + h["preemptions"] + h["nan_events"]) > 0


# Cycle totals under a quantized policy are exact where the schedule is the
# fault-free one; under faults a row's chunks land on other ticks, and a
# one-ulp difference of float attention (XLA's summation order against
# PyTorch's) can move one rounding of a later activation: seen here, 127
# int8 cycles in 4.96e7 (2.6e-6) and 1 int2 cycle in 2,136 (4.7e-4). The
# parity bound for them, per bitwidth, is stated here.
CYCLES_REL_TOL = 1e-3


@pytest.mark.parametrize("seed", [0, 1])
def test_chaos_smoke_faults_cycles_follow_reference(model, seed):
    """The chaos plans under the mixed int8/int2 policy with energy
    tracking, and NaNs at ticks 2 and 6: the same decisions as the
    reference, the pool's ``cycles_by_bits`` within ``CYCLES_REL_TOL`` of
    the reference's, and the accounting exact on the port's own numbers:
    quarantined rows stay charged and fallback rows are charged nothing from
    the main step, so the meters sum to the pool's totals. (Per-tensor
    scales tie a row's numbers to its co-batched rows, so here the tokens
    follow the reference, not the fault-free run.)"""
    def plan(cls):   # the generated plan, and NaNs that land for sure
        gen = cls.generate(seed, horizon=250, max_batch=3, rates=CHAOS_RATES)
        return cls(list(gen.events) + [_event(cls, 2, "nan_logits", 0),
                                       _event(cls, 6, "nan_logits", 1)])

    ref, port = _pair(model, policy=POLICY, faults=plan, track_energy=True)
    jreqs, treqs, _, _ = _serve((ref, port))
    _assert_clean(port, treqs)
    assert {r.rid: list(r.out) for r in treqs} == {r.rid: list(r.out) for r in jreqs}
    assert _terminal(treqs) == _terminal(jreqs)
    assert port.ladder.transitions == ref.ladder.transitions
    assert _health(port) == _health(ref)
    assert port.nan_events == ref.nan_events > 0
    assert set(port.cycles_by_bits) == set(ref.cycles_by_bits) == {8, 2}
    for b, tot in port.cycles_by_bits.items():
        for k, v in tot.items():
            want = ref.cycles_by_bits[b][k]
            assert abs(v - want) <= CYCLES_REL_TOL * want, (b, k, v, want)
    for k, var in (("serial_cycles", "serial"), ("parallel_cycles", "parallel")):
        for b, tot in port.cycles_by_bits.items():
            metered = sum(m.cycles_by_bits(var).get(b, 0) for m in port.finished_meters)
            assert abs(metered - tot[k]) <= len(port.finished_meters)   # rounding, one a meter


def test_chaos_smoke_spec_faults_never_change_results(model):
    """Spec-decoding variant: draft staleness, storms and allocation
    failures may cost ticks and resyncs but never change greedy output vs
    the fault-free spec run — and both runs make the reference's decisions
    (tokens, terminal states, ladder, health() with its draft counters,
    final KV lengths) under the same plan."""
    spec = dict(spec_gamma=2, draft_policy="*=int2")
    ref0, port0 = _pair(model, rc_kw=spec, draft_params=True)
    jreqs0, treqs0, _, _ = _serve((ref0, port0), n=4)
    _agree(ref0, port0, jreqs0, treqs0)
    want = {r.rid: list(r.out) for r in treqs0}

    plan = lambda cls: cls.generate(
        3, horizon=8 * port0.ticks + 50, max_batch=3,
        rates={"draft_stale": 0.25, "alloc_fail": 0.0, "preempt_storm": 0.02,
               "nan_logits": 0.0})
    ref, port = _pair(model, rc_kw=spec, draft_params=True, faults=plan)
    jreqs, treqs, _, _ = _serve((ref, port), n=4)
    _assert_clean(port, treqs)
    _agree(ref, port, jreqs, treqs)
    assert {r.rid: list(r.out) for r in treqs} == want
    assert port.draft_stale_events > 0
    assert port.draft_resyncs > 0        # stale slots recovered, not stuck


def test_chaos_smoke_nan_transient_retry_is_bitexact(model, baseline):
    """A one-off NaN on a scheduled row rolls the row back and retries the
    same policy next tick — bit-exact, one nan_event, no fallback."""
    want, _ = baseline
    plan = lambda cls: cls([_event(cls, 3, "nan_logits", 0), _event(cls, 12, "nan_logits", 2)])
    ref, port = _pair(model, faults=plan)
    jreqs, treqs, _, _ = _serve((ref, port))
    _assert_clean(port, treqs)
    _agree(ref, port, jreqs, treqs)
    assert {r.rid: list(r.out) for r in treqs} == want
    assert port.nan_events >= 1
    assert port.fallback_retries == 0


def _event(plan_cls, tick, kind, arg):
    """A FaultEvent of the package ``plan_cls`` (a FaultPlan) belongs to."""
    ev = j_faults.FaultEvent if plan_cls is j_faults.FaultPlan else FaultEvent
    return ev(tick, kind, arg)


def _persistent_nan(cls):
    return cls([_event(cls, t, "nan_logits", 0) for t in range(1, 40)])


def test_nan_persistent_escalates_to_fallback(model):
    """NaN every tick on one row exhausts the clean-retry budget and pins
    the row to the fallback policy (sticky). The request still completes,
    with the reference's tokens, and injection no longer reaches the
    quarantined row."""
    ref, port = _pair(model, faults=_persistent_nan)
    jreqs, treqs, _, _ = _serve((ref, port), n=2)
    _assert_clean(port, treqs)
    _agree(ref, port, jreqs, treqs)
    assert port.fallback_retries >= 1
    assert port.nan_events >= 2          # at least one clean retry was attempted
    assert all(r.done and len(r.out) == 5 for r in treqs)


def test_fallback_on_surgered_params_runs_the_packed_leaves(model):
    """Where the fallback meets surgery: on prequant-packed params the
    ``*=bf16`` fallback step keeps running the packed MLP leaves at their
    packed width (both packages' ``_leaf_backend``). A persistent NaN row
    completes through it with the reference's tokens and cycles, and the
    fallback step's calls include the packed fused GEMM's."""
    ref, port = _pair(model, policy="attn.*=int8,mlp.*=int2:prequant,*=bf16", surgery=True,
                      faults=_persistent_nan, track_energy=True)
    fb_calls = []
    run_fb = port._run_fallback

    def counted(*a, **k):
        base = ops.kernel_counters()
        out = run_fb(*a, **k)
        fb_calls.append(ops.kernel_counters_since(base))
        return out

    port._run_fallback = counted
    jreqs, treqs, _, _ = _serve((ref, port), n=2)
    _assert_clean(port, treqs)
    _agree(ref, port, jreqs, treqs)
    assert port.fallback_retries >= 1 and fb_calls
    assert all(r.done and len(r.out) == 5 for r in treqs)
    for c in fb_calls:
        # the packed MLP GEMMs ran (3 a layer), attention on its wrapper;
        # the bf16 attention GEMMs are plain matmuls, no quantized call site
        assert c["kernels"]["tugemm_fused"]["plain_calls"] == 3 * 2
        assert c["kernels"]["flash_paged_decode"]["plain_calls"] == 2
        assert {n for n in c["paths"]} == {"attn.paged", "mlp.gate", "mlp.up", "mlp.down"}


def test_fallback_policy_error_sheds_numerical_fault(model):
    """A fallback policy that does not resolve is the reference's "no
    fallback path" case: the row is shed with NUMERICAL_FAULT, the other
    requests complete, and both engines agree on all of it."""
    ref, port = _pair(model, faults=_persistent_nan, fallback_policy="*=int3")
    jreqs, treqs, _, _ = _serve((ref, port), n=2)
    _assert_clean(port, treqs)
    _agree(ref, port, jreqs, treqs)
    assert treqs[0].rejected is not None
    assert treqs[0].rejected.reason == RejectReason.NUMERICAL_FAULT
    assert treqs[1].done and port._fb_unavailable


@pytest.mark.parametrize("err", [
    RuntimeError("flash_paged_decode: kernel launch failed (cudaError_t 719)"),
    BuildError("nvcc failed on flash_paged.cu"),
    ValueError("flash_paged_decode: the tile or split plan does not fit the kernel"),
])
def test_fallback_step_kernel_error_propagates(model, monkeypatch, err):
    """Only the policy's resolution is guarded: an error the kernel layer
    raises inside the fallback step (a failed launch, a failed build, a
    launcher's refusal) propagates out of tick() instead of being read as
    "no fallback path" and shed."""
    import repro_torch.models.flash as flash

    port = _pair(model, faults=_persistent_nan)[1]
    armed = []
    orig_rc, orig_attn = Scheduler._fallback_rc, flash.flash_paged_decode

    def arming(self):
        armed.append(True)
        return orig_rc(self)

    def attn(*a, **k):
        if armed:
            raise err
        return orig_attn(*a, **k)

    monkeypatch.setattr(Scheduler, "_fallback_rc", arming)
    monkeypatch.setattr(flash, "flash_paged_decode", attn)
    for r in _reqs(Request, n=2):
        port.submit(r)
    with pytest.raises(type(err), match=str(err).split(":")[0]):
        port.run(max_ticks=2000)
    assert armed and not port._fb_unavailable
    assert not port.admission.rejections


def test_chaos_smoke_overload_rejects_and_recovers(model):
    """Bounded queues under a burst: queue_full rejections at submit, the
    ladder escalates past preempt on queue pressure, and the engine never
    stalls; every request is completed or structurally rejected."""
    def adm(cls):
        return cls(max_queue=2, default_ttl={"batch": 6})

    ref, port = _pair(model, admission=adm, max_batch=2)
    pri = ["realtime", "interactive", "batch"]
    out = []
    for s, cls in ((ref, JRequest), (port, Request)):
        reqs = _reqs(cls, n=9, max_new=4)
        for i, r in enumerate(reqs):
            r.priority = pri[i % 3]
        rejected_at_submit = sum(s.submit(r) is not None for r in reqs)
        s.run(max_ticks=2000)
        out.append((reqs, rejected_at_submit))
    (jreqs, jrej), (treqs, trej) = out
    _assert_clean(port, treqs)
    _agree(ref, port, jreqs, treqs)
    h = port.health()
    assert trej == jrej > 0 and RejectReason.QUEUE_FULL in set(h["rejections"])
    assert h["completed"] > 0
    trans = h["ladder"]["transitions"]
    assert any(t["reason"] == "queue_full" for t in trans)   # escalated...
    assert any("clean" in t["reason"] for t in trans)        # ...and relaxed


def test_chaos_smoke_graceful_drain(model):
    """begin_drain mid-run: active slots finish, queued work is rejected
    SHUTTING_DOWN, nothing is silently dropped, and the energy meters of
    completed work survive for the final flush."""
    out = []
    for s, cls in zip(_pair(model, max_batch=2, track_energy=True), (JRequest, Request)):
        reqs = _reqs(cls, n=6, max_new=4)
        for r in reqs:
            s.submit(r)
        for _ in range(3):
            s.tick()
        s.begin_drain()
        late = s.submit(_reqs(cls, n=1, seed=9)[0])
        assert late.reason == RejectReason.SHUTTING_DOWN
        s.run(max_ticks=2000)
        out.append((s, reqs))
    (ref, jreqs), (port, treqs) = out
    _assert_clean(port, treqs)
    _agree(ref, port, jreqs, treqs)
    assert port.health()["draining"]
    done = [r for r in treqs if r.done]
    shut = [r for r in treqs if r.rejected is not None]
    assert done and shut
    assert all(r.rejected.reason == RejectReason.SHUTTING_DOWN for r in shut)
    rids = {m["rid"] for m in port.energy_summary()}
    assert {r.rid for r in done} <= rids


def test_sigint_drain(model):
    """``install_sigint_drain``: the first SIGINT begins a drain (new work
    is refused SHUTTING_DOWN, queued work that never ran is flushed with it
    after the active slots finish), a second one restores the previous
    handler and raises KeyboardInterrupt."""
    import signal

    from repro_torch.serve import install_sigint_drain

    port = _pair(model, max_batch=2)[1]
    reqs = _reqs(Request, n=4, max_new=3)
    for r in reqs:
        port.submit(r)
    port.tick()
    prev = signal.getsignal(signal.SIGINT)
    restore = install_sigint_drain(port)
    try:
        signal.getsignal(signal.SIGINT)(signal.SIGINT, None)
        assert port.draining and port.queue == reqs[2:]
        assert port.submit(_reqs(Request, n=1, seed=5)[0]).reason == RejectReason.SHUTTING_DOWN
        with pytest.raises(KeyboardInterrupt):
            signal.getsignal(signal.SIGINT)(signal.SIGINT, None)
        assert signal.getsignal(signal.SIGINT) is prev
    finally:
        restore()
    port.run()
    _assert_clean(port, reqs)
    assert [r.done for r in reqs] == [True, True, False, False]
    assert {r.rejected.reason for r in reqs[2:]} == {RejectReason.SHUTTING_DOWN}


def test_stall_accounting_under_pool_pressure(model):
    """Pool-exhaustion row stalls are counted and surfaced in health() —
    never silent — once per episode, as the reference counts them."""
    ref, port = _pair(model, num_pages=7)
    jreqs, treqs, _, _ = _serve((ref, port), max_new=8)
    _assert_clean(port, treqs)
    _agree(ref, port, jreqs, treqs)
    h = port.health()
    assert h["stalled_rows_total"] > 0
    assert 0 < h["stall_episodes"] <= h["stalled_rows_total"]
    assert h["ladder"]["transitions"], "pressure must move the ladder"


# ======================================== engine chaos (hypothesis sweep)
@settings(max_examples=5, deadline=None)
@given(seed=st.integers(0, 1 << 16))
def test_chaos_random_schedules_engine(seed):
    """Broader randomized sweep of the same invariants and of parity (the
    speculative variant waits for speculative decoding in the port)."""
    model = _SWEEP.setdefault("model", _model_once())
    if "ref" not in _SWEEP:
        ref, port = _pair(model)
        _, treqs, _, _ = _serve((ref, port), n=4)
        _SWEEP["ref"] = {r.rid: list(r.out) for r in treqs}
        _SWEEP["ticks"] = port.ticks
    plan = lambda cls: cls.generate(seed, horizon=8 * _SWEEP["ticks"] + 50, max_batch=3)
    ref, port = _pair(model, faults=plan)
    jreqs, treqs, _, _ = _serve((ref, port), n=4)
    _assert_clean(port, treqs)
    _agree(ref, port, jreqs, treqs)
    assert {r.rid: list(r.out) for r in treqs} == _SWEEP["ref"]


_SWEEP: dict = {}


def _model_once():
    cfg = get_config(ARCH)
    params = j_init(cfg, RunConfig(**RC_KW), jax.random.PRNGKey(0))
    return params, params_from_reference(jax.tree.map(np.asarray, params), device="cpu")


# ===================================== tenant accounting + hook ordering
def test_fault_hook_fires_only_on_allocating_extends():
    """The injected-failure hook models a failed page allocation, so it is
    consulted ONLY by extends that need pages — a decode tick landing
    inside an already-allocated block cannot fail and is never asked."""
    mgr = BlockManager(num_pages=8, block_size=4, max_batch=1, capacity=16)
    asked = []
    mgr.fault_hook = lambda slot, new_len: (asked.append(new_len), False)[1]
    for n in range(1, 9):
        assert mgr.extend(0, n)
    # only the block-crossing extends (1 page for 1..4, 2nd page at 5) ask
    assert asked == [1, 5], asked

    # an always-firing hook cannot block intra-block progress
    mgr2 = BlockManager(num_pages=8, block_size=4, max_batch=1, capacity=16)
    mgr2.fault_hook = lambda slot, new_len: True
    assert not mgr2.extend(0, 1)          # allocating: injected failure
    assert mgr2.injected_failures == 1
    mgr2.fault_hook = None
    assert mgr2.extend(0, 1)
    mgr2.fault_hook = lambda slot, new_len: True
    for n in (2, 3, 4):                   # same page: hook never consulted
        assert mgr2.extend(0, n)
    assert not mgr2.extend(0, 5)          # next page: consulted again
    assert mgr2.injected_failures == 2
    mgr2.check_invariants()


def test_chaos_injected_failures_only_on_allocating_ticks(model):
    """Engine-level check of the hook's ordering: wrap the port scheduler's
    fault hook with a checker that recomputes need/have from pre-mutation
    manager state — every consultation must be for a call that would take
    pages off the free list — and agree with the reference's run."""
    def plan(cls):
        return cls([_event(cls, t, "alloc_fail", s) for t in range(0, 400, 2)
                    for s in range(3)])

    ref, port = _pair(model, faults=plan)
    orig, mgr, consultations = port.mgr.fault_hook, port.mgr, []

    def checking_hook(slot, new_len):
        have = int(mgr.blocks_used[slot])
        need = -(-new_len // mgr.block_size)
        assert need - have > 0, (
            f"fault hook consulted on a zero-allocation extend "
            f"(slot {slot}, {int(mgr.lens[slot])}->{new_len})")
        consultations.append((slot, new_len))
        return orig(slot, new_len)

    mgr.fault_hook = checking_hook
    jreqs, treqs, _, _ = _serve((ref, port))
    _assert_clean(port, treqs)
    _agree(ref, port, jreqs, treqs)
    assert consultations, "fault schedule never consulted the hook"
    assert mgr.injected_failures == ref.mgr.injected_failures > 0


def test_finish_refunds_unused_max_new(model):
    """A request that stops early (a capacity cut here, EOS in real
    serving) gets its unused ``max_new - generated`` refunded at finish — a
    follow-up that the charge-forever rule would call OVER_BUDGET is
    admitted."""
    def adm(cls):
        return cls(tenant_budgets={"acme": 40})

    out = []
    for s, cls in zip(_pair(model, admission=adm, capacity=16, max_batch=1),
                      (JRequest, Request)):
        r = cls(rid=0, prompt=list(range(1, 9)), max_new=20, tenant="acme")
        assert s.submit(r) is None
        assert r.charged == 28
        s.run()
        out.append((s, r))
    (ref, jr), (port, r) = out
    _agree(ref, port, [jr], [r])
    assert r.done and r.settled
    assert len(r.out) < 20                      # capacity-truncated
    assert r.consumed_tokens() == 8 + len(r.out)
    assert port.admission.tenant_spent["acme"] == r.consumed_tokens() < r.charged
    r2 = Request(rid=1, prompt=list(range(1, 9)), max_new=15, tenant="acme")
    assert port.submit(r2) is None


def test_shed_refunds_only_unconsumed_remainder():
    """A preemption requeue that already consumed prefill chunks and
    generated tokens keeps that consumption charged when it is later shed —
    only the unconsumed remainder refunds."""
    adm = AdmissionController(tenant_budgets={"acme": 30})
    r = _reqs(Request, n=1, max_new=5, tenant="acme")[0]   # prompt 4: cost 9
    assert adm.submit(r, now=0) is None
    assert adm.pop(now=1) is r
    r.prompt_consumed = 4                                   # prefilled fully
    r.out.extend([7, 8])                                    # generated 2
    adm.requeue_front(r)                                    # preemption
    r.deadline = 2
    assert adm.shed_expired(now=5) == 1                     # expires queued
    assert r.settled and r.rejected is not None
    assert adm.tenant_spent["acme"] == 6                    # 4 + 2 stay charged
    adm.settle(r)                                           # one-shot
    assert adm.tenant_spent["acme"] == 6


def test_tenant_conservation_through_engine_preemption(model):
    """End-to-end conservation: under a preemption storm every terminal
    request's retained charge equals min(charged, consumed), and
    tenant_spent is exactly their sum — the reference's figure."""
    def adm(cls):
        return cls(tenant_budgets={"acme": 10_000})

    plan = lambda cls: cls.generate(1, horizon=600, max_batch=3, rates={
        "alloc_fail": 0.0, "preempt_storm": 0.08, "draft_stale": 0.0, "nan_logits": 0.0})
    ref, port = _pair(model, admission=adm, faults=plan)
    jreqs, treqs, _, _ = _serve((ref, port), tenant="acme")
    _assert_clean(port, treqs)
    _agree(ref, port, jreqs, treqs)
    assert port.preemptions > 0
    assert all(r.settled for r in treqs if r.charged)
    expect = sum(min(r.charged, r.consumed_tokens()) for r in treqs)
    assert port.admission.tenant_spent["acme"] == expect >= 0


# ------------------------------------------------- spent-conservation property
def _drive_conservation(ops_, adm_cls=AdmissionController, req_cls=Request):
    """Replay an op tape against an AdmissionController + simulated
    consumption, asserting after EVERY op that each tenant's spent equals
    Σ charged over live requests + Σ min(charged, consumed) over settled
    ones, and never goes negative. Returns the final tenant_spent."""
    adm = adm_cls(tenant_budgets={"t0": 60, "t1": 35})
    all_reqs, running, rid = [], [], 0
    for now, (op, a, b) in enumerate(ops_):
        if op == 0:      # submit
            r = req_cls(rid=rid, prompt=[1] * (1 + a % 6), max_new=1 + b % 5,
                        tenant=f"t{a % 2}")
            rid += 1
            all_reqs.append(r)
            adm.submit(r, now)
        elif op == 1:    # admit
            r = adm.pop(now)
            if r is not None:
                running.append(r)
        elif op == 2 and running:    # consume prompt tokens (prefill commit)
            r = running[a % len(running)]
            r.prompt_consumed = min(len(r.prompt), r.prompt_consumed + 1 + b % 3)
        elif op == 3 and running:    # generate tokens (capped at max_new)
            r = running[a % len(running)]
            if len(r.out) < r.max_new:
                r.out.append(int(b))
        elif op == 4 and running:    # finish (scheduler._finish settles)
            r = running.pop(a % len(running))
            r.done = True
            adm.settle(r)
        elif op == 5 and running:    # recompute-preemption requeue
            adm.requeue_front(running.pop(a % len(running)))
        elif op == 6:    # overload shed of a whole queued class
            adm.shed_class(("realtime", "interactive", "batch")[a % 3], now)
        for tenant in ("t0", "t1"):
            expect = sum(
                (min(r.charged, r.consumed_tokens()) if r.settled else r.charged)
                for r in all_reqs if r.tenant == tenant)
            assert adm.tenant_spent.get(tenant, 0) == expect, (
                f"op {now} ({op},{a},{b}): tenant {tenant} spent "
                f"{adm.tenant_spent.get(tenant, 0)} != {expect}")
            assert adm.tenant_spent.get(tenant, 0) >= 0
    for r in running:
        adm.settle(r)
    adm.flush_pending(RejectReason.SHUTTING_DOWN, len(ops_))
    for tenant in ("t0", "t1"):
        expect = sum(min(r.charged, r.consumed_tokens())
                     for r in all_reqs if r.tenant == tenant and r.charged)
        assert adm.tenant_spent.get(tenant, 0) == expect >= 0
    return dict(adm.tenant_spent), adm.rejections_by_reason()


@settings(deadline=None, max_examples=120)
@given(st.lists(st.tuples(st.integers(0, 6), st.integers(0, 7),
                          st.integers(0, 7)), min_size=1, max_size=60))
def test_tenant_spent_conservation_property(ops_):
    """Across ANY interleaving of submit / admit / consume / finish /
    preempt-requeue / shed, tenant_spent is exactly the sum of live charges
    plus settled min(charged, consumed)."""
    _drive_conservation(ops_)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_tenant_spent_conservation_fixed_seeds(seed):
    """Fixed-seed tapes through the same driver, and through the
    reference's controller: the same spent and the same rejections."""
    rng = np.random.default_rng(seed)
    ops_ = [tuple(map(int, (rng.integers(0, 7), rng.integers(0, 8), rng.integers(0, 8))))
            for _ in range(200)]
    assert _drive_conservation(ops_) == _drive_conservation(
        ops_, j_adm.AdmissionController, JRequest)
