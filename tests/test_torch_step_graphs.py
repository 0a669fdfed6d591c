"""The compiled serving steps (``repro_torch/serve/graphs.py``) on the CPU.

A CUDA graph cannot be captured here, so the bookkeeping around one —
static input buffers, the stats reduction inside the step, the copy of a
replay's totals, the capture's counter delta taken out and added back on
every replay, the refusal of a step that does not update its caches in
place — is driven through ``graphs.RerunGraph``,
which reruns the eager step into the captured outputs. Through it the
port's Scheduler must give the reference Scheduler's greedy tokens and
``cycles_by_bits`` (``qwen3-0.6b_smoke`` and ``deepseek-v2-lite-16b_smoke``
with its MoE drops, a γ=2 speculative serve and a prefix-cached one), and
the eager port Scheduler's ``health()["kernels"]``. The card's graphs are
held to the eager step in ``test_torch_gpu_step_graphs.py``."""

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig, get_config
from repro.models import init as j_init
from repro.serve import Request as JRequest
from repro.serve import Scheduler as JScheduler
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import get_config as t_get_config
from repro_torch.core.tugemm import TuGemmStats
from repro_torch.interop import params_from_reference
from repro_torch.kernels import ops
from repro_torch.quant import capture
from repro_torch.serve import Request, Scheduler
from repro_torch.serve import graphs

torch.set_float32_matmul_precision("highest")
QWEN, DS = "qwen3-0.6b_smoke", "deepseek-v2-lite-16b_smoke"
RC_KW = dict(dtype="float32", param_dtype="float32", remat="none", prefill_chunk=5,
             kv_cache_dtype="int8", kv_layout="paged", block_size=4)


def _rerun(s):
    """Scheduler ``s`` with its main, verify and draft steps behind the
    CPU stand-in for a CUDA graph."""
    s.graphs = True
    for name, r in s._runners().items():
        if name != "fallback":
            r.backend = graphs.RerunGraph
    return s


def _serve(pkg, arch, rc_kw, params, prompts, *, rerun=False, max_new=4, sequential=False,
           **kw):
    rc = (RunConfig if pkg == "ref" else TRunConfig)(**dict(RC_KW, **rc_kw))
    cfg = (get_config if pkg == "ref" else t_get_config)(arch)
    extra = {} if pkg == "ref" else {"device": "cpu"}
    s = (JScheduler if pkg == "ref" else Scheduler)(
        cfg, rc, params, capacity=32, max_batch=3, track_energy=True, **kw, **extra)
    if rerun:
        _rerun(s)
    req = JRequest if pkg == "ref" else Request
    for rid, p in enumerate(prompts):
        s.submit(req(rid=rid, prompt=list(p), max_new=max_new))
        if sequential:
            s.run()
    s.run()
    # the kernel counters are process-wide: read this serve's before the next
    kernels = s.health()["kernels"] if pkg == "port" else None
    return s, {r.rid: list(r.out) for r in s.finished}, kernels


def _weights(arch, rc_kw):
    params = j_init(get_config(arch), RunConfig(**dict(RC_KW, **rc_kw)), jax.random.PRNGKey(0))
    return params, params_from_reference(jax.tree.map(np.asarray, params), device="cpu")


def _energy(s):
    return {e["rid"]: (e["cycles_by_bits"], e.get("draft_cycles_by_bits"))
            for e in s.energy_summary()}


def _three(arch, rc_kw, prompts, **kw):
    """The reference, the eager port and the rerun-graphed port on the same
    weights and requests."""
    params, tparams = _weights(arch, rc_kw)
    ref = _serve("ref", arch, rc_kw, params, prompts, **kw)
    eager = _serve("port", arch, rc_kw, tparams, prompts, **kw)
    graphed = _serve("port", arch, rc_kw, tparams, prompts, rerun=True, **kw)
    return ref, eager, graphed


def _agree(ref, eager, graphed):
    (js, jo, _), (es, eo, ek), (gs, go, gk) = ref, eager, graphed
    assert go == eo == jo
    assert gs.final_kv_lens == js.final_kv_lens
    assert _energy(gs) == _energy(es) == _energy(js)
    assert gs.cycles_by_bits == es.cycles_by_bits == js.cycles_by_bits
    assert gs.tick_dropped_tokens == es.tick_dropped_tokens
    assert gk == ek
    for k in ("ticks", "drafted_tokens", "accepted_draft_tokens", "prefix_hits",
              "prefix_tokens_reused", "prefill_tokens_computed"):
        assert getattr(gs, k) == getattr(es, k) == getattr(js, k), k
    gs.mgr.check_invariants()


def _prompts(vocab, n=3, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, 4 + 3 * i).tolist() for i in range(n)]


# ------------------------------------------------------------ the reduction
def _gemm(serial, parallel):
    z = torch.zeros(1, dtype=torch.int32)
    return TuGemmStats(z, serial, parallel, z, None)


def test_stack_totals_sums_each_bitwidth_and_scalar():
    """One int64 tensor holds each bitwidth's serial and parallel totals in
    first-seen order, then each named scalar's sum; int32 and int64 stats
    and an expert axis sum alike, and the host read equals the per-entry
    sums."""
    cap = capture.Capture()
    cap.entries += [
        capture.CapturedGemm("a", 2, 3, 4, _gemm(torch.tensor(7, dtype=torch.int64),
                                                 torch.tensor(2, dtype=torch.int64)), bits=8),
        capture.CapturedGemm("b", 2, 3, 4, _gemm(torch.tensor([5, 6], dtype=torch.int32),
                                                 torch.tensor([1, 1], dtype=torch.int32)), 2),
        capture.CapturedGemm("c", 2, 3, 4, _gemm(torch.tensor(2 ** 40, dtype=torch.int64),
                                                 torch.tensor(3, dtype=torch.int64)), bits=8),
    ]
    cap.scalars += [capture.CapturedScalar("moe.dropped_tokens", torch.tensor(4)),
                    capture.CapturedScalar("x", torch.tensor([1, 2])),
                    capture.CapturedScalar("moe.dropped_tokens", torch.tensor(5))]
    tot = capture.StepTotals.of(cap)
    assert tot.layout == capture.TotalsLayout((8, 2), ("moe.dropped_tokens", "x"))
    assert tot.values.dtype == torch.int64 and tot.values.shape == (6,)
    by_bits, scalars = tot.host()
    assert by_bits == {8: {"serial_cycles": 7 + 2 ** 40, "parallel_cycles": 5},
                       2: {"serial_cycles": 11, "parallel_cycles": 2}}
    assert scalars == {"moe.dropped_tokens": 9, "x": 3}
    assert capture.tree_totals_by_bits(cap) == by_bits
    assert capture.scalar_totals(cap) == scalars
    empty = capture.StepTotals.of(capture.Capture())
    assert empty.values is None and empty.host() == ({}, {})


# ------------------------------------------------------- the graph runner
B, MB = 3, 4


def _toy_step(params, caches, tokens, pos, lens, tables):
    """A step that launches through a kernel wrapper (the int8 GEMM's
    plain version, with stats), records a path and a scalar, writes its
    cache in place and reads every input."""
    with capture.capture_stats() as cap:
        a = (tokens % 5 - 2).to(torch.int8)
        y, st = ops.matmul_int8(a, params["w"][: a.shape[1]], collect_stats=True)
        capture.push("toy", a.shape[0], a.shape[1], y.shape[1], st, bits=8)
        capture.push_scalar("toy.lens", lens)
        ops.record_path("toy", "torch")
        caches[0]["kv"].index_add_(0, pos.long() % B, y.to(torch.float32))
        logits = y.to(torch.float32) + tables.sum(1, keepdim=True) + lens[:, None]
    return caches, logits, cap


def _toy_calls():
    rng = np.random.default_rng(0)
    for W, dev_tokens in ((2, False), (3, False), (2, True), (2, False), (3, True), (2, False)):
        tokens = rng.integers(0, 50, (B, W)).astype(np.int32)
        pos = rng.integers(0, 9, B).astype(np.int32)
        lens = rng.integers(0, W + 1, B).astype(np.int32)
        tables = rng.integers(0, 7, (B, MB)).astype(np.int32)
        yield (torch.from_numpy(tokens) if dev_tokens else tokens), pos, lens, tables


def test_step_graphs_replay_equals_the_eager_step():
    """Width by width: the first call runs eagerly, the second captures
    (writing no cache) and replays, later ones replay; every call's logits,
    totals and cache writes equal an eager runner's, the kernel and path
    counters move as the eager runner's do, and a replay's totals are a
    copy that later replays leave as it was. Both runners stage their
    inputs into one buffer a width."""
    w = torch.arange(4 * 6, dtype=torch.int8).reshape(4, 6) % 7 - 3
    params = {"w": w}
    dev = torch.device("cpu")
    runs = {}
    for name, backend in (("eager", None), ("graphed", graphs.RerunGraph)):
        caches = ({"kv": torch.zeros(B, 6)},)
        r = graphs.StepGraphs(_toy_step, name="toy", device=dev, rows=B, table_width=MB,
                              backend=backend)
        ops.reset_counts()
        outs = []
        for args in _toy_calls():
            caches, logits, tot = r(params, caches, *args)
            outs.append((logits.clone(), tot.host(), tot, caches[0]["kv"].clone()))
        runs[name] = (r, outs, ops.kernel_counts(), ops.path_counts(), caches)
    (er, eo, ek, ep, _), (gr, go, gk, gp, gc) = runs["eager"], runs["graphed"]
    for (el, eh, _, ec), (gl, gh, _, gcache) in zip(eo, go):
        assert torch.equal(gl, el) and gh == eh and torch.equal(gcache, ec)
    assert gk == ek and gp == ep
    assert ek["tugemm_int8"]["plain_calls"] == 6 and ep == {"toy": {"torch": 6}}
    counts = gr.counts()
    assert {W: (c["eager"], c["replays"]) for W, c in counts.items()} == {2: (1, 3), 3: (1, 1)}
    assert all(c["capture_ms"] >= 0 and c["pool_bytes"] == 0 for c in counts.values())
    assert er.counts() == {2: {"eager": 4, "replays": 0}, 3: {"eager": 2, "replays": 0}}
    # each width-2 replay's totals are its own: the later replays left the
    # first one's as they were
    assert go[3][2].values is not go[5][2].values
    assert go[3][1] != go[5][1] and go[3][2].host() == go[3][1]
    assert set(er._widths) == {2, 3} and all(w.graph is None for w in er._widths.values())
    with pytest.raises(RuntimeError, match="caches moved"):
        gr(params, ({"kv": torch.zeros(B, 6)},), *next(_toy_calls()))
    assert gc[0]["kv"].shape == (B, 6)


def test_a_step_that_returns_new_caches_cannot_be_graphed():
    """A graph replays into the caches of its capture, so the first (eager)
    call of a graphed runner raises when the step hands back new cache
    tensors (a state that is rebuilt, not written in place); an eager
    runner takes them."""

    def step(params, caches, tokens, pos, lens, tables):
        return ({"h": caches[0]["h"] + tokens.sum()},), tokens.to(torch.float32)

    args = next(_toy_calls())
    for backend in (None, graphs.RerunGraph):
        r = graphs.StepGraphs(step, name="rebuilt", device=torch.device("cpu"), rows=B,
                              table_width=MB, backend=backend)
        caches = ({"h": torch.zeros(2)},)
        if backend is None:
            new, _, _ = r({}, caches, *args)
            assert new[0]["h"] is not caches[0]["h"]
            continue
        with pytest.raises(RuntimeError, match="rebuilt step: it returned new cache tensors"):
            r({}, caches, *args)


def test_capture_failure_raises_and_restores_the_counters():
    """A step that fails inside its capture raises a RuntimeError naming
    the step and width; the counters hold what ran before it, no more."""
    calls = []

    def step(params, caches, tokens, pos, lens, tables):
        calls.append(1)
        ops.record_path("flaky", "torch")
        if len(calls) == 2:
            raise RuntimeError("operation not permitted when stream is capturing")
        return caches, tokens.to(torch.float32)

    r = graphs.StepGraphs(step, name="flaky", device=torch.device("cpu"), rows=B,
                          table_width=MB, backend=graphs.RerunGraph)
    ops.reset_counts()
    args = next(_toy_calls())
    r({}, ({"kv": torch.zeros(1)},), *args)
    with pytest.raises(RuntimeError, match="flaky step's graph at width 2"):
        r({}, ({"kv": torch.zeros(1)},), *args)
    assert ops.path_counts() == {"flaky": {"torch": 1}}


def test_graphs_flag_resolution():
    """``graphs=None`` means graphs on a CUDA device without a mesh;
    ``graphs=True`` on the CPU or with a mesh raises; a CPU Scheduler runs
    eagerly and counts its eager calls a width."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert graphs.resolve_graphs(None, cuda, None)
    assert not graphs.resolve_graphs(None, cpu, None)
    assert not graphs.resolve_graphs(None, cuda, "2,4")
    assert not graphs.resolve_graphs(False, cuda, None)
    for dev, mesh in ((cpu, None), (cuda, "2,4"), (cpu, (1, 2))):
        with pytest.raises(ValueError, match="graphs=True"):
            graphs.resolve_graphs(True, dev, mesh)
    cfg = t_get_config(QWEN)
    rc = TRunConfig(quant_policy="attn.*=int8,*=int2", **RC_KW)
    params = params_from_reference(
        jax.tree.map(np.asarray, j_init(get_config(QWEN), RunConfig(**RC_KW),
                                        jax.random.PRNGKey(0))), device="cpu")
    with pytest.raises(ValueError, match="graphs=True"):
        Scheduler(cfg, rc, params, capacity=32, max_batch=3, device="cpu", graphs=True)
    with pytest.raises(ValueError, match="graphs=True"):
        Scheduler(cfg, rc, params, capacity=32, max_batch=2, device="cpu", graphs=True,
                  mesh=(1, 2), mesh_backend="gloo")
    s = Scheduler(cfg, rc, params, capacity=32, max_batch=3, device="cpu")
    assert s.graphs is False
    s.submit(Request(rid=0, prompt=[1, 2, 3, 4, 5, 6, 7], max_new=3))
    s.run()
    assert s.step_counts() == {"main": {1: {"eager": 2, "replays": 0},
                                        5: {"eager": 2, "replays": 0}}}


# --------------------------------------------------------- the Scheduler
@pytest.mark.parametrize("arch,policy", [
    (QWEN, "attn.*=int8,mlp.*=int2,*=bf16"),
    (DS, "mla.*=int8,moe.*=int2,mlp.*=int2,*=bf16"),
])
def test_graphed_scheduler_matches_reference(arch, policy):
    """The mixed step behind graphs: the reference's greedy tokens, KV
    lengths and ``cycles_by_bits`` (per request and in total), the eager
    port's MoE drops a tick and kernel counters, and replays at both widths
    after one eager call each."""
    prompts = _prompts(get_config(arch).vocab_size)
    ref, eager, graphed = _three(arch, dict(quant_policy=policy), prompts)
    _agree(ref, eager, graphed)
    gs = graphed[0]
    if arch == DS:
        assert len(gs.tick_dropped_tokens) == gs.ticks and sum(gs.tick_dropped_tokens) > 0
    main = gs.step_counts()["main"]
    assert set(main) == {1, 5}
    assert all(c["eager"] == 1 and c["replays"] > 0 for c in main.values())


@pytest.mark.parametrize("case", ["spec", "prefix"])
def test_graphed_spec_and_prefix_serves_match_reference(case):
    """A γ=2 speculative serve (the draft step at widths γ+1, 1 and the
    chunk, its totals kept call by call; the verify step) and a
    prefix-cached one (a shared prompt, one request after another: each
    forks the cached prefix): the reference's tokens and target and draft
    cycles, the eager port's counters."""
    rng = np.random.default_rng(7)
    if case == "spec":
        rc_kw = dict(quant_policy="attn.*=int8,*=int2", spec_gamma=2, prefill_chunk=3)
        prompts = _prompts(get_config(QWEN).vocab_size)
    else:
        rc_kw = dict(quant_policy="attn.*=int8,*=int2", prefix_cache=True)
        shared = rng.integers(0, 256, 13).tolist()
        prompts = [shared + rng.integers(0, 256, 3 + i).tolist() for i in range(3)]
    ref, eager, graphed = _three(QWEN, rc_kw, prompts, max_new=6, sequential=case == "prefix")
    _agree(ref, eager, graphed)
    counts = graphed[0].step_counts()
    if case == "spec":
        assert graphed[0].drafted_tokens > 0
        assert set(counts) == {"verify", "draft"}
        assert counts["draft"][1]["replays"] > 0
        assert all(c["eager"] == 1 for r in counts.values() for c in r.values())
    else:
        assert graphed[0].prefix_hits > 0
        assert all(c["replays"] > 0 for c in counts["main"].values())
