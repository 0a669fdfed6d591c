"""Port parity for observability (the reference's ``tests/test_obs.py``):
the port's copies of the metrics registry, tracer and ``kv()`` formatter
get the same call sequences as the reference's modules and must give the
same output (Prometheus text, snapshot/diff, JSONL, the trace JSON with
timestamps normalised, log lines); ``health()`` has the reference's keys
on ``qwen3-0.6b_smoke``; kernel counters are scoped per scheduler; tracing
changes no token; the registry and the legacy counters are one store; and
the PyTorch profiler ranges (``obs/profile.py``) show up in a CPU
``torch.profiler`` trace without touching NVTX."""

import json

import jax
import numpy as np
import pytest
import torch

import repro.obs.logs as j_logs
import repro.obs.metrics as j_metrics
import repro.obs.trace as j_trace
from repro.configs.base import RunConfig, get_config
from repro.models import init as j_init
from repro.serve import Request as JRequest
from repro.serve import Scheduler as JScheduler
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import get_config as t_get_config
from repro_torch.interop import params_from_reference
from repro_torch.obs import device_trace, named_scope
from repro_torch.obs import logs as t_logs
from repro_torch.obs import metrics as t_metrics
from repro_torch.obs import trace as t_trace
from repro_torch.obs.metrics import MetricsRegistry, family_percentile
from repro_torch.obs.trace import NULL_TRACER, Tracer, trace_summary, validate_chrome_trace
from repro_torch.serve import Request, Scheduler, build_mixed_step

torch.set_float32_matmul_precision("highest")
ARCH = "qwen3-0.6b_smoke"
RC_KW = dict(dtype="float32", param_dtype="float32", remat="none",
             prefill_chunk=4, kv_cache_dtype="int8", kv_layout="paged", block_size=4)
# wall-clock families: each package's own numbers
WALL = ("serve_ttft_seconds", "serve_itl_seconds", "serve_tick_seconds")


@pytest.fixture(scope="module")
def model():
    cfg = get_config(ARCH)
    params = j_init(cfg, RunConfig(**RC_KW), jax.random.PRNGKey(0))
    return params, params_from_reference(jax.tree.map(np.asarray, params), device="cpu")


def _prompts(n=4, seed=1):
    rng = np.random.default_rng(seed)
    vocab = get_config(ARCH).vocab_size
    return [rng.integers(0, vocab, 4 + 3 * i).tolist() for i in range(n)]


def _run(params, *, prompts, ref=False, max_new=6, **kw):
    """The reference suite's serve: capacity 32, 3 rows, greedy."""
    if ref:
        s = JScheduler(get_config(ARCH), RunConfig(**RC_KW), params, capacity=32,
                       max_batch=3, temperature=0.0, **kw)
        req = JRequest
    else:
        s = Scheduler(t_get_config(ARCH), TRunConfig(**RC_KW), params, capacity=32,
                      max_batch=3, temperature=0.0, device="cpu", **kw)
        req = Request
    for rid, p in enumerate(prompts):
        s.submit(req(rid=rid, prompt=list(p), max_new=max_new))
    s.run()
    return s, {r.rid: list(r.out) for r in s.finished}


def _normalised(obj):
    """A trace dict with every timestamp and duration zeroed."""
    out = []
    for ev in obj["traceEvents"]:
        ev = dict(ev)
        for k in ("ts", "dur"):
            if k in ev:
                ev[k] = 0.0
        out.append(ev)
    return dict(obj, traceEvents=out)


# ------------------------------------------------------------------ units
def _tracer_calls(mod):
    tr = mod.Tracer()
    tr.name_process(1, "sched")
    tr.name_thread(2, 7, "req 7")
    with tr.span("tick", args={"clock": 1}):
        pass
    t0 = tr.ts()
    tr.complete("decode", 2, 7, t0, 5.0, args={"tokens": 1})
    tr.instant("submit", 2, 7)
    tr.counter("pool_pages", {"in_use": 3, "live": 5})
    tr.complete("negative", 1, 0, t0, -3.0)     # clamped to 0 at export
    return tr


def test_tracer_schema_and_summary():
    obj = _tracer_calls(t_trace).to_dict()
    validate_chrome_trace(obj)
    s = trace_summary(obj)
    assert s["spans"] == {"tick": 1, "decode": 1, "negative": 1}
    assert s["instants"] == {"submit": 1}
    assert s["counters"] == {"pool_pages": 1}
    assert s["request_tracks"] == 1
    ref = _tracer_calls(j_trace).to_dict()
    assert _normalised(obj) == _normalised(ref)
    assert json.dumps(_normalised(obj)) == json.dumps(_normalised(ref))
    assert s == j_trace.trace_summary(ref)
    assert (t_trace.PID_SCHED, t_trace.PID_REQUESTS, t_trace.TID_TICK) == \
        (j_trace.PID_SCHED, j_trace.PID_REQUESTS, j_trace.TID_TICK)


def test_tracer_export_roundtrip(tmp_path):
    tr = Tracer()
    with tr.span("tick"):
        pass
    p = tmp_path / "t.json"
    summ = tr.export(str(p))
    obj = json.loads(p.read_text())
    validate_chrome_trace(obj)
    assert obj["displayTimeUnit"] == "ms"
    assert summ == trace_summary(obj)


def test_null_tracer_is_inert():
    assert not NULL_TRACER.enabled
    with NULL_TRACER.span("x"):  # must be a working (null) contextmanager
        pass
    NULL_TRACER.instant("y", 1, 0)
    NULL_TRACER.counter("z", {"a": 1})
    assert NULL_TRACER.to_dict()["traceEvents"] == []
    assert NULL_TRACER.to_dict() == j_trace.NULL_TRACER.to_dict()


@pytest.mark.parametrize("obj", [
    {"traceEvents": [{"ph": "X", "name": "no-ts"}]},
    {"events": []},
    {"traceEvents": [{"ph": "Q", "name": "x", "pid": 1, "tid": 0, "ts": 0}]},
    {"traceEvents": [{"ph": "X", "name": "x", "pid": 1, "tid": 0, "ts": 1.0, "dur": -1}]},
    {"traceEvents": [{"ph": "C", "name": "x", "pid": 1, "tid": 0, "ts": 1.0,
                      "args": {"a": "b"}}]},
    {"traceEvents": [{"ph": "M", "name": "thread_name", "pid": 1, "tid": 0}]},
])
def test_validate_rejects_malformed(obj):
    with pytest.raises(ValueError) as mine:
        validate_chrome_trace(obj)
    with pytest.raises(ValueError) as ref:
        j_trace.validate_chrome_trace(obj)
    assert str(mine.value) == str(ref.value)


def _metrics_calls(mod):
    """The reference suite's registry calls plus labels needing escapes,
    float and int values, histogram buckets and a diff."""
    m = mod.MetricsRegistry()
    c = m.counter("req_total", "requests", labels=("priority",))
    c.labels("rt").inc()
    c.labels("rt").inc(2)
    c.labels("batch").inc()
    c.labels('we"ird\\x\ny').inc(0.5)
    g = m.gauge("depth")
    g.value = 7
    m.gauge("level", "a float gauge").set(2.5)
    m.gauge_fn("lazy", lambda: {"state=a": 1.0, "state=b": 2.0})
    h = m.histogram("lat_s")
    for v in (0.01, 0.02, 0.4, 200.0):
        h.observe(v)
    hl = m.histogram("wait_ticks", "ticks", labels=("priority",), buckets=(0, 1, 2, 4))
    for v in (0, 1, 3, 9):
        hl.labels("rt").observe(v)
    snap = m.snapshot()
    c.labels("rt").inc(5)
    h.observe(0.003)
    return m, snap, h


def test_metrics_counter_gauge_histogram():
    m, snap, h = _metrics_calls(t_metrics)
    assert snap["req_total"]["values"]["priority=rt"] == 3
    assert snap["depth"]["values"][""] == 7
    assert snap["lazy"]["values"]["state=b"] == 2.0
    assert snap["lat_s"]["values"][""]["count"] == 4
    d = MetricsRegistry.diff(m.snapshot(), snap)
    assert d["req_total"]["values"]["priority=rt"] == 5
    prom = m.to_prometheus()
    assert '# TYPE req_total counter' in prom
    assert 'req_total{priority="rt"} 8' in prom
    # the same calls on the reference's registry: the same bytes out
    rm, rsnap, rh = _metrics_calls(j_metrics)
    assert snap == rsnap and m.snapshot() == rm.snapshot()
    assert d == j_metrics.MetricsRegistry.diff(rm.snapshot(), rsnap)
    assert prom == rm.to_prometheus()
    assert [h.percentile(p) for p in (0, 50, 95, 99, 100)] == \
        [rh.percentile(p) for p in (0, 50, 95, 99, 100)]
    assert t_metrics.DEFAULT_BUCKETS == j_metrics.DEFAULT_BUCKETS


def test_metrics_family_percentile():
    def fill(mod):
        m = mod.MetricsRegistry()
        h = m.histogram("x_s", labels=("k",))
        for v in (1.0, 2.0, 3.0):
            h.labels("a").observe(v)
        for v in (4.0, 5.0):
            h.labels("b").observe(v)
        return h

    h, rh = fill(t_metrics), fill(j_metrics)
    assert family_percentile(h, 50) == pytest.approx(3.0)
    assert 4.5 <= family_percentile(h, 99) <= 5.0  # interpolated tail
    for p in (0, 25, 50, 90, 99, 100):
        assert family_percentile(h, p) == j_metrics.family_percentile(rh, p)


def test_metrics_adopt_merges(tmp_path):
    out = []
    for mod in (t_metrics, j_metrics):
        a, b = mod.MetricsRegistry(), mod.MetricsRegistry()
        a.counter("inner_total").inc(1)
        b.counter("inner_total").inc(4)
        b.gauge_fn("g", lambda: 3)
        a.adopt(b)
        assert a.snapshot()["inner_total"]["values"][""] == 5
        path = tmp_path / f"{mod.__name__}.jsonl"
        a.emit_jsonl(str(path), extra={"tag": "t"})
        a.emit_jsonl(str(path))
        lines = [json.loads(l) for l in path.read_text().splitlines()]
        assert len(lines) == 2 and lines[0]["tag"] == "t"
        assert lines[1]["metrics"]["inner_total"]["values"][""] == 5
        out.append([{k: v for k, v in l.items() if k != "ts"} for l in lines])
    assert out[0] == out[1]


@pytest.mark.parametrize("event,fields", [
    ("stall", dict(tick=3, rid="r 1", pool=0.5)),
    ("nan_logits", dict(rid=4, tick=17, row=2, retries=1, action="retry")),
    ("x", dict(a="", b='q"uote', c="k=v", d=1e-9, e=12345678.9, f=True, g=None)),
    ("bare", {}),
])
def test_kv_formatter(event, fields):
    s = t_logs.kv(event, **fields)
    assert s == j_logs.kv(event, **fields)
    assert s.startswith(event)
    if event == "stall":
        assert "tick=3" in s and "pool=0.5" in s
        assert "rid='r 1'" in s  # values with spaces are quoted


# ----------------------------------------------------- scheduler integration
def _keys(d, prefix=""):
    """Nested key paths of a health() dict, down into its fixed sub-dicts."""
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k in ("latency", "ttft_s", "itl_s", "tick_s", "pool",
                                         "prefix_cache", "sharding", "mesh", "ladder"):
            out |= _keys(v, prefix + k + ".")
    return out


def test_health_golden_keys(model):
    params, tparams = model
    s, _ = _run(tparams, prompts=_prompts())
    ref, _ = _run(params, prompts=_prompts(), ref=True)
    h = s.health()
    for k in ("clock", "completed", "admitted", "rejections", "ladder",
              "kernels", "latency"):
        assert k in h, f"health() lost key {k!r}"
    assert _keys(h) == _keys(ref.health())
    lat = h["latency"]
    for fam in ("ttft_s", "itl_s", "tick_s"):
        assert set(lat[fam]) == {"count", "p50", "p95", "p99"}
        assert lat[fam]["count"] > 0
        assert lat[fam]["p50"] <= lat[fam]["p99"]
        assert lat[fam]["count"] == ref.health()["latency"][fam]["count"]
    assert "paths" in h["kernels"]
    assert {k: v for k, v in h.items() if k not in ("kernels", "latency")} == \
        {k: v for k, v in ref.health().items() if k not in ("kernels", "latency")}
    assert s.cache_stats() == ref.cache_stats()


def test_kernel_counters_scoped_per_scheduler(model):
    """Kernel and path counters are process-wide; health() reports only the
    calls THIS scheduler made: the same workload twice reports the same
    counts, not the sum."""
    _, tparams = model
    s1, _ = _run(tparams, prompts=_prompts(n=2))
    k1 = s1.health()["kernels"]
    s2, _ = _run(tparams, prompts=_prompts(n=2))
    k2 = s2.health()["kernels"]
    total1 = sum(sum(d.values()) for d in k1["paths"].values())
    total2 = sum(sum(d.values()) for d in k2["paths"].values())
    assert total1 > 0
    assert total2 == total1 and k2 == k1
    # attention ran on its wrapper's plain version, once a layer a tick
    cfg = t_get_config(ARCH)
    assert k1["kernels"]["flash_paged_decode"]["plain_calls"] == cfg.num_layers * s1.ticks
    assert k1["paths"]["attn.paged"] == {"torch": cfg.num_layers * s1.ticks}


def _trace_shape(obj):
    """What a trace says, without wall-clock: each event's phase, name,
    process, thread and args (the modeled power, a rate over wall time,
    left out)."""
    out = []
    for ev in obj["traceEvents"]:
        args = ev.get("args")
        if ev["name"] == "modeled_power_mw":
            args = None
        out.append((ev["ph"], ev["name"], ev["pid"], ev["tid"], json.dumps(args)))
    return out


def test_tracing_changes_no_tokens_plain(model):
    params, tparams = model
    prompts = _prompts()
    _, out_off = _run(tparams, prompts=prompts)
    tr = Tracer()
    s_on, out_on = _run(tparams, prompts=prompts, tracer=tr, track_energy=True)
    assert out_on == out_off
    obj = tr.to_dict()
    validate_chrome_trace(obj)
    summ = trace_summary(obj)
    assert summ["request_tracks"] == len(prompts)
    names = {e["name"] for e in obj["traceEvents"] if e.get("ph") == "X"}
    for n in ("tick", "admit", "plan", "cow_drain", "device_step", "commit", "queued",
              "prefill", "decode"):
        assert n in names, f"missing span {n!r}"
    counters = {e["name"] for e in obj["traceEvents"] if e.get("ph") == "C"}
    assert {"pool_pages", "queue_depth", "ladder_level",
            "modeled_power_mw"} <= counters
    instants = {e["name"] for e in obj["traceEvents"] if e.get("ph") == "i"}
    assert {"submit", "admit", "finish"} <= instants
    # the reference's tracer records the same events, in the same order
    rtr = j_trace.Tracer()
    _, ref_out = _run(params, prompts=prompts, ref=True, tracer=rtr, track_energy=True)
    assert ref_out == out_on
    assert _trace_shape(obj) == _trace_shape(rtr.to_dict())


def test_tracing_changes_no_tokens_spec(model):
    """Speculative decoding (γ=2, an int2 draft) under a tracer: the same
    tokens as untraced, the draft, verify and device-step spans present,
    and the reference's tracer records the same events in the same order."""
    params, tparams = model
    prompts = _prompts(n=3)
    spec = dict(RC_KW, spec_gamma=2, draft_policy="*=int2")
    kw = dict(capacity=32, max_batch=3, temperature=0.0)

    def run(pkg, tracer=None):
        if pkg == "ref":
            s = JScheduler(get_config(ARCH), RunConfig(**spec), params, tracer=tracer, **kw)
            req = JRequest
        else:
            s = Scheduler(t_get_config(ARCH), TRunConfig(**spec), tparams, tracer=tracer,
                          device="cpu", **kw)
            req = Request
        for rid, p in enumerate(prompts):
            s.submit(req(rid=rid, prompt=list(p), max_new=6))
        s.run()
        return {r.rid: list(r.out) for r in s.finished}

    out_off = run("port")
    tr = Tracer()
    out_on = run("port", tr)
    assert out_on == out_off
    obj = tr.to_dict()
    validate_chrome_trace(obj)
    names = {e["name"] for e in obj["traceEvents"] if e.get("ph") == "X"}
    for n in ("draft", "verify", "device_step", "cow_drain", "mirror"):
        assert n in names, f"missing spec span {n!r}"
    rtr = j_trace.Tracer()
    assert run("ref", rtr) == out_on
    assert _trace_shape(obj) == _trace_shape(rtr.to_dict())


def test_registry_view_matches_legacy_counters(model):
    """The class-level counter properties and the registry are the same
    storage, and the port's exposition equals the reference's after the same
    serve, wall-clock histograms aside."""
    params, tparams = model
    s, out = _run(tparams, prompts=_prompts(n=2))
    snap = s.metrics.snapshot()
    toks = sum(len(v) for v in out.values())
    assert s.generated_tokens == toks
    assert snap["serve_generated_tokens_total"]["values"][""] == toks
    assert snap["serve_ticks_total"]["values"][""] == s.ticks
    assert snap["admission_submitted_total"]["values"][""] == 2
    prom = s.metrics.to_prometheus()
    for fam in ("serve_generated_tokens_total", "admission_submitted_total",
                "cache_pages", "serve_ttft_seconds"):
        assert fam in prom, f"{fam} missing from exposition"
    ref, _ = _run(params, prompts=_prompts(n=2), ref=True)

    def steady(text):
        return [l for l in text.splitlines() if not any(w in l for w in WALL)]

    assert steady(prom) == steady(ref.metrics.to_prometheus())
    assert sorted(snap) == sorted(ref.metrics.snapshot())


# ------------------------------------------------------------ profile scopes
def _one_step(tparams, impl="auto"):
    from repro_torch.models import init_caches

    cfg, rc = t_get_config(ARCH), TRunConfig(**RC_KW)
    caches = init_caches(cfg, rc, 2, 8, device="cpu")
    step = build_mixed_step(cfg, rc, impl=impl)
    tokens = torch.tensor([[1, 2, 3, 4], [5, 0, 0, 0]], dtype=torch.int32)
    pos = torch.zeros(2, dtype=torch.int32)
    lens = torch.tensor([4, 1], dtype=torch.int32)
    tables = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    return step(tparams, caches, tokens, pos, lens, tables)[1]


def _no_nvtx(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("NVTX touched on the CPU")

    monkeypatch.setattr(torch.cuda.nvtx, "range_push", boom)
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", boom)


def test_named_scope_ranges_in_cpu_profile(model, monkeypatch):
    """The step's ``serve/step`` and ``serve/logits`` ranges show up in a
    CPU ``torch.profiler`` run, the logits are those of the unprofiled
    step, and no NVTX call is made on the CPU."""
    _, tparams = model
    _no_nvtx(monkeypatch)
    want = _one_step(tparams)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = _one_step(tparams)
    assert torch.equal(got, want)
    names = {e.key for e in prof.key_averages()}
    assert {"serve/step", "serve/logits"} <= names
    with named_scope("plain"):   # usable outside any step, no profiler on
        pass


def test_device_trace_writes_chrome_trace(model, monkeypatch, tmp_path, caplog):
    """``device_trace`` profiles the block and writes a Chrome trace holding
    the step's ranges; when the profiler cannot start it warns once, yields
    None and the block still runs."""
    import repro_torch.obs.profile as prof_mod

    _, tparams = model
    _no_nvtx(monkeypatch)
    with device_trace(str(tmp_path / "dev")) as path:
        _one_step(tparams)
    assert path is not None
    events = json.loads(open(path).read())["traceEvents"]
    assert {"serve/step", "serve/logits"} <= {e.get("name") for e in events}
    with device_trace(None) as off:
        assert off is None

    def refuse(*a, **k):
        raise RuntimeError("profiler busy")

    monkeypatch.setattr(prof_mod, "_warned", False)
    monkeypatch.setattr(torch.profiler, "profile", refuse)
    ran = []
    for _ in range(2):
        with device_trace(str(tmp_path / "never")) as p:
            ran.append(p)
    assert ran == [None, None]
    assert sum("torch.profiler unavailable" in r.message for r in caplog.records) == 1
    assert not (tmp_path / "never").exists()
