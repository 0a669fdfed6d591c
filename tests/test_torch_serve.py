"""Port parity for serving: the port's chunked-prefill paged ``Scheduler``
(plain PyTorch versions on the CPU) against the reference's on
``qwen3-0.6b_smoke``, reference weights carried across by
``repro_torch.interop``. Greedy tokens and per-request ``cycles_by_bits``
must be identical.

The MLA + MoE arch and the later archs' serves are in
``test_torch_serve_archs.py``. The same holds for the slice's second
serving path: offline-prequantized
weights (``apply_surgery`` in both packages) served through the legacy
unfused pipeline, and through the fused kernel on packed weights. Under
pool pressure the port's degradation ladder takes the reference's
transitions, so ticks, tokens and final KV lengths agree there too.

Two port-only properties follow: recompute-preemption under pool pressure
changes the schedule but not the tokens, and temperature > 0 draws are keyed
by (seed, rid, position) so they do not depend on the schedule either. Both
use per-token activation scales, which make every row's numbers independent
of what it is batched with (with per-tensor scales a row's quantization
depends on its co-batched rows, so a different schedule is a different
computation)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig, get_config
from repro.models import init as j_init
from repro.quant import apply_surgery as j_apply_surgery
from repro.serve import Request as JRequest
from repro.serve import Scheduler as JScheduler
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import get_config as t_get_config
from repro_torch.interop import params_from_reference
from repro_torch.models import init as t_init
from repro_torch.quant import apply_surgery as t_apply_surgery
from repro_torch.serve import Request, Scheduler

torch.set_float32_matmul_precision("highest")
ARCH = "qwen3-0.6b_smoke"
POLICY = "attn.*=int8,mlp.*=int2,*=bf16"
RC_KW = dict(dtype="float32", param_dtype="float32", remat="none", prefill_chunk=5,
             kv_cache_dtype="int8", kv_layout="paged", block_size=4)


def _prompts(vocab, n=3):
    rng = np.random.default_rng(1)
    return [rng.integers(0, vocab, 4 + 2 * i).tolist() for i in range(n)]


def _run_port(params, prompts, *, policy=POLICY, max_new=3, max_batch=3, capacity=32, **kw):
    rc = TRunConfig(quant_policy=policy, **RC_KW)
    s = Scheduler(t_get_config(ARCH), rc, params, capacity=capacity, max_batch=max_batch,
                  device="cpu", **kw)
    for rid, p in enumerate(prompts):
        s.submit(Request(rid=rid, prompt=list(p), max_new=max_new))
    done = s.run()
    return s, {r.rid: r.out for r in done}


def test_greedy_tokens_and_cycles_match_reference():
    cfg = get_config(ARCH)
    rc = RunConfig(quant_policy=POLICY, **RC_KW)
    params = j_init(cfg, rc, jax.random.PRNGKey(0))
    prompts = _prompts(cfg.vocab_size)

    ref = JScheduler(cfg, rc, params, capacity=32, max_batch=3, track_energy=True)
    for rid, p in enumerate(prompts):
        ref.submit(JRequest(rid=rid, prompt=list(p), max_new=3))
    ref_toks = {r.rid: r.out for r in ref.run()}
    ref_cyc = {e["rid"]: e["cycles_by_bits"] for e in ref.energy_summary()}

    tparams = params_from_reference(jax.tree.map(np.asarray, params), device="cpu")
    port, toks = _run_port(tparams, prompts, track_energy=True)
    cyc = {e["rid"]: e["cycles_by_bits"] for e in port.energy_summary()}

    assert toks == ref_toks
    assert cyc == ref_cyc
    assert all(set(c) == {8, 2} and min(c.values()) > 0 for c in cyc.values())
    assert port.final_kv_lens == ref.final_kv_lens
    port.mgr.check_invariants()


@pytest.mark.parametrize("policy,bits", [
    ("attn.*=int8:unfused,mlp.*=int2:prequant:unfused,*=bf16", {8}),
    ("attn.*=int8,mlp.*=int2:prequant,*=bf16", {8, 2}),
])
def test_surgered_serving_matches_reference(policy, bits):
    """apply_surgery -> Scheduler in both packages. The unfused prequant
    path pushes no capture (the reference's legacy behaviour), so the slice
    policy's cycles hold only the int8 attention GEMMs."""
    cfg = get_config(ARCH)
    rc = RunConfig(quant_policy=policy, **RC_KW)
    params = j_init(cfg, rc, jax.random.PRNGKey(0))
    prompts = _prompts(cfg.vocab_size)

    ref = JScheduler(cfg, rc, j_apply_surgery(cfg, rc, params), capacity=32, max_batch=3,
                     track_energy=True)
    for rid, p in enumerate(prompts):
        ref.submit(JRequest(rid=rid, prompt=list(p), max_new=3))
    ref_toks = {r.rid: r.out for r in ref.run()}
    ref_cyc = {e["rid"]: e["cycles_by_bits"] for e in ref.energy_summary()}

    trc = TRunConfig(quant_policy=policy, **RC_KW)
    tparams = params_from_reference(jax.tree.map(np.asarray, params), device="cpu")
    port = Scheduler(t_get_config(ARCH), trc, t_apply_surgery(t_get_config(ARCH), trc, tparams),
                     capacity=32, max_batch=3, track_energy=True, device="cpu")
    for rid, p in enumerate(prompts):
        port.submit(Request(rid=rid, prompt=list(p), max_new=3))
    toks = {r.rid: r.out for r in port.run()}
    cyc = {e["rid"]: e["cycles_by_bits"] for e in port.energy_summary()}

    assert toks == ref_toks
    assert cyc == ref_cyc
    assert port.cycles_by_bits == ref.cycles_by_bits
    assert all(set(c) == bits and min(c.values()) > 0 for c in cyc.values())
    assert port.final_kv_lens == ref.final_kv_lens


def test_degradation_ladder_matches_reference_under_pool_pressure():
    """4 rows, prompts of 12-24 tokens in chunks of 5, 10 pages of 4 tokens:
    preemptions lift the ladder to ``preempt``, where the prefill share of a
    tick shrinks to one chunk. Per-tensor scales, so the tokens depend on
    the schedule as well."""
    cfg = get_config(ARCH)
    rc = RunConfig(quant_policy=POLICY, **RC_KW)
    params = j_init(cfg, rc, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(12, 25))).tolist()
               for _ in range(4)]
    kw = dict(capacity=40, max_batch=4, num_pages=10)

    ref = JScheduler(cfg, rc, params, **kw)
    for rid, p in enumerate(prompts):
        ref.submit(JRequest(rid=rid, prompt=list(p), max_new=4))
    ref_toks = {r.rid: r.out for r in ref.run()}

    tparams = params_from_reference(jax.tree.map(np.asarray, params), device="cpu")
    port, toks = _run_port(tparams, prompts, max_new=4, **kw)
    assert port.preemptions == ref.preemptions > 0
    assert port.ladder.transitions == ref.ladder.transitions
    assert any(t["to"] == "preempt" for t in port.ladder.transitions)
    assert port.ladder.snapshot()["occupancy"] == ref.ladder.snapshot()["occupancy"]
    assert (port.ticks, port.clock) == (ref.ticks, ref.clock)
    assert toks == ref_toks
    assert port.final_kv_lens == ref.final_kv_lens
    port.mgr.check_invariants()


PER_TOKEN = "attn.*=int8:per_token,mlp.*=int2:per_token,*=bf16"


@pytest.fixture(scope="module")
def port_params():
    cfg = t_get_config(ARCH)
    return t_init(cfg, TRunConfig(**RC_KW), torch.Generator().manual_seed(0), device="cpu")


def test_preemption_under_pool_pressure_keeps_tokens(port_params):
    prompts = _prompts(256, n=4)
    base, want = _run_port(port_params, prompts, policy=PER_TOKEN, max_new=6)
    # 6 pages of 4 tokens cannot hold three sequences of up to 16 tokens
    tight, got = _run_port(port_params, prompts, policy=PER_TOKEN, max_new=6, num_pages=6)
    assert base.preemptions == 0 and tight.preemptions > 0
    assert got == want
    assert all(len(v) == 6 for v in got.values())
    tight.mgr.check_invariants()
    assert tight.mgr.pages_in_use == 0


def test_temperature_draws_are_schedule_invariant(port_params):
    prompts = _prompts(256, n=3)
    kw = dict(policy=PER_TOKEN, max_new=5, temperature=0.8, seed=3)
    _, wide = _run_port(port_params, prompts, max_batch=3, **kw)
    _, narrow = _run_port(port_params, prompts, max_batch=1, **kw)
    _, greedy = _run_port(port_params, prompts, policy=PER_TOKEN, max_new=5)
    assert wide == narrow
    assert wide != greedy        # the draws are not argmax in disguise


def test_unported_features_raise(port_params):
    cfg = t_get_config(ARCH)
    # the dense layout is ported (tests/test_torch_dense_layout.py); prefix
    # caching there is refused, as the reference refuses it
    rc = dataclasses.replace(TRunConfig(**RC_KW), kv_layout="dense", prefix_cache=True)
    with pytest.raises(ValueError, match="prefix_cache"):
        Scheduler(cfg, rc, port_params, capacity=32, max_batch=2, device="cpu")
    # an encoder-only config (hubert-xlarge) has no decode step to serve: the
    # Scheduler refuses it (the reference does not check; ROADMAP C)
    with pytest.raises(ValueError, match="encoder-only"):
        Scheduler(t_get_config("hubert-xlarge_smoke"), TRunConfig(**RC_KW), port_params,
                  capacity=32, max_batch=2, device="cpu")
    # SSM stacks serve through the Engine
    with pytest.raises(NotImplementedError, match="legacy Engine"):
        Scheduler(t_get_config("qwen3-0.6b_smoke").replace(family="ssm"),
                  TRunConfig(**RC_KW), port_params, capacity=32, max_batch=2, device="cpu")
    # the encoder flag alone is refused, whatever else the config holds
    with pytest.raises(ValueError, match="encoder-only"):
        Scheduler(cfg.replace(is_encoder=True, causal=False), TRunConfig(**RC_KW), port_params,
                  capacity=32, max_batch=2, device="cpu")
