"""The compiled serving steps on the card: a Scheduler whose mixed, verify
and draft steps replay CUDA graphs (``serve/graphs.py``) against the same
Scheduler stepping eagerly, bit for bit — greedy tokens, KV lengths,
``cycles_by_bits`` per request and in total, the MoE drops a tick and the
kernel counters — on small configs through the kernels: ``qwen3-0.6b_smoke``
(paged and dense layouts, a prefix-cached serve, a γ=2 speculative serve)
and ``deepseek-v2-lite-16b_smoke`` (MLA + MoE). The launches a graphed
serve credits on its replays are the kernels ``torch.profiler`` sees the
card run. A step that waits for the card inside its capture raises. Marked ``gpu``; without a CUDA card each
test skips with its reason. On a machine with one::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_step_graphs.py
"""

import numpy as np
import pytest
import torch

from repro_torch.configs.base import RunConfig, get_config
from repro_torch.kernels import ops
from repro_torch.models import init
from repro_torch.quant import apply_surgery
from repro_torch.serve import Request, Scheduler
from repro_torch.serve import graphs

pytestmark = pytest.mark.gpu

RC_KW = dict(dtype="bfloat16", param_dtype="bfloat16", remat="none", prefill_chunk=8,
             kv_cache_dtype="int8", kv_layout="paged", block_size=16)
QWEN_POLICY = "attn.*=int8,mlp.*=int2,*=bf16"
CASES = {
    "qwen_fused": ("qwen3-0.6b_smoke", dict(quant_policy=QWEN_POLICY)),
    "qwen_packed": ("qwen3-0.6b_smoke",
                    dict(quant_policy="attn.*=int8,mlp.*=int2:prequant,*=bf16")),
    "qwen_dense": ("qwen3-0.6b_smoke", dict(quant_policy=QWEN_POLICY, kv_layout="dense")),
    "qwen_prefix": ("qwen3-0.6b_smoke", dict(quant_policy=QWEN_POLICY, prefix_cache=True)),
    "qwen_spec": ("qwen3-0.6b_smoke",
                  dict(quant_policy="attn.*=int8:per_token,mlp.*=int2:per_token,*=bf16",
                       spec_gamma=2)),
    "deepseek": ("deepseek-v2-lite-16b_smoke",
                 dict(quant_policy="mla.*=int8,moe.*=int2,mlp.*=int2,*=bf16")),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    return torch.device("cuda")


def _serve(cfg, rc, params, prompts, graphed: bool):
    s = Scheduler(cfg, rc, params, capacity=128, max_batch=4, track_energy=True,
                  device="cuda", graphs=graphed)
    torch.cuda.synchronize()
    base = ops.kernel_counters()
    for rid, p in enumerate(prompts):
        s.submit(Request(rid=rid, prompt=p, max_new=12))
        if rc.prefix_cache and rid == 0:
            s.run()                       # the others fork its prefix
    s.run()
    torch.cuda.synchronize()
    return s, ops.kernel_counters_since(base)


def _case(case):
    """(cfg, rc, params on the card, 6 prompts) of ``CASES[case]``."""
    arch, kw = CASES[case]
    cfg = get_config(arch)
    rc = RunConfig(**dict(RC_KW, **kw))
    params = apply_surgery(cfg, rc, init(cfg, rc, torch.Generator().manual_seed(0),
                                         device="cuda"))
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab_size, 40).tolist()
    prompts = [(shared if rc.prefix_cache else []) +
               rng.integers(0, cfg.vocab_size, int(rng.integers(5, 40))).tolist()
               for _ in range(6)]
    return cfg, rc, params, prompts


@pytest.mark.parametrize("case", list(CASES))
def test_graphed_serve_equals_eager(cuda, case):
    cfg, rc, params, prompts = _case(case)
    arch = cfg.name
    eager, ek = _serve(cfg, rc, params, prompts, graphed=False)
    graphed, gk = _serve(cfg, rc, params, prompts, graphed=True)
    out = lambda s: {r.rid: list(r.out) for r in s.finished}
    energy = lambda s: {e["rid"]: (e["cycles_by_bits"], e.get("draft_cycles_by_bits"))
                        for e in s.energy_summary()}
    assert out(graphed) == out(eager) and len(out(eager)) == len(prompts)
    assert graphed.final_kv_lens == eager.final_kv_lens
    assert graphed.cycles_by_bits == eager.cycles_by_bits
    assert energy(graphed) == energy(eager) and all(c for c, _ in energy(eager).values())
    assert graphed.tick_dropped_tokens == eager.tick_dropped_tokens
    assert gk == ek
    for k in ("ticks", "drafted_tokens", "accepted_draft_tokens", "prefix_hits"):
        assert getattr(graphed, k) == getattr(eager, k), k
    counts = graphed.step_counts()
    assert counts and all(c["eager"] == 1 for r in counts.values() for c in r.values())
    assert sum(c["replays"] for r in counts.values() for c in r.values()) > 0
    assert all(c["pool_bytes"] >= 0 for r in counts.values() for c in r.values()
               if "pool_bytes" in c)
    if arch.startswith("deepseek"):
        assert sum(graphed.tick_dropped_tokens) > 0
    if rc.prefix_cache:
        assert graphed.prefix_hits > 0
    if rc.spec_gamma:
        assert graphed.drafted_tokens > 0 and set(counts) == {"verify", "draft"}


@pytest.mark.parametrize("case", ["qwen_fused", "qwen_spec"])
def test_replayed_kernels_are_the_credited_launches(cuda, case):
    """The launches a graphed serve credits on each replay are kernels the
    card ran: the profiler's device events of the fused GEMM, attention and
    stats kernels, counted by name, equal the wrappers' counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg, rc, params, prompts = _case(case)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        s, counts = _serve(cfg, rc, params, prompts, graphed=True)
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    launched = {k: c["launches"] for k, c in counts["kernels"].items() if c.get("launches")}
    assert set(launched) == {"tugemm_fused", "flash_paged_decode", "tugemm_stats"}
    for wrapper, kernel in (("tugemm_fused", "tugemm::gemm_kernel<"),
                            ("flash_paged_decode", "flash_split_kernel<"),
                            ("tugemm_stats", "finish_kernel<")):
        assert sum(kernel in n for n in names) == launched[wrapper], wrapper
    assert sum(c["replays"] for r in s.step_counts().values() for c in r.values()) > 0


def test_a_sync_inside_the_capture_raises(cuda):
    """The first call runs eagerly; the second captures, and a step that
    waits for the card inside its capture raises (no quiet eager run)."""

    def step(params, caches, tokens, pos, lens, tables):
        n = int(lens.sum().item())          # a host wait: not capturable
        return caches, tokens.to(torch.float32) + n

    r = graphs.StepGraphs(step, name="syncing", device=cuda, rows=2, table_width=3,
                          backend=graphs.CudaGraph, pool=torch.cuda.graph_pool_handle())
    args = (np.ones((2, 4), np.int32), np.zeros(2, np.int32), np.ones(2, np.int32),
            np.zeros((2, 3), np.int32))
    caches = ({"kv": torch.zeros(1, device=cuda)},)
    _, logits, _ = r({}, caches, *args)
    assert torch.equal(logits.cpu(), torch.full((2, 4), 3.0))
    with pytest.raises(RuntimeError, match="syncing step's graph at width 4"):
        r({}, caches, *args)
