"""Port parity for serving the archs after ``qwen3-0.6b_smoke``: the port's
chunked-prefill paged ``Scheduler`` (plain PyTorch versions on the CPU)
against the reference's on ``deepseek-v2-lite-16b_smoke`` (MLA + MoE: fused,
surgered and the unfused expert route), ``qwen2-vl-7b_smoke`` (M-RoPE),
``llama4-maverick-400b-a17b_smoke`` (interleaved top-1 MoE) and the three
dense archs, with the reference's weights carried across by
``repro_torch.interop``: greedy tokens, per-request ``cycles_by_bits`` and
final KV lengths identical. ``qwen3-0.6b_smoke``'s serves are in
``test_torch_serve.py``."""

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
from repro_torch.quant import apply_surgery as t_apply_surgery
from repro_torch.serve import Request, Scheduler

torch.set_float32_matmul_precision("highest")
RC_KW = dict(dtype="float32", param_dtype="float32", remat="none", prefill_chunk=5,
             kv_cache_dtype="int8", kv_layout="paged", block_size=4)


def _prompts(vocab, n=3):
    rng = np.random.default_rng(1)
    return [rng.integers(0, vocab, 4 + 2 * i).tolist() for i in range(n)]


# ------------------------------------------------------- the MLA + MoE slice
DS_ARCH = "deepseek-v2-lite-16b_smoke"


def _serve_both(policy, surgery: bool, arch: str = DS_ARCH):
    """The reference's and the port's Scheduler on ``arch`` (default
    deepseek-v2-lite-16b_smoke; paged, pages of 4, chunks of 5), the same
    weights and prompts."""
    cfg = get_config(arch)
    rc = RunConfig(quant_policy=policy, **RC_KW)
    params = j_init(cfg, rc, jax.random.PRNGKey(0))
    prompts = _prompts(cfg.vocab_size)
    ref = JScheduler(cfg, rc, j_apply_surgery(cfg, rc, params) if surgery else params,
                     capacity=32, max_batch=3, track_energy=True)
    for rid, p in enumerate(prompts):
        ref.submit(JRequest(rid=rid, prompt=list(p), max_new=3))
    ref_toks = {r.rid: r.out for r in ref.run()}

    tcfg, trc = t_get_config(arch), TRunConfig(quant_policy=policy, **RC_KW)
    tparams = params_from_reference(jax.tree.map(np.asarray, params), device="cpu")
    if surgery:
        tparams = t_apply_surgery(tcfg, trc, tparams)
    port = Scheduler(tcfg, trc, tparams, capacity=32, max_batch=3, track_energy=True,
                     device="cpu")
    for rid, p in enumerate(prompts):
        port.submit(Request(rid=rid, prompt=list(p), max_new=3))
    toks = {r.rid: r.out for r in port.run()}
    return ref, ref_toks, port, toks


@pytest.mark.parametrize("policy", ["mla.*=int8,*=int2",
                                    "mla.*=int8,moe.*=int2,mlp.*=int2,*=bf16"])
def test_mla_moe_greedy_tokens_and_cycles_match_reference(policy):
    """The slice's acceptance gate: greedy tokens and per-slot
    cycles_by_bits identical to the reference's scheduler."""
    ref, ref_toks, port, toks = _serve_both(policy, surgery=False)
    cyc = {e["rid"]: e["cycles_by_bits"] for e in port.energy_summary()}
    assert toks == ref_toks
    assert cyc == {e["rid"]: e["cycles_by_bits"] for e in ref.energy_summary()}
    assert port.cycles_by_bits == ref.cycles_by_bits
    assert all(set(c) == {8, 2} and min(c.values()) > 0 for c in cyc.values())
    assert port.final_kv_lens == ref.final_kv_lens
    # capacity drops reach the capture every tick; moe_dropped_tokens counts
    # only the mesh path's, 0 on one device as in the reference, and health()
    # reports the mesh as off, as the reference's does
    assert len(port.tick_dropped_tokens) == port.ticks and sum(port.tick_dropped_tokens) > 0
    assert port.moe_dropped_tokens == ref.moe_dropped_tokens == 0
    assert port.health()["mesh"] == ref.health()["mesh"] == {"enabled": False}
    port.mgr.check_invariants()


@pytest.mark.parametrize("policy", ["mla.*=int8,*=int2:prequant",
                                    "mla.*=int8,moe.*=int2:prequant,mlp.*=int2:prequant,*=bf16"])
def test_mla_moe_surgered_serving_matches_reference(policy):
    """The same gate after apply_surgery in both packages: the expert stacks
    served from packed (L, E, Kp, N) planes by the fused kernel."""
    ref, ref_toks, port, toks = _serve_both(policy, surgery=True)
    cyc = {e["rid"]: e["cycles_by_bits"] for e in port.energy_summary()}
    assert toks == ref_toks
    assert cyc == {e["rid"]: e["cycles_by_bits"] for e in ref.energy_summary()}
    assert port.cycles_by_bits == ref.cycles_by_bits
    assert all(set(c) == {8, 2} and min(c.values()) > 0 for c in cyc.values())
    assert port.final_kv_lens == ref.final_kv_lens


@pytest.mark.parametrize("surgery,policy,bits", [
    (False, "mla.*=int8,moe.*=int2:unfused,*=bf16", {8, 2}),
    (True, "mla.*=int8,moe.*=int2:prequant:unfused,*=bf16", {8}),
])
def test_mla_moe_unfused_experts_match_reference(surgery, policy, bits):
    """The unfused expert route in a serve: the expert GEMMs through the int8
    GEMM over all experts (dynamic) or the packed int2 GEMM over all experts
    (prequant, which records no cycles, as the reference's does): greedy
    tokens and per-request cycles_by_bits identical to the reference's."""
    ref, ref_toks, port, toks = _serve_both(policy, surgery)
    cyc = {e["rid"]: e["cycles_by_bits"] for e in port.energy_summary()}
    assert toks == ref_toks
    assert cyc == {e["rid"]: e["cycles_by_bits"] for e in ref.energy_summary()}
    assert port.cycles_by_bits == ref.cycles_by_bits
    assert all(set(c) == bits and min(c.values()) > 0 for c in cyc.values())
    assert port.final_kv_lens == ref.final_kv_lens


# ------------------------------------------ qwen2-vl's M-RoPE, llama4's MoE
QWEN2VL, LLAMA4 = "qwen2-vl-7b_smoke", "llama4-maverick-400b-a17b_smoke"
ARCH_POLICIES = {QWEN2VL: "attn.*=int8,mlp.*=int2,*=bf16",
                 LLAMA4: "attn.*=int8,mlp.*=int2,moe.*=int2,*=bf16"}


@pytest.mark.parametrize("surgery", [False, True])
@pytest.mark.parametrize("arch", [QWEN2VL, LLAMA4])
def test_new_archs_greedy_tokens_and_cycles_match_reference(arch, surgery):
    """qwen2-vl (the mixed step's (3, B, W) M-RoPE positions, t = h = w) and
    llama4 (a dense and an MoE layer alternating, top-1 over 4 experts and
    the shared expert), fused dynamic and after apply_surgery under the
    policy's prequant form: greedy tokens, per-request cycles_by_bits and
    final KV lengths identical to the reference's Scheduler."""
    policy = ARCH_POLICIES[arch]
    if surgery:
        policy = ",".join(r if r.endswith("bf16") else r + ":prequant"
                          for r in policy.split(","))
    ref, ref_toks, port, toks = _serve_both(policy, surgery, arch)
    cyc = {e["rid"]: e["cycles_by_bits"] for e in port.energy_summary()}
    assert toks == ref_toks
    assert cyc == {e["rid"]: e["cycles_by_bits"] for e in ref.energy_summary()}
    assert port.cycles_by_bits == ref.cycles_by_bits
    assert all(set(c) == {8, 2} and min(c.values()) > 0 for c in cyc.values())
    assert port.final_kv_lens == ref.final_kv_lens
    port.mgr.check_invariants()


# ------------------------------------------ the last three dense archs
DENSE_ARCHS = ["qwen3-8b_smoke", "qwen3-14b_smoke", "smollm-360m_smoke"]
DENSE_POLICY = "attn.*=int8,mlp.*=int2,*=bf16"


@pytest.mark.parametrize("surgery", [False, True])
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_dense_archs_greedy_tokens_and_cycles_match_reference(arch, surgery):
    """qwen3-8b (GQA group 2), qwen3-14b (one kv head for five q heads) and
    smollm-360m (tied embeddings, head_dim 20) on the dense GQA path, fused
    dynamic and after apply_surgery under the prequant form of the policy:
    greedy tokens, per-request cycles_by_bits and final KV lengths identical
    to the reference's Scheduler."""
    policy = DENSE_POLICY
    if surgery:
        policy = "attn.*=int8:prequant,mlp.*=int2:prequant,*=bf16"
    ref, ref_toks, port, toks = _serve_both(policy, surgery, arch)
    cyc = {e["rid"]: e["cycles_by_bits"] for e in port.energy_summary()}
    assert toks == ref_toks
    assert cyc == {e["rid"]: e["cycles_by_bits"] for e in ref.energy_summary()}
    assert port.cycles_by_bits == ref.cycles_by_bits
    assert all(set(c) == {8, 2} and min(c.values()) > 0 for c in cyc.values())
    assert port.final_kv_lens == ref.final_kv_lens
    port.mgr.check_invariants()
