"""Port parity for the last three archs' model paths, the counterpart of
the reference's ``tests/test_arch_smoke.py`` on ``hubert-xlarge_smoke``
(the audio encoder: a 512-wide stub frontend, non-causal attention, the
gelu MLP), ``qwen2-vl-7b_smoke`` (M-RoPE over (t, h, w) positions) and
``llama4-maverick-400b-a17b_smoke`` (a dense and an MoE layer alternating,
128 experts top-1 at full width, 4 here, plus a shared expert): the same
seeded numpy inputs through the reference's ``forward`` and the port's,
the reference's weights carried across by ``repro_torch.interop``.

Tolerances, all f32 (``float32_matmul_precision("highest")``): hidden
states and logits ``atol=rtol=2e-5`` — the frameworks order sums
differently, their exp/sin/cos/rsqrt/tanh differ in the last bits, and
the gelu is evaluated in another op order (``jax.nn.gelu`` and
``F.gelu(approximate="tanh")`` agree within 2 ulp of max(|x|, 1), held
exactly below). llama4's top-1 router ids equal the reference's, and
under a quantized policy every per-bitwidth cycle total is identical: no
code may flip."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import repro.models.transformer as j_transformer
from repro.configs.archs import ASSIGNED as J_ASSIGNED
from repro.configs.base import RunConfig, get_config
from repro.models import forward as j_forward
from repro.models import init as j_init
from repro.models import init_caches as j_init_caches
from repro.models import lm_logits as j_lm_logits
from repro.models.layers import apply_mrope as j_apply_mrope
from repro.models.layers import mlp as j_mlp
from repro.quant import apply_surgery as j_apply_surgery
from repro.quant.capture import tree_totals_by_bits as j_totals
from repro.quant.qlinear import GemmBackend as JBackend
from repro.quant.qlinear import dense as j_dense
from repro.quant.surgery import forward_with_stats as j_forward_with_stats
from repro_torch.configs.archs import ASSIGNED
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import get_config as t_get_config
from repro_torch.interop import flat_leaves, params_from_reference
from repro_torch.models import forward, init, init_caches, input_batch, lm_logits, moe
from repro_torch.models.layers import apply_mrope, apply_rope
from repro_torch.models.layers import mlp as t_mlp
from repro_torch.quant import QBits
from repro_torch.quant import apply_surgery as t_apply_surgery
from repro_torch.quant.capture import tree_totals_by_bits as t_totals
from repro_torch.quant.qlinear import GemmBackend as TBackend
from repro_torch.quant.surgery import forward_with_stats as t_forward_with_stats

torch.set_float32_matmul_precision("highest")
HUBERT, QWEN2VL, LLAMA4 = ("hubert-xlarge_smoke", "qwen2-vl-7b_smoke",
                           "llama4-maverick-400b-a17b_smoke")
ARCHS = [HUBERT, QWEN2VL, LLAMA4]
RC_KW = dict(dtype="float32", param_dtype="float32", remat="none", scan_layers=False)
TOL = dict(atol=2e-5, rtol=2e-5)
B, S = 2, 12
# the slice's mixed policy, with the GEMMs each arch adds quantized too
POLICIES = {HUBERT: "frontend=int8,attn.*=int8,mlp.*=int2,*=bf16",
            QWEN2VL: "attn.*=int8,mlp.*=int2,*=bf16",
            LLAMA4: "attn.*=int8,mlp.*=int2,moe.*=int2,*=bf16"}


def _weights(arch, policy=None, seed=0):
    rc = RunConfig(quant_policy=policy, **RC_KW) if policy else RunConfig(**RC_KW)
    params = j_init(get_config(arch), rc, jax.random.PRNGKey(seed))
    return params, params_from_reference(jax.tree.map(np.asarray, params), device="cpu")


def _inputs(arch, seed=1):
    """numpy inputs: 512-d frames for hubert, tokens otherwise; qwen2-vl
    with distinct random (t, h, w) positions (3, B, S)."""
    cfg = get_config(arch)
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        return {"embeds": rng.standard_normal((B, S, 512)).astype(np.float32)}
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.mrope_sections is not None:
        batch["positions"] = rng.integers(0, 40, (3, B, S)).astype(np.int32)
    return batch


def _batches(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v)
             for k, v in batch.items()})


def _reference_router_ids(monkeypatch):
    """Record the reference's top-k router ids per MoE call (the reference
    runs eagerly here: no jit, no scan)."""
    ids = []
    orig = j_transformer.moe_ffn

    def recording(cfg, p, x, *, backend):
        logits = j_dense(p["router"], x, backend=JBackend("bf16"), name="moe.router")
        probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
        ids.append(np.asarray(jax.lax.top_k(probs, cfg.num_experts_per_tok)[1]))
        return orig(cfg, p, x, backend=backend)

    monkeypatch.setattr(j_transformer, "moe_ffn", recording)
    return ids


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, quant, monkeypatch):
    """Hidden states and logits within TOL; llama4's router ids equal; under
    the arch's mixed policy the per-bitwidth cycle totals are identical."""
    policy = POLICIES[arch] if quant else None
    params, tparams = _weights(arch, policy)
    cfg, tcfg = get_config(arch), t_get_config(arch)
    rc = RunConfig(quant_policy=policy, **RC_KW) if policy else RunConfig(**RC_KW)
    trc = TRunConfig(quant_policy=policy, **RC_KW) if policy else TRunConfig(**RC_KW)
    jb, tb = _batches(_inputs(arch))
    jids = _reference_router_ids(monkeypatch)
    jh, _, jaux, tree = j_forward_with_stats(cfg, rc, params, jb)
    jlog = j_lm_logits(cfg, rc, params, jh)
    with moe.routing() as tids:
        th, _, taux, cap = t_forward_with_stats(tcfg, trc, tparams, tb, caches=None,
                                                cache_pos=None, kv_view=None)
    tlog = lm_logits(tcfg, trc, tparams, th)
    assert th.shape == (B, S, cfg.d_model) and tlog.shape == (B, S, cfg.vocab_size)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-6, atol=1e-7)
    assert len(tids) == len(jids) == (2 if arch == LLAMA4 else 0)
    for t, j in zip(tids, jids):
        np.testing.assert_array_equal(t.numpy(), j)
    assert t_totals(cap) == j_totals(tree)
    if quant:
        bits = {8, 2}
        assert set(t_totals(cap)) == bits and min(
            v["serial_cycles"] for v in t_totals(cap).values()) > 0
        names = {e.name for e in cap.entries}
        assert ("frontend" in names) == (arch == HUBERT)
        assert ("moe.gate" in names) == (arch == LLAMA4)


@pytest.mark.parametrize("arch", [QWEN2VL, LLAMA4])
def test_prefill_then_decode_matches_reference(arch):
    """S tokens prefilled into dense caches, then one decode token at
    position S (qwen2-vl: (t, h, w) = (S, S, S)): the decode hidden state
    within TOL of the reference's."""
    params, tparams = _weights(arch, seed=2)
    cfg, tcfg = get_config(arch), t_get_config(arch)
    rc, trc = RunConfig(**RC_KW), TRunConfig(**RC_KW)
    jb, tb = _batches(_inputs(arch, seed=3))
    jc = j_init_caches(cfg, rc, B, S + 4)
    tc = init_caches(tcfg, trc, B, S + 4, device="cpu")
    jh, jc, _ = j_forward(cfg, rc, params, jb, caches=jc, cache_pos=0)
    th, tc, _ = forward(tcfg, trc, tparams, tb, caches=tc, cache_pos=0)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    tok = np.array([[5], [7]], np.int32)
    jstep = {"tokens": jnp.asarray(tok)}
    if cfg.mrope_sections is not None:
        p = jnp.full((B, 1), S, jnp.int32)
        jstep["positions"] = jnp.stack([p, p, p])
    jh1, _, _ = j_forward(cfg, rc, params, jstep, caches=jc, cache_pos=S)
    th1, _, _ = forward(tcfg, trc, tparams, input_batch(tcfg, torch.from_numpy(tok).long(), S),
                        caches=tc, cache_pos=S)
    assert th1.shape == (B, 1, cfg.d_model) and th1.isfinite().all()
    np.testing.assert_allclose(th1.numpy(), np.asarray(jh1), **TOL)


def test_apply_mrope_matches_reference():
    """M-RoPE on distinct (t, h, w) positions against the reference's
    (sin/cos differ in the last bit: 1e-6), and the sections really split
    the frequency slots (not RoPE on any one of the three)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, S, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 200, (3, B, S))
    got = apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6, (2, 3, 3))
    want = j_apply_mrope(jnp.asarray(x), jnp.asarray(pos, jnp.int32), 1e6, (2, 3, 3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-6)
    for i in range(3):
        one = apply_rope(torch.from_numpy(x), torch.from_numpy(pos[i]), 1e6)
        assert not torch.allclose(one, got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mrope_with_equal_positions_is_rope_bit_for_bit(dtype):
    """t = h = w: every M-RoPE angle is the product RoPE takes, so the two
    agree bit for bit (qwen2-vl's text stream)."""
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((B, S, 4, 128))
                         .astype(np.float32)).to(dtype)
    p = torch.from_numpy(np.random.default_rng(6).integers(0, 4096, (B, S)))
    got = apply_mrope(x, torch.stack([p, p, p]), 1e6, (16, 24, 24))
    assert torch.equal(got, apply_rope(x, p, 1e6))


def test_gelu_mlp_matches_reference():
    """The gelu MLP (biased up and down) against the reference's: the gelu
    itself within 2 ulp of max(|x|, 1), the layer within TOL."""
    rng = np.random.default_rng(7)
    d, ff = 64, 128
    p = {"w_up": {"kernel": (rng.standard_normal((d, ff)) * 0.2).astype(np.float32),
                  "bias": rng.standard_normal(ff).astype(np.float32)},
         "w_down": {"kernel": (rng.standard_normal((ff, d)) * 0.2).astype(np.float32),
                    "bias": rng.standard_normal(d).astype(np.float32)}}
    x = rng.standard_normal((B, S, d)).astype(np.float32) * 2
    u = (rng.standard_normal(100_000) * 4).astype(np.float32)
    g = F.gelu(torch.from_numpy(u), approximate="tanh").numpy()
    jg = np.asarray(jax.nn.gelu(jnp.asarray(u)))
    assert (np.abs(g - jg) <= 2 * np.spacing(np.maximum(np.abs(u), np.float32(1)))).all()
    want = j_mlp(jax.tree.map(jnp.asarray, p), jnp.asarray(x), "gelu", backend=JBackend("bf16"))
    got = t_mlp(params_from_reference(p, device="cpu"), torch.from_numpy(x), "gelu",
                backend=TBackend("bf16"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_converted_params_have_the_port_init_structure(arch):
    """``params_from_reference`` on the reference's init gives the port's
    init tree: the same paths (``frontend_proj`` and the gelu MLP's biases
    for hubert, llama4's period-2 groups of a dense and an MoE layer), the
    same shapes and dtypes."""
    _, tparams = _weights(arch)
    port = init(t_get_config(arch), TRunConfig(**RC_KW), device="cpu")
    got, want = flat_leaves(tparams), flat_leaves(port)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
    if arch == HUBERT:
        assert "frontend_proj.bias" in want and "embed.embedding" not in want
        assert "groups.0.k0.ffn.w_up.bias" in want and "groups.0.k0.ffn.w_gate.kernel" not in want
    if arch == LLAMA4:
        assert len(port["groups"]) == 1 and set(port["groups"][0]) == {"k0", "k1"}
        assert "groups.0.k1.ffn.experts.w_gate" in want
        assert "groups.0.k1.ffn.shared.w_down.kernel" in want


@pytest.mark.parametrize("arch", ARCHS)
def test_surgery_matches_reference(arch):
    """``apply_surgery`` under the arch's mixed policy in prequant mode: the
    port's tree byte for byte the reference's — hubert's ``frontend_proj``
    and its gelu MLP's ``up`` / ``down`` packed with their biases riding
    along, llama4's experts and ``moe.shared.*`` leaves on its MoE layers."""
    policy = ",".join(r if r.endswith("bf16") else r + ":prequant"
                      for r in POLICIES[arch].split(","))
    params, tparams = _weights(arch, policy)
    cfg, tcfg = get_config(arch), t_get_config(arch)
    jtree = j_apply_surgery(cfg, RunConfig(quant_policy=policy, **RC_KW), params)
    ttree = t_apply_surgery(tcfg, TRunConfig(quant_policy=policy, **RC_KW), tparams)
    want = flat_leaves(jax.tree.map(np.asarray, jtree))
    got = flat_leaves(ttree)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert (got[k] == v) if isinstance(v, QBits) else np.array_equal(got[k], v), k
    packed = {k for k in got if k.endswith(".qkernel")}
    expect = {HUBERT: {"frontend_proj.qkernel", "groups.0.k0.ffn.w_up.qkernel"},
              QWEN2VL: {"groups.0.k0.attn.wq.qkernel"},
              LLAMA4: {"groups.0.k1.ffn.experts.w_gate.qkernel",
                       "groups.0.k1.ffn.shared.w_up.qkernel"}}[arch]
    assert expect <= packed
    if arch == HUBERT:
        assert "frontend_proj.bias" in got and "groups.0.k0.ffn.w_down.bias" in got


@pytest.mark.parametrize("arch", ["hubert-xlarge", "qwen2-vl-7b", "llama4-maverick-400b-a17b",
                                  "qwen3-8b", "qwen3-14b", "smollm-360m"])
def test_configs_are_the_reference_configs(arch):
    """The port's copies of the config modules, full and smoke, equal the
    reference's field for field; ``ASSIGNED`` holds the reference's ten
    archs in the reference's order."""
    assert ASSIGNED == J_ASSIGNED
    assert len(ASSIGNED) == 10
    for name in (arch, arch + "_smoke"):
        assert dataclasses.asdict(t_get_config(name)) == dataclasses.asdict(get_config(name))
