"""Port parity: the no-cache ``blockwise_attention``'s backward (the
chunked-recompute ``_bwd_scan`` behind a ``torch.autograd.Function``)
against ``jax.grad`` of the reference's custom VJP, on the same numpy
inputs, in ``tests/test_flash.py``'s four cases (the logit softcap 8.0
among them) plus one where the KV length is no multiple of the chunk.

Tolerance: q/k/v gradients and the forward to ``rtol=atol=1e-5`` — f32 on
both sides; the frameworks order the chunk sums differently and their
exp/tanh differ in the last bit, nothing else.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.flash import blockwise_attention as j_attn
from repro_torch.models.flash import blockwise_attention as t_attn

torch.set_float32_matmul_precision("highest")
TOL = dict(rtol=1e-5, atol=1e-5)

CASES = [
    dict(causal=True, window=None, softcap=None, H=4, KV=2, S=17, chunk=4),
    dict(causal=True, window=5, softcap=None, H=4, KV=4, S=17, chunk=4),
    dict(causal=False, window=None, softcap=None, H=2, KV=1, S=17, chunk=4),
    dict(causal=True, window=None, softcap=8.0, H=4, KV=2, S=17, chunk=4),
    # Skv % chunk != 0 with every option on: 21 = 2 chunks of 8 + 5 padded
    dict(causal=True, window=6, softcap=5.0, H=6, KV=2, S=21, chunk=8),
]


def _inputs(case, seed=1, hd=8, B=2):
    rng = np.random.default_rng(seed)
    S = case["S"]
    q = rng.standard_normal((B, S, case["H"], hd)).astype(np.float32)
    k = rng.standard_normal((B, S, case["KV"], hd)).astype(np.float32)
    v = rng.standard_normal((B, S, case["KV"], hd)).astype(np.float32)
    ct = rng.standard_normal((B, S, case["H"], hd)).astype(np.float32)
    return q, k, v, ct


def _opts(case):
    return dict(causal=case["causal"], window=case["window"], softcap=case["softcap"],
                chunk=case["chunk"])


def _grads(case, q, k, v, ct):
    def f(q, k, v):
        return (j_attn(q, k, v, **_opts(case)) * ct).sum()

    out = j_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **_opts(case))
    g = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    tout = t_attn(tq, tk, tv, **_opts(case))
    tg = torch.autograd.grad((tout * torch.from_numpy(ct)).sum(), (tq, tk, tv))
    return np.asarray(out), tout.detach().numpy(), [np.asarray(a) for a in g], \
        [a.numpy() for a in tg]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"H{c['H']}KV{c['KV']}S{c['S']}"
                         f"c{c['chunk']}w{c['window']}sc{c['softcap']}causal{c['causal']}")
def test_backward_matches_reference(case):
    out, tout, g, tg = _grads(case, *_inputs(case))
    np.testing.assert_allclose(tout, out, **TOL)
    for a, b, name in zip(tg, g, "qkv"):
        np.testing.assert_allclose(a, b, **TOL, err_msg=f"d{name} ({case})")


def test_softcap_changes_the_gradient():
    """The softcap reaches the backward: a capped and an uncapped run on the
    same inputs differ, and each matches its own reference."""
    base = dict(CASES[3], softcap=None)
    _, _, _, g_plain = _grads(base, *_inputs(base))
    _, _, _, g_cap = _grads(CASES[3], *_inputs(CASES[3]))
    assert np.abs(g_plain[0] - g_cap[0]).max() > 1e-3


def test_backward_saves_no_score_tensor():
    """Only q, k, v, out and the log-sum-exp are saved for the backward: no
    (Sq, Skv)-sized probability or score tensor outlives its chunk."""
    case = CASES[4]
    q, k, v, _ = _inputs(case)
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = t_attn(tq, tk, tv, **_opts(case))
    B, S, H, hd = q.shape
    assert sorted(saved) == sorted([q.shape, k.shape, v.shape, out.shape, (B, H, S)])


def test_cached_path_is_not_the_trainable_route():
    """With a cache length (or an offset) the forward is the plain scan, as
    the reference's: the no-cache Function is taken only when ``kv_len`` is
    None and ``q_offset`` is 0. Both give the same forward values."""
    case = CASES[0]
    q, k, v, _ = _inputs(case)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    a = t_attn(tq, tk, tv, chunk=4)
    b = t_attn(tq, tk, tv, kv_len=case["S"], chunk=4)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert t_attn(tq.requires_grad_(True), tk, tv, chunk=4).grad_fn.name().endswith(
        "TrainableAttentionBackward")


def test_bf16_backward_dtypes():
    """bf16 inputs: the backward runs in f32 and returns each gradient in its
    input's dtype, close to the f32 run's."""
    case = CASES[3]
    q, k, v, ct = _inputs(case)
    ts = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True) for a in (q, k, v)]
    out = t_attn(*ts, **_opts(case))
    g = torch.autograd.grad((out.float() * torch.from_numpy(ct)).sum(), ts)
    assert all(x.dtype == torch.bfloat16 for x in (out, *g))
    _, _, _, g32 = _grads(case, q, k, v, ct)
    for a, b in zip(g, g32):
        assert np.linalg.norm(a.float().numpy() - b) / np.linalg.norm(b) < 2e-2
