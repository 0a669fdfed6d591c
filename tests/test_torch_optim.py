"""Port parity for ``repro_torch.optim``: AdamW (f32 and int8 block-quantized
moments), the warmup-cosine schedule, error-feedback int8 compression and
the moment quantizers, against the reference's ``repro.optim`` on the same
numpy inputs; then the port's own versions of ``tests/test_train.py``'s
optimizer tests.

Tolerances: f32 results (master weights, parameters, f32 moments, scales,
schedule values, EF outputs and residuals) to 1e-6 relative — elementwise
for scalars, scales and the schedule; for a tree leaf, every element within
1e-6 of the leaf's largest magnitude (``_close``: an updated weight near
zero is a difference of near-equal numbers, so its own relative error is
no measure; the frameworks' sqrt and divide differ in the last bit);
int8 / uint8 codes equal except at most 0.1% of them one code apart (a
value at a rounding tie, where those last bits decide).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig
from repro.optim import adamw as j_adamw
from repro.optim import compress as j_compress
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.optim import adamw as t_adamw
from repro_torch.optim import (
    adamw_update,
    ef_compress,
    init_ef_state,
    init_opt_state,
    lr_schedule,
)
from repro_torch.tree import leaves_with_paths

F32 = dict(rtol=1e-6, atol=1e-12)
CODE_SHARE = 1e-3


def _codes_close(a, b):
    a, b = np.asarray(a).astype(np.int64), np.asarray(b).astype(np.int64)
    d = np.abs(a - b)
    assert d.max(initial=0) <= 1, d.max()
    assert (d > 0).mean() <= CODE_SHARE, (d > 0).mean()


def _close(b, a, name=""):
    """Every element within 1e-6 of the leaf's largest magnitude."""
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-6 * max(np.abs(a).max(initial=0), 1e-30),
                               err_msg=name)


def _tree(seed: int):
    """A parameter tree with 1-D, 2-D (K off the 64-block) and 3-D leaves."""
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((12, 100)).astype(np.float32) * 0.05,
        "stack": {"kernel": rng.standard_normal((3, 8, 130)).astype(np.float32) * 0.05},
        "norm": {"scale": np.ones(100, np.float32)},
        "bias": rng.standard_normal(7).astype(np.float32) * 0.01,
    }


def _grads(seed: int):
    rng = np.random.default_rng(1000 + seed)
    out = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.3).astype(np.float32),
                       _tree(0))
    out["w"][0, :5] = 0.0     # exact zeros: code 0 of the geometric v
    return out


def _torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _flat(tree):
    return dict(leaves_with_paths(tree))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("moments", ["float32", "int8"])
def test_adamw_matches_reference(moments):
    kw = dict(dtype="float32", param_dtype="float32", moments_dtype=moments, lr=1e-2,
              warmup_steps=2, total_steps=10, grad_clip=1.0)
    rc, trc = RunConfig(**kw), TRunConfig(**kw)
    p = _tree(0)
    js = j_adamw.init_opt_state(jax.tree.map(jnp.asarray, p), rc)
    tp = _torch(p)
    ts = init_opt_state(tp, trc)
    for step in range(4):
        g = _grads(step)
        jp, js, jm = j_adamw.adamw_update(jax.tree.map(jnp.asarray, g), js, rc, jnp.float32)
        tp, ts, tm = adamw_update(_torch(g), ts, trc, tp)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), **F32)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), **F32)
        assert int(ts.step) == int(js.step) == step + 1
    jflat = _flat(jax.tree.map(np.asarray, {"p": jp, "opt": js}))
    tflat = _flat({"p": tp, "opt": ts})
    assert sorted(jflat) == sorted(tflat)
    for name, a in jflat.items():
        b = _np(tflat[name])
        assert b.dtype == a.dtype, name
        if a.dtype in (np.int8, np.uint8):
            _codes_close(b, a)
        else:
            _close(b, a, name)


def test_master_does_not_alias_params():
    rc = TRunConfig(dtype="float32", param_dtype="float32")
    tp = _torch(_tree(0))
    st = init_opt_state(tp, rc)
    for a, b in zip(_flat(tp).values(), _flat(st.master).values()):
        assert a.data_ptr() != b.data_ptr()


def test_one_d_leaves_stay_f32_without_decay():
    """1-D leaves keep f32 moments under int8 and take no weight decay: a
    zero gradient leaves them where they are."""
    rc = TRunConfig(dtype="float32", param_dtype="float32", moments_dtype="int8", lr=1.0,
                    weight_decay=0.5, warmup_steps=0)
    tp = _torch(_tree(0))
    st = init_opt_state(tp, rc)
    assert isinstance(st.m["bias"], torch.Tensor) and isinstance(st.m["w"], dict)
    zeros = jax.tree.map(torch.zeros_like, tp)
    before = {n: t.clone() for n, t in _flat(tp).items()}
    adamw_update(zeros, st, rc, tp)
    after = _flat(tp)
    assert torch.equal(after["bias"], before["bias"])
    assert torch.equal(after["norm/scale"], before["norm/scale"])
    assert not torch.equal(after["w"], before["w"])   # decayed


@pytest.mark.parametrize("warm,total", [(0, 100), (10, 100), (5, 60), (1, 1)])
def test_lr_schedule_matches_reference(warm, total):
    kw = dict(lr=3e-4, warmup_steps=warm, total_steps=total)
    rc, trc = RunConfig(**kw), TRunConfig(**kw)
    steps = np.arange(0, total + 20, dtype=np.float32)
    a = np.array([float(j_adamw.lr_schedule(rc, jnp.asarray(s))) for s in steps])
    b = np.array([float(lr_schedule(trc, torch.tensor(s))) for s in steps])
    np.testing.assert_allclose(b, a, **F32)


def test_q8_quantizers_match_reference():
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((6, 130)) * np.exp(rng.uniform(-12, 2, (6, 130)))).astype(np.float32)
    x[1, 3:70] = 0.0
    for fq, fdq, tq, tdq, val in (
            (j_adamw._q8, j_adamw._dq8, t_adamw._q8, t_adamw._dq8, x),
            (j_adamw._q8_log, j_adamw._dq8_log, t_adamw._q8_log, t_adamw._dq8_log, x * x)):
        jq, js = fq(jnp.asarray(val))
        tqv, tsv = tq(torch.from_numpy(val))
        assert tqv.dtype == {jnp.int8: torch.int8, jnp.uint8: torch.uint8}[jq.dtype.type]
        _codes_close(tqv.numpy(), jq)
        np.testing.assert_allclose(tsv.numpy(), np.asarray(js), **F32)
        # dequantizing the same codes agrees to f32 rounding
        _close(tdq(torch.from_numpy(np.array(jq)), tsv).numpy(), fdq(jq, js))


def test_ef_compress_matches_reference():
    tree = _tree(0)
    je = j_compress.init_ef_state(jax.tree.map(jnp.asarray, tree))
    te = init_ef_state(_torch(tree))
    for step in range(5):
        g = _grads(step)
        jc, je = j_compress.ef_compress(jax.tree.map(jnp.asarray, g), je)
        tc, te = ef_compress(_torch(g), te)
        for name, a in _flat(jax.tree.map(np.asarray, {"c": jc, "e": je})).items():
            _close(_np(_flat({"c": tc, "e": te})[name]), a, name)


# ------------------------------------------------- the port's own optimizer tests
def test_int8_moments_track_fp32():
    """Quantized-moment AdamW stays close to fp32 AdamW over steps."""
    rc8 = TRunConfig(dtype="float32", param_dtype="float32", moments_dtype="int8",
                     lr=1e-2, warmup_steps=0, total_steps=100)
    rcf = dataclasses.replace(rc8, moments_dtype="float32")
    gen = torch.Generator().manual_seed(4)
    p = {"w": torch.randn((32, 64), generator=gen)}
    s8, sf = init_opt_state(p, rc8), init_opt_state(p, rcf)
    p8, pf = {"w": p["w"].clone()}, {"w": p["w"].clone()}
    for _ in range(10):
        g = {"w": torch.randn((32, 64), generator=gen) * 0.1}
        adamw_update(g, s8, rc8, p8)
        adamw_update(g, sf, rcf, pf)
    diff = float((p8["w"] - pf["w"]).abs().max())
    scale = float((pf["w"] - p["w"]).abs().max())
    assert diff < 0.15 * scale + 1e-4, (diff, scale)


def test_int8_state_bytes():
    """int8 moments: one byte a value plus an f32 scale a 64-block, against
    f32 moments' four bytes a value."""
    rc8 = TRunConfig(dtype="float32", param_dtype="float32", moments_dtype="int8")
    p = {"w": torch.zeros((32, 128))}
    st = init_opt_state(p, rc8)
    nbytes = sum(t.numel() * t.element_size() for t in (st.m["w"]["q"], st.m["w"]["s"],
                                                        st.v["w"]["q"], st.v["w"]["s"]))
    assert nbytes == 2 * (32 * 128 + 4 * 32 * 2)
    assert st.v["w"]["q"].dtype == torch.uint8 and st.m["w"]["q"].dtype == torch.int8


def test_ef_compression_unbiased_over_time():
    """Error feedback: sum of compressed grads ≈ sum of true grads."""
    gen = torch.Generator().manual_seed(5)
    g_true = [torch.randn(64, generator=gen) for _ in range(30)]
    ef = init_ef_state({"w": g_true[0]})
    tot_c = torch.zeros(64)
    for g in g_true:
        cg, ef = ef_compress({"w": g}, ef)
        tot_c = tot_c + cg["w"]
    resid = float((tot_c - sum(g_true)).abs().max())
    # residual bounded by one step's quantization error, not 30 steps' worth
    assert resid <= float(ef["w"].abs().max()) + 1e-5


def test_lr_schedule_shape():
    rc = TRunConfig(lr=1.0, warmup_steps=10, total_steps=100)
    assert float(lr_schedule(rc, 0.0)) == 0.0
    assert abs(float(lr_schedule(rc, 10.0)) - 1.0) < 1e-6
    assert float(lr_schedule(rc, 100.0)) < 0.11
