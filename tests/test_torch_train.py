"""Port parity for training: ``loss_fn`` and its gradients under ``*=int8``
(every gradient leaf on the seven registered ``_smoke`` archs is in
``test_torch_train_grads.py``), remat, microbatching, the synthetic data, the
train step, checkpoints, the Trainer and the launcher, against the
reference on the same numpy inputs with its weights carried across by
``repro_torch.interop``; then the port's versions of
``tests/test_train.py``'s tests on its arch (``smollm-360m_smoke``) with the
reference's RunConfig and shape.

Tolerances (f32 on both sides; the frameworks order sums differently and
their exp/rsqrt/tanh differ in the last bit, nothing else):
- the loss to ``rtol=1e-5``;
- every gradient leaf, and every parameter leaf after train steps, to
  1e-4 relative L2 (``_rel_l2``);
- under ``*=int8`` the gradient's nonzero entries exactly the reference's
  (rounding cuts the gradient everywhere but the dequant scales' absmax
  elements and the biases), the values to the same 1e-4;
- remat ``none`` / ``block`` / ``full``: gradients to 1e-6 relative L2
  (the same arithmetic, recomputed), and the same records;
- k=4 microbatched steps against the reference's: the loss and the
  gradient's global norm to ``rtol=1e-5``, parameters to the 1e-4 above;
- tokens, a reference checkpoint's leaves and a resumed run's parameters
  bit for bit.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig, ShapeConfig, get_config
from repro.data import make_batches as j_make_batches
from repro.models import active_params as j_active
from repro.models import count_params as j_count
from repro.models import init as j_init
from repro.models import loss_fn as j_loss
from repro.models import model_flops as j_flops
from repro.train import build_train_step as j_build_step
from repro.train import checkpoint as j_ckpt
from repro.train import init_train_state as j_init_state
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import ShapeConfig as TShapeConfig
from repro_torch.configs.base import get_config as t_get_config
from repro_torch.configs.base import list_configs as t_list_configs
from repro_torch.data import make_batches
from repro_torch.interop import params_from_reference
from repro_torch.kernels import ops
from repro_torch.launch.train import main as train_main
from repro_torch.models import active_params, count_params, init, init_caches, loss_fn
from repro_torch.models import model_flops
from repro_torch.train import (
    InjectedFailure,
    StepClock,
    Trainer,
    build_train_step,
    init_train_state,
)
from repro_torch.train import checkpoint as ckpt
from repro_torch.quant.capture import capture_stats
from repro_torch.quant.stats import collecting
from repro_torch.tree import leaves, leaves_with_paths, unflatten_like

torch.set_float32_matmul_precision("highest")

ARCHS = ["qwen3-0.6b_smoke", "deepseek-v2-lite-16b_smoke", "falcon-mamba-7b_smoke",
         "hymba-1.5b_smoke", "hubert-xlarge_smoke", "qwen2-vl-7b_smoke",
         "llama4-maverick-400b-a17b_smoke"]
ARCH = "qwen3-0.6b_smoke"
MIRROR_ARCH = "smollm-360m_smoke"     # the reference's tests/test_train.py arch
F32 = dict(dtype="float32", param_dtype="float32")
# the reference's test_train.py RunConfig and shape
RC_KW = dict(F32, remat="none", lr=1e-2, warmup_steps=5, total_steps=60)
SHAPE = (32, 8)
GRAD_TOL = 1e-4
SAME_TOL = 1e-6


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    den = np.linalg.norm(b)
    return float(np.linalg.norm(a - b) / den) if den else float(np.linalg.norm(a))


def _carried(arch, kw, seed=0):
    cfg, tcfg = get_config(arch), t_get_config(arch)
    rc, trc = RunConfig(**kw), TRunConfig(**kw)
    p = j_init(cfg, rc, jax.random.PRNGKey(seed))
    return cfg, tcfg, rc, trc, p, params_from_reference(jax.tree.map(np.asarray, p), "cpu")


def _batch(cfg, B=2, S=16, seed=3) -> dict:
    """One batch in the reference's input forms, as numpy."""
    rng = np.random.default_rng(seed)
    b = {"labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.frontend == "audio":
        b["embeds"] = rng.standard_normal((B, S, 512)).astype(np.float32)
    else:
        b["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.mrope_sections is not None:
        pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
        b["positions"] = np.stack([pos, pos, pos])
    return b


def _j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _t(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _port_grads(tcfg, trc, tp, batch):
    flat = [t.requires_grad_(True) for t in leaves(tp)]
    total, metrics = loss_fn(tcfg, trc, tp, _t(batch))
    grads = torch.autograd.grad(total, flat)
    return float(total.detach()), metrics, dict(zip([n for n, _ in leaves_with_paths(tp)],
                                           (g.numpy() for g in grads)))


def _ref_grads(cfg, rc, p, batch):
    (total, metrics), g = jax.jit(jax.value_and_grad(
        lambda q: j_loss(cfg, rc, q, _j(batch)), has_aux=True))(p)
    return float(total), metrics, dict(leaves_with_paths(jax.tree.map(np.asarray, g)))


# ------------------------------------------------------------------ loss_fn
def test_int8_policy_grads_match_reference():
    """``*=int8`` trains through the plain versions on the CPU: the
    gradient reaches only the dequant scales' absmax elements and the
    biases, as through the reference's XLA twins (16,714 of 90,496 entries
    on this arch and batch)."""
    cfg, tcfg, rc, trc, p, tp = _carried(ARCH, dict(F32, remat="none", quant_policy="*=int8"))
    batch = _batch(cfg)
    jl, _, jg = _ref_grads(cfg, rc, p, batch)
    tl, _, tg = _port_grads(tcfg, trc, tp, batch)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    nonzero = sum(int((g != 0).sum()) for g in jg.values())
    assert 0 < nonzero < sum(g.size for g in jg.values()) // 2
    for n in jg:
        np.testing.assert_array_equal(tg[n] != 0, jg[n] != 0, err_msg=n)
        assert _rel_l2(tg[n], jg[n]) <= GRAD_TOL, n


def test_loss_chunks_match_one_piece():
    """S = 2 x 512: the chunked (checkpointed) loss equals the one-piece
    loss of the same forward, and so do its gradients."""
    cfg, tcfg, rc, trc, p, tp = _carried(ARCH, dict(F32, remat="none"))
    batch = _batch(cfg, B=1, S=1024)
    jl, _, jg = _ref_grads(cfg, rc, p, batch)
    tl, _, tg = _port_grads(tcfg, trc, tp, batch)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert max(_rel_l2(tg[n], jg[n]) for n in jg) <= GRAD_TOL


def test_param_counts_match_reference():
    for name in t_list_configs():
        cfg, tcfg = get_config(name), t_get_config(name)
        assert count_params(tcfg) == j_count(cfg), name
        assert active_params(tcfg) == j_active(cfg), name
        for kind in ("train", "prefill", "decode"):
            shp = (ShapeConfig("s", 128, 4, kind), TShapeConfig("s", 128, 4, kind))
            assert model_flops(tcfg, shp[1]) == j_flops(cfg, shp[0]), (name, kind)


# -------------------------------------------------------------------- remat
@pytest.mark.parametrize("arch", [ARCH, "deepseek-v2-lite-16b_smoke", "hymba-1.5b_smoke"])
def test_remat_modes_give_the_same_gradients(arch):
    """none / block / full: the same gradients, and the recompute records
    no path a second time."""
    cfg = get_config(arch)
    tcfg = t_get_config(arch)
    p = j_init(cfg, RunConfig(**F32), jax.random.PRNGKey(0))
    batch = _batch(cfg)
    out = {}
    for remat in ("none", "block", "full"):
        tp = params_from_reference(jax.tree.map(np.asarray, p), "cpu")
        ops.reset_counts()
        out[remat] = _port_grads(tcfg, TRunConfig(**F32, remat=remat), tp, batch)
        out[remat] += (ops.path_counts(),)
    for remat in ("block", "full"):
        assert out[remat][0] == out["none"][0]
        assert out[remat][3] == out["none"][3]
        for n, g in out["none"][2].items():
            assert _rel_l2(out[remat][2][n], g) <= SAME_TOL, (remat, n)


def test_remat_records_each_gemm_once():
    """Under ``*=int8:stats`` on an untied head, with S = 2 x 512 (the loss's
    checkpointed chunks): none / block / full record the same paths,
    dispatches, captured GEMMs and collector records as a forward without
    grad, so no recompute, of a block or of a loss chunk, records twice."""
    arch = "qwen2-vl-7b_smoke"
    tcfg = t_get_config(arch)
    assert not tcfg.tie_embeddings
    batch = _t(_batch(tcfg, B=1, S=1024))
    tp = init(tcfg, TRunConfig(**F32), device="cpu")

    def records(remat, grad):
        trc = TRunConfig(**F32, remat=remat, quant_policy="*=int8:stats")
        ops.reset_counts()
        with capture_stats() as cap, collecting() as col, ops.counting_dispatches() as disp:
            with torch.set_grad_enabled(grad):
                flat = [t.detach().requires_grad_(grad) for t in leaves(tp)]
                total, _ = loss_fn(tcfg, trc, unflatten_like(tp, flat), batch)
                if grad:
                    torch.autograd.grad(total, flat, allow_unused=True)
        return (ops.path_counts(), list(disp), [(e.name, e.M, e.K, e.N) for e in cap.entries],
                [(r.name, r.M, r.N, r.P) for r in col.records])

    want = records("none", False)
    assert all(want), want
    assert sum(e[0] == "lm_head" for e in want[2]) == 2
    for remat in ("none", "block", "full"):
        assert records(remat, True) == want, remat


def test_remat_block_saves_the_matmuls():
    """The backward's recompute: ``block`` recomputes the elementwise ops
    but no linear layer's matmul (their outputs were saved), ``full``
    recomputes the matmuls too, ``none`` recomputes nothing."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[func] = self.ops.get(func, 0) + 1
            return func(*args, **(kwargs or {}))

    tcfg = t_get_config(ARCH)
    seen = {}
    for remat in ("none", "block", "full"):
        tp = init(tcfg, TRunConfig(**F32), device="cpu")
        flat = [t.requires_grad_(True) for t in leaves(tp)]
        total, _ = loss_fn(tcfg, TRunConfig(**F32, remat=remat), tp, _t(_batch(tcfg)))
        with Count() as c:
            torch.autograd.grad(total, flat)
        seen[remat] = (c.ops.get(torch.ops.aten.mm.default, 0),
                       c.ops.get(torch.ops.aten.rsqrt.default, 0))
    assert seen["block"][0] == seen["none"][0] < seen["full"][0]
    assert seen["none"][1] < seen["block"][1] == seen["full"][1]


# --------------------------------------------------------------- train step
def _ref_steps(cfg, rc, p, batches, n):
    step = jax.jit(j_build_step(cfg, rc))
    state = j_init_state(cfg, rc, p)
    losses = []
    for b in batches[:n]:
        state, m = step(state, _j(b))
        losses.append(float(m["loss"]))
    return state, losses


def _port_steps(tcfg, trc, tp, batches, n):
    step = build_train_step(tcfg, trc)
    state = init_train_state(tcfg, trc, tp)
    losses = []
    for b in batches[:n]:
        state, m = step(state, _t(b))
        losses.append(float(m["loss"]))
    return state, losses


def _np_batches(cfg, n, seed=2, B=8, S=32):
    it = j_make_batches(cfg, ShapeConfig("tiny", S, B, "train"), seed=seed)
    out = [jax.tree.map(np.asarray, next(it)) for _ in range(n)]
    it.close()
    return out


def test_five_train_steps_match_reference():
    cfg, tcfg, rc, trc, p, tp = _carried(ARCH, RC_KW)
    batches = _np_batches(cfg, 5)
    js, jl = _ref_steps(cfg, rc, p, batches, 5)
    ts, tl = _port_steps(tcfg, trc, tp, batches, 5)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    jp = dict(leaves_with_paths(jax.tree.map(np.asarray, js["params"])))
    tpp = dict(leaves_with_paths(ts["params"]))
    bad = {n: _rel_l2(tpp[n].detach().numpy(), a) for n, a in jp.items()
           if _rel_l2(tpp[n].detach().numpy(), a) > GRAD_TOL}
    assert not bad, bad


@pytest.mark.parametrize("arch", [ARCH, "qwen2-vl-7b_smoke"])
def test_microbatch_equivalence(arch):
    """Three k=4 microbatched steps from carried params against the
    reference's jitted k=4 step on the same batches (M-RoPE positions split
    on their batch axis): the loss, the gradient's global norm (so the
    accumulated gradient's scale, which Adam's first steps hardly see) and
    the parameters after every step."""
    cfg, tcfg, rc, trc, p, tp = _carried(arch, dict(RC_KW, microbatches=4))
    batches = [_batch(cfg, B=8, S=16, seed=s) for s in range(3)]
    jstep, tstep = jax.jit(j_build_step(cfg, rc)), build_train_step(tcfg, trc)
    js, ts = j_init_state(cfg, rc, p), init_train_state(tcfg, trc, tp)
    for b in batches:
        js, jm = jstep(js, _j(b))
        ts, tm = tstep(ts, _t(b))
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
        jp = dict(leaves_with_paths(jax.tree.map(np.asarray, js["params"])))
        bad = {n: e for n, t in leaves_with_paths(ts["params"])
               if (e := _rel_l2(t.detach().numpy(), jp[n])) > GRAD_TOL}
        assert not bad, bad


# --------------------------------------------------------------------- data
@pytest.mark.parametrize("arch,fast", [(ARCH, True), (ARCH, False),
                                       ("qwen2-vl-7b_smoke", True),
                                       ("hubert-xlarge_smoke", True)])
def test_make_batches_match_reference(arch, fast):
    cfg, tcfg = get_config(arch), t_get_config(arch)
    B, S = (2, 6) if not fast else (4, 16)
    ji = j_make_batches(cfg, ShapeConfig("d", S, B, "train"), seed=7, fast=fast, start_step=3)
    ti = make_batches(tcfg, TShapeConfig("d", S, B, "train"), seed=7, fast=fast, start_step=3)
    try:
        for _ in range(2):
            jb, tb = next(ji), next(ti)
            assert sorted(jb) == sorted(tb)
            for k in jb:
                a, b = np.asarray(jb[k]), tb[k]
                assert b.device.type == "cpu" and b.numpy().dtype == a.dtype, k
                np.testing.assert_array_equal(b.numpy(), a, err_msg=k)
    finally:
        ji.close()
        ti.close()


# -------------------------------------------------------------- checkpoints
@pytest.mark.parametrize("kw", [
    dict(F32),
    dict(F32, moments_dtype="int8", grad_compression="int8_ef"),
    dict(dtype="bfloat16", param_dtype="bfloat16", moments_dtype="int8"),
], ids=["f32", "int8_ef", "bf16_int8"])
def test_reference_checkpoint_restores_bit_for_bit(tmp_path, kw):
    """A checkpoint the reference wrote after two updates (random gradients
    through its EF compression and AdamW) restores into the port's state
    leaf for leaf, bit for bit, under the reference's names."""
    from repro.optim import adamw_update as j_adamw_update
    from repro.optim import ef_compress as j_ef_compress

    kw = dict(kw, remat="none", lr=1e-2, warmup_steps=1, total_steps=10)
    cfg, tcfg, rc, trc, p, tp = _carried(ARCH, kw)
    @jax.jit
    def update(js, g):
        if "ef" in js:
            g, js["ef"] = j_ef_compress(g, js["ef"])
        js["params"], js["opt"], _ = j_adamw_update(g, js["opt"], rc, jnp.dtype(rc.param_dtype))
        return js

    js = j_init_state(cfg, rc, p)
    rng = np.random.default_rng(0)
    for _ in range(2):
        js = update(dict(js), jax.tree.map(
            lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype), p))
    j_ckpt.save(str(tmp_path), 2, js)
    state = init_train_state(tcfg, trc, tp)
    restored, manifest = ckpt.restore(str(tmp_path), 2, state)
    assert manifest["step"] == 2
    names = [n for n, _ in leaves_with_paths(restored)]
    assert "opt/0" in names and any(n.startswith("opt/1/") for n in names)
    if "ef" in kw.get("grad_compression", ""):
        assert any(n.startswith("ef/") for n in names)
    if kw.get("moments_dtype") == "int8":
        assert "opt/2/embed/embedding/q" in names and "opt/3/embed/embedding/s" in names
    ref = dict(leaves_with_paths(jax.tree.map(np.asarray, js)))
    assert sorted(ref) == sorted(names)
    for n, t in leaves_with_paths(restored):
        a = ref[n]
        if a.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16, n
            np.testing.assert_array_equal(t.view(torch.int16).numpy(), a.view(np.int16))
        else:
            assert t.numpy().dtype == a.dtype, n
            np.testing.assert_array_equal(t.numpy(), a, err_msg=n)


def test_checkpoint_roundtrip_and_dtype(tmp_path):
    for dtype in ("float32", "bfloat16"):
        tcfg = t_get_config(ARCH)
        rc = TRunConfig(dtype=dtype, param_dtype=dtype, moments_dtype="int8",
                        grad_compression="int8_ef")
        state = init_train_state(tcfg, rc, init(tcfg, rc, device="cpu"))
        d = str(tmp_path / dtype)
        ckpt.save(d, 7, state)
        assert ckpt.latest_step(d) == 7
        restored, manifest = ckpt.restore(d, 7, state)
        assert manifest["step"] == 7
        with open(os.path.join(d, "step_00000007", "manifest.json")) as f:
            meta = json.load(f)["leaves"]
        assert meta["params/embed/embedding"]["dtype"] == dtype
        for (n, a), b in zip(leaves_with_paths(state), leaves(restored)):
            assert a.dtype == b.dtype and torch.equal(a.detach(), b), n


def test_async_checkpointer_keeps_three(tmp_path):
    saver = ckpt.AsyncCheckpointer(str(tmp_path), keep=3)
    tree = {"w": torch.arange(6.0)}
    for s in range(1, 6):
        saver.save_async(s, tree)
        tree["w"].add_(1.0)     # the snapshot was taken before save_async returned
    saver.wait()
    assert sorted(os.listdir(tmp_path)) == [f"step_{s:08d}" for s in (3, 4, 5)]
    got, _ = ckpt.restore(str(tmp_path), 5, tree)
    assert torch.equal(got["w"], torch.arange(6.0) + 4.0)


# ---------------------------------------- the port's versions of test_train.py
def _trainer(**kw):
    return Trainer(t_get_config(MIRROR_ARCH), TRunConfig(**RC_KW), device="cpu",
                   log_fn=lambda *a: None, **kw)


def _tbatches(seed, start_step=0):
    return make_batches(t_get_config(MIRROR_ARCH), TShapeConfig("tiny", *SHAPE, "train"),
                        seed=seed, start_step=start_step)


def test_loss_decreases():
    t = _trainer(log_every=1000)
    it = _tbatches(0)
    hist = t.run(it, 30)
    it.close()
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert last < first - 0.2, (first, last)
    assert all(np.isfinite(h["grad_norm"]) for h in hist)


def test_checkpoint_resume_equivalence(tmp_path):
    """train 6 = train 3 + crash + resume 3 (bitwise params)."""
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    t_full = _trainer(ckpt_dir=d1, ckpt_every=3)
    it = _tbatches(2)
    t_full.run(it, 6)
    it.close()

    t_a = _trainer(ckpt_dir=d2, ckpt_every=3, fail_at_step=4)
    it = _tbatches(2)
    with pytest.raises(InjectedFailure):
        t_a.run(it, 6)
    it.close()
    t_a.saver.wait()

    t_b = _trainer(ckpt_dir=d2, ckpt_every=3)
    assert t_b.step == 3
    it = _tbatches(2, start_step=3)
    t_b.run(it, 3)
    it.close()
    for a, b in zip(leaves(t_full.state), leaves(t_b.state)):
        assert torch.equal(a.detach(), b.detach())


def test_trainer_starts_from_given_params():
    """``params=`` carries the reference's weights in: the first loss is the
    reference's loss on the same batch."""
    cfg, tcfg, rc, trc, p, tp = _carried(ARCH, RC_KW)
    b = _np_batches(cfg, 1)
    jl = float(jax.jit(lambda q: j_loss(cfg, rc, q, _j(b[0]))[1]["loss"])(p))
    t = Trainer(tcfg, trc, params=tp, device="cpu", log_fn=lambda *a: None)
    t.run(iter([_t(b[0])]), 1)
    np.testing.assert_allclose(t.history[0]["loss"], jl, rtol=1e-5)


def test_straggler_watchdog():
    c = StepClock(factor=3.0)
    for _ in range(20):
        c.record(0.01)
    assert c.record(0.05) is True
    assert c.stragglers == 1
    s = c.summary()
    assert s["p99_ms"] >= s["p50_ms"]


# ------------------------------------------------------- launcher, refusals
def test_launch_train_cpu(tmp_path):
    argv = ["--arch", ARCH, "--steps", "4", "--seq-len", "16", "--global-batch", "4",
            "--device", "cpu", "--remat", "full", "--moments", "int8",
            "--grad-compression", "int8_ef", "--ckpt-dir", str(tmp_path)]
    t = train_main(argv)
    assert t.step == 4 and t.rc.dtype == "float32" and ckpt.latest_step(str(tmp_path)) == 4
    assert all(np.isfinite(h["loss"]) for h in t.history)
    # a second launch resumes at the end and trains no more
    t2 = train_main(argv)
    assert t2.step == 4 and not t2.history
    for a, b in zip(leaves(t.state), leaves(t2.state)):
        assert torch.equal(a.detach(), b.detach())


@pytest.mark.parametrize("argv,exc", [
    (["--production-mesh"], ValueError),      # 256 ranks, one card each: not here
    (["--multi-pod"], ValueError),            # 512
    (["--data", "2"], ValueError),            # a mesh without --mesh-backend
    (["--model", "2"], ValueError),
    (["--policy", "*=int8:prequant"], SystemExit),
])
def test_launch_train_refusals(argv, exc):
    with pytest.raises(exc):
        train_main(["--arch", ARCH, "--steps", "1", "--device", "cpu", *argv])


def test_cuda_kernel_refuses_grad():
    """No kernel has a backward: the CUDA path raises on an operand that
    requires grad while grad is on (checked before any launch), and is
    allowed under no_grad or without such an operand."""
    x = torch.randn(4, 8, requires_grad=True)
    w = torch.randn(8, 3)
    with pytest.raises(RuntimeError, match="requires grad"):
        ops.resolve_path("cuda", x)
    with pytest.raises(RuntimeError, match="requires grad"):
        ops.resolve_path("cuda", w, None, x)
    with pytest.raises(RuntimeError, match="requires grad"):
        ops.matmul_fused(x, w, sx=torch.ones(()), sw=torch.ones(3), bits=8, impl="cuda")
    with torch.no_grad():
        assert ops.resolve_path("cuda", x) == "cuda"
    assert ops.resolve_path("cuda", w) == "cuda"
    assert ops.resolve_path("auto", x) == "torch"


def test_softcap_no_cache_only():
    """The logit softcap runs in the no-cache forward and its backward, and
    is refused with a KV cache (the reference drops it there, C13)."""
    cfg = get_config(ARCH).replace(attn_logit_softcap=3.0)
    tcfg = t_get_config(ARCH).replace(attn_logit_softcap=3.0)
    rc, trc = RunConfig(**F32, remat="none"), TRunConfig(**F32, remat="none")
    p = j_init(cfg, rc, jax.random.PRNGKey(0))
    tp = params_from_reference(jax.tree.map(np.asarray, p), "cpu")
    batch = _batch(cfg)
    jl, _, jg = _ref_grads(cfg, rc, p, batch)
    tl, _, tg = _port_grads(tcfg, trc, tp, batch)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert max(_rel_l2(tg[n], jg[n]) for n in jg) <= GRAD_TOL
    assert abs(tl - _port_grads(t_get_config(ARCH), trc, tp, batch)[0]) > 1e-6
    with pytest.raises(NotImplementedError, match="C13"):
        init_caches(tcfg, trc, 1, 8, device="cpu")
