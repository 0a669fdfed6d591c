"""Port parity for the SSM and hybrid stacks: ``models/ssm.py`` (the
Mamba-1 mixer, its decode step and its log-depth scan), the full and the
incremental forward of ``falcon-mamba-7b_smoke`` and ``hymba-1.5b_smoke``
(and of the two archs ported before them, now also on the dense layout),
their init and their surgery, against the reference on the same numpy
inputs with the reference's weights carried across by ``repro_torch.interop``.

Tolerances, f32 on both sides: the mixer's output and returned state and
the decode step within ``1e-6`` abs + ``1e-5`` rel; the two frameworks
order the projections' sums and the state contraction differently and their
exp / log1p differ in the last bit. The scan itself combines elements in
the reference's ``associative_scan`` order. Surgered trees must be
byte-identical."""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig, get_config
from repro.models import init as j_init
from repro.models import init_caches as j_init_caches
from repro.models.ssm import mamba_decode_step as j_decode
from repro.models.ssm import mamba_mixer as j_mixer
from repro.quant import apply_surgery as j_apply_surgery
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import get_config as t_get_config
from repro_torch.interop import flat_leaves, params_from_reference, to_numpy
from repro_torch.models import init, init_caches
from repro_torch.models.ssm import _scan, mamba_decode_step, mamba_mixer
from repro_torch.models.transformer import backend_from
from repro_torch.quant import QBits, apply_surgery

torch.set_float32_matmul_precision("highest")
SSM, HYBRID = "falcon-mamba-7b_smoke", "hymba-1.5b_smoke"
RC_KW = dict(dtype="float32", param_dtype="float32", remat="none")
ATOL, RTOL = 1e-6, 1e-5


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=atol, rtol=rtol)


@pytest.fixture(scope="module")
def ssm_params():
    cfg = get_config(SSM)
    params = j_init(cfg, RunConfig(**RC_KW), jax.random.PRNGKey(0))
    p0 = jax.tree.map(lambda a: np.asarray(a[0]), params["groups"][0]["k0"]["ssm"])
    return p0, params_from_reference(p0, device="cpu")


# ------------------------------------------------------------------- scan
@pytest.mark.parametrize("S", [1, 2, 7, 16, 33])
def test_scan_is_the_reference_associative_scan(S):
    """Every odd and even length: the same inclusive prefix as
    ``jax.lax.associative_scan`` over ``(a_l·a_r, b_l·a_r + b_r)``."""
    rng = np.random.default_rng(S)
    a = rng.uniform(0.5, 1.0, (2, S, 3, 4)).astype(np.float32)
    b = rng.normal(size=(2, S, 3, 4)).astype(np.float32)

    def combine(l, r):
        return l[0] * r[0], l[1] * r[0] + r[1]

    wa, wb = jax.lax.associative_scan(combine, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    ga, gb = _scan(torch.from_numpy(a), torch.from_numpy(b))
    _close(ga, wa)
    _close(gb, wb)


def test_scan_is_the_sequential_recurrence():
    """The scan's h equals the step-by-step recurrence h_t = a_t h_{t-1} + b_t."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (1, 40, 8, 4)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(1, 40, 8, 4)).astype(np.float32))
    h = torch.zeros_like(b[:, 0])
    seq = []
    for t in range(40):
        h = a[:, t] * h + b[:, t]
        seq.append(h)
    _, hs = _scan(a, b)
    torch.testing.assert_close(hs, torch.stack(seq, 1), atol=ATOL, rtol=RTOL)


# ------------------------------------------------------------------ mixer
@pytest.mark.parametrize("S", [2, 9])
def test_mamba_mixer_and_state_match_reference(ssm_params, S):
    """Output and returned state; S = 2 is shorter than ``ssm_conv - 1``
    (3): the conv state has only the prompt's 2 rows, as the reference's."""
    p_ref, p_port = ssm_params
    cfg = get_config(SSM)
    rc = RunConfig(**RC_KW)
    u = np.random.default_rng(3).normal(size=(2, S, cfg.d_model)).astype(np.float32)
    from repro.models.transformer import backend_from as j_backend_from

    want, wst = j_mixer(cfg, jax.tree.map(jnp.asarray, p_ref), jnp.asarray(u),
                        backend=j_backend_from(rc), return_state=True)
    got, st = mamba_mixer(t_get_config(SSM), p_port, torch.from_numpy(u),
                          backend=backend_from(TRunConfig(**RC_KW)), return_state=True)
    _close(got, want)
    _close(st["h"], wst["h"])
    _close(st["conv"], wst["conv"])
    assert tuple(st["conv"].shape) == (2, min(S, cfg.ssm_conv - 1), cfg.d_inner)


def test_mamba_decode_step_matches_reference(ssm_params):
    p_ref, p_port = ssm_params
    cfg = get_config(SSM)
    rc = RunConfig(**RC_KW)
    rng = np.random.default_rng(4)
    u = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    state = {"h": rng.normal(size=(3, cfg.d_inner, cfg.ssm_state)).astype(np.float32),
             "conv": rng.normal(size=(3, cfg.ssm_conv - 1, cfg.d_inner)).astype(np.float32)}
    from repro.models.transformer import backend_from as j_backend_from

    want, wst = j_decode(cfg, jax.tree.map(jnp.asarray, p_ref), jnp.asarray(u),
                         jax.tree.map(jnp.asarray, state), backend=j_backend_from(rc))
    got, st = mamba_decode_step(t_get_config(SSM), p_port, torch.from_numpy(u),
                                {k: torch.from_numpy(v) for k, v in state.items()},
                                backend=backend_from(TRunConfig(**RC_KW)))
    _close(got, want)
    _close(st["h"], wst["h"])
    _close(st["conv"], wst["conv"])


@pytest.mark.parametrize("arch", [SSM, HYBRID])
def test_init_caches_layout_matches_reference(arch):
    """Dense KV leaves (layers, batch, capacity, ...) and the f32 SSM state
    per group, int8 scales included, as the reference allocates them."""
    rc = RunConfig(kv_cache_dtype="int8", **RC_KW)
    want = flat_leaves(jax.tree.map(np.asarray, j_init_caches(get_config(arch), rc, 3, 16)))
    got = flat_leaves(init_caches(t_get_config(arch), TRunConfig(kv_cache_dtype="int8",
                                                                 **RC_KW), 3, 16, device="cpu"))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype and not got[k].any(), k


# -------------------------------------------------------------------- init
@pytest.mark.parametrize("arch", [SSM, HYBRID])
def test_init_tree_matches_reference_layout(arch):
    """Paths, shapes and dtypes of the reference's tree, and each new init
    kind: ``conv_b`` zeros, ``A_log`` log(n+1) along the state axis, ``D``
    ones, ``dt_bias`` the inverse softplus of a dt in [1e-3, 1e-1]; the
    hybrid block's fuse norms ones."""
    rc = RunConfig(**RC_KW)
    want = flat_leaves(jax.tree.map(np.asarray, j_init(get_config(arch), rc,
                                                       jax.random.PRNGKey(0))))
    got = flat_leaves(init(t_get_config(arch), TRunConfig(**RC_KW), device="cpu"))
    assert got.keys() == want.keys()
    n = t_get_config(arch).ssm_state
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
        if k.endswith((".scale", ".D")):
            assert (got[k] == 1).all(), k
        if k.endswith(".conv_b"):
            assert not got[k].any(), k
        if k.endswith(".A_log"):
            np.testing.assert_array_equal(got[k], np.broadcast_to(
                np.log(np.arange(1, n + 1, dtype=np.float32)), v.shape), err_msg=k)
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        if k.endswith(".dt_bias"):
            dt = np.log1p(np.exp(got[k].astype(np.float64)))
            assert dt.min() >= 1e-3 * (1 - 1e-5) and dt.max() <= 0.1 * (1 + 1e-5), k
            assert np.unique(got[k]).size == got[k].size, k   # drawn, not constant
    assert any(k.endswith("fuse_attn_norm.scale") for k in got) == (arch == HYBRID)


# The seed-0 CPU draws of the two archs ported before the SSM init kinds, as
# sha256 over (path, dtype, shape, bytes) of every leaf in path order: the
# card's token gates depend on these weights, so a new init kind may draw
# only for new leaves.
INIT_HASHES = {
    ("qwen3-0.6b_smoke", "float32"):
        "e36038e1df390e4555ebcf89248c90cc9b380b75026ce0716dfb7e415aedd65a",
    ("qwen3-0.6b_smoke", "bfloat16"):
        "cd874591806f348cbab75253f3a8c48c2aa42c90a18d9257a619560673473f5b",
    ("deepseek-v2-lite-16b_smoke", "float32"):
        "d334a67cb87f18480ea7bccfec38aa9e7e54408bedf8709dcc4142d1d00296b8",
    ("deepseek-v2-lite-16b_smoke", "bfloat16"):
        "cc1d235ce7525bd69ee49629740f575f6eaa6bf87f39a43b36e6b5224ccbb52c",
}


@pytest.mark.parametrize("arch,dtype", sorted(INIT_HASHES))
def test_init_draws_of_earlier_archs_are_pinned(arch, dtype):
    params = init(t_get_config(arch), TRunConfig(dtype=dtype, param_dtype=dtype), device="cpu")
    h = hashlib.sha256()
    for k, v in sorted(flat_leaves(params).items()):
        h.update(k.encode())
        h.update(str(v.dtype).encode())
        h.update(str(v.shape).encode())
        h.update(v.tobytes())
    assert h.hexdigest() == INIT_HASHES[(arch, dtype)]


def test_init_dt_bias_draws_from_the_generator():
    """``dt_bias`` draws from the caller's generator like the normal
    leaves: one seed gives one tree, another seed another ``dt_bias``."""
    cfg, rc = t_get_config(SSM), TRunConfig(**RC_KW)
    a = flat_leaves(init(cfg, rc, torch.Generator().manual_seed(5), device="cpu"))
    b = flat_leaves(init(cfg, rc, torch.Generator().manual_seed(5), device="cpu"))
    c = flat_leaves(init(cfg, rc, torch.Generator().manual_seed(6), device="cpu"))
    assert all(np.array_equal(a[k], b[k]) for k in a)
    k = next(k for k in a if k.endswith(".dt_bias"))
    assert not np.array_equal(a[k], c[k])


# ----------------------------------------------------------------- surgery
SURGERY = {
    SSM: ["ssm.*=int8,*=bf16", "ssm.*=int2:prequant,*=bf16",
          "ssm.in_proj=int4:prequant,ssm.*=int8:prequant,*=bf16"],
    HYBRID: ["attn.*=int8,ssm.*=int8:prequant,mlp.*=int2:prequant,*=bf16",
             "ssm.dt=int8:prequant,ssm.*=int2:prequant,attn.*=int8:prequant,*=bf16"],
}


@pytest.mark.parametrize("arch,policy", [(a, p) for a, ps in SURGERY.items() for p in ps])
def test_surgered_tree_is_the_reference_tree(arch, policy):
    """``apply_surgery`` on the SSM and hybrid trees: the reference's paths,
    packed bytes, scales and bitwidth markers, byte for byte (the ``ssm.*``
    names resolve as the reference's ``_SSM`` map gives them)."""
    rc = RunConfig(quant_policy=policy, **RC_KW)
    params = j_init(get_config(arch), rc, jax.random.PRNGKey(0))
    want = flat_leaves(jax.tree.map(np.asarray, j_apply_surgery(get_config(arch), rc, params)))
    got = flat_leaves(apply_surgery(
        t_get_config(arch), TRunConfig(quant_policy=policy, **RC_KW),
        params_from_reference(jax.tree.map(np.asarray, params), device="cpu")))
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, QBits):
            assert got[k] == v, k
        else:
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    if ":prequant" in policy:
        assert any(k.endswith("ssm.dt_w.qbits") for k in got)


def test_ssm_rules_resolve_in_the_forward_policy_check():
    """``step_backend`` resolves an ``ssm.*`` rule on these params (the
    rule names a GEMM), and rejects a typo'd one, as the reference's
    runtime check does."""
    from repro_torch.models.transformer import step_backend
    from repro_torch.quant.policy import PolicyError

    cfg = t_get_config(SSM)
    tparams = init(cfg, TRunConfig(**RC_KW), device="cpu")
    be = step_backend(cfg, TRunConfig(quant_policy="ssm.dt=int2,ssm.*=int8,*=bf16", **RC_KW),
                      tparams)
    assert be.for_gemm("ssm.dt").bits == 2 and be.for_gemm("ssm.x_proj").bits == 8
    with pytest.raises(PolicyError):
        step_backend(cfg, TRunConfig(quant_policy="ssm.dtt=int2,*=bf16", **RC_KW), tparams)

