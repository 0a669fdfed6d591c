"""Port parity for the incremental forward: prefill then decode against the
full forward of ``falcon-mamba-7b_smoke`` and ``hymba-1.5b_smoke`` (and of
``qwen3-0.6b_smoke`` and ``deepseek-v2-lite-16b_smoke``, on the dense
layout), the port's and the reference's full and incremental forwards and
their caches, with the reference's weights carried across by
``repro_torch.interop``. The SSM mixer, scan, init and surgery are in
``test_torch_ssm.py``.

Tolerances, f32 on both sides: incremental against full within the
reference's 2e-3; the port against the reference within ``1e-5`` abs +
``1e-5`` rel (the frameworks order sums differently and their exp / log1p
differ in the last bit)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig, get_config
from repro.models import forward as j_forward
from repro.models import init as j_init
from repro.models import init_caches as j_init_caches
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import get_config as t_get_config
from repro_torch.interop import flat_leaves, params_from_reference, to_numpy
from repro_torch.models import forward, init_caches

torch.set_float32_matmul_precision("highest")

RC_KW = dict(dtype="float32", param_dtype="float32", remat="none")
ATOL, RTOL = 1e-6, 1e-5
SSM, HYBRID = "falcon-mamba-7b_smoke", "hymba-1.5b_smoke"


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=atol, rtol=rtol)


# ---------------------------------------------------------------- forward
ARCHS = [SSM, HYBRID, "qwen3-0.6b_smoke", "deepseek-v2-lite-16b_smoke"]


def _arch_cfgs(arch):
    cfg, tcfg = get_config(arch), t_get_config(arch)
    if cfg.num_experts:
        # capacity depends on S, so a different S drops different tokens:
        # make dispatch dropless to isolate cache correctness (as the
        # reference's test does)
        cfg, tcfg = cfg.replace(capacity_factor=16.0), tcfg.replace(capacity_factor=16.0)
    return cfg, tcfg


@pytest.mark.parametrize("arch", ARCHS)
def test_incremental_matches_full_and_reference(arch):
    """Mirrors the reference's ``test_incremental_matches_full`` on the
    dense layout: prefill(T) then T+1.. decode gives the full forward's
    hidden states (the reference's 2e-3), and the port's full and
    incremental forwards match the reference's own within 1e-5."""
    cfg, tcfg = _arch_cfgs(arch)
    rc, trc = RunConfig(**RC_KW), TRunConfig(**RC_KW)
    params = j_init(cfg, rc, jax.random.PRNGKey(0))
    tparams = params_from_reference(jax.tree.map(np.asarray, params), device="cpu")
    B, T, extra = 2, 8, 4
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, T + extra)).astype(np.int32)

    want_full, _, _ = j_forward(cfg, rc, params, {"tokens": jnp.asarray(toks)})
    caches = j_init_caches(cfg, rc, B, T + extra)
    _, caches, _ = j_forward(cfg, rc, params, {"tokens": jnp.asarray(toks[:, :T])},
                             caches=caches, cache_pos=0)
    want_inc = []
    for i in range(extra):
        h1, caches, _ = j_forward(cfg, rc, params,
                                  {"tokens": jnp.asarray(toks[:, T + i:T + i + 1])},
                                  caches=caches, cache_pos=T + i)
        want_inc.append(np.asarray(h1))

    tt = torch.from_numpy(toks)
    with torch.no_grad():
        full, none, _ = forward(tcfg, trc, tparams, {"tokens": tt})
        assert none is None
        tc = init_caches(tcfg, trc, B, T + extra, device="cpu")
        _, tc, _ = forward(tcfg, trc, tparams, {"tokens": tt[:, :T]}, caches=tc, cache_pos=0)
        inc = []
        for i in range(extra):
            h1, tc, _ = forward(tcfg, trc, tparams, {"tokens": tt[:, T + i:T + i + 1]},
                                caches=tc, cache_pos=T + i)
            inc.append(h1)
    inc = torch.cat(inc, 1)
    np.testing.assert_allclose(to_numpy(inc), to_numpy(full[:, T:]), rtol=2e-3, atol=2e-3)
    _close(full, want_full, atol=1e-5)
    _close(inc, np.concatenate(want_inc, 1), atol=1e-5)
    # the caches after the run: KV codes and SSM state as the reference's
    want_c, got_c = flat_leaves(jax.tree.map(np.asarray, caches)), flat_leaves(tc)
    assert got_c.keys() == want_c.keys()
    for k, v in want_c.items():
        np.testing.assert_allclose(got_c[k], v, atol=1e-5, rtol=1e-5, err_msg=k)
