"""Port parity for training's gradients: ``loss_fn`` and every gradient
leaf on the ten registered ``_smoke`` archs (``ARCHS``), against the
reference's jitted ``value_and_grad`` on the same numpy batch, with the
reference's weights carried across by ``repro_torch.interop``. The rest of
training's parity (``*=int8`` gradients, remat, microbatches, steps,
checkpoints, the Trainer) is in ``test_torch_train.py``.

Tolerances (f32 on both sides; the frameworks order sums differently and
their exp/rsqrt/tanh differ in the last bit, nothing else): the loss and
the MoE aux loss to ``rtol=1e-5``; every gradient leaf to 1e-4 relative L2
(``_rel_l2``).
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig, get_config
from repro.models import init as j_init
from repro.models import loss_fn as j_loss
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import get_config as t_get_config
from repro_torch.interop import params_from_reference
from repro_torch.models import loss_fn
from repro_torch.tree import leaves, leaves_with_paths

torch.set_float32_matmul_precision("highest")

ARCHS = ["qwen3-0.6b_smoke", "deepseek-v2-lite-16b_smoke", "falcon-mamba-7b_smoke",
         "hymba-1.5b_smoke", "hubert-xlarge_smoke", "qwen2-vl-7b_smoke",
         "llama4-maverick-400b-a17b_smoke", "qwen3-8b_smoke", "qwen3-14b_smoke",
         "smollm-360m_smoke"]
F32 = dict(dtype="float32", param_dtype="float32")
GRAD_TOL = 1e-4


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


def _port_grads(tcfg, trc, tp, batch):
    flat = [t.requires_grad_(True) for t in leaves(tp)]
    total, metrics = loss_fn(tcfg, trc, tp, {k: torch.from_numpy(np.array(v))
                                             for k, v in batch.items()})
    grads = torch.autograd.grad(total, flat)
    return float(total.detach()), metrics, dict(zip([n for n, _ in leaves_with_paths(tp)],
                                           (g.numpy() for g in grads)))


def _ref_grads(cfg, rc, p, batch):
    (total, metrics), g = jax.jit(jax.value_and_grad(
        lambda q: j_loss(cfg, rc, q, {k: jax.numpy.asarray(v) for k, v in batch.items()}),
        has_aux=True))(p)
    return float(total), metrics, dict(leaves_with_paths(jax.tree.map(np.asarray, g)))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    cfg, tcfg, rc, trc, p, tp = _carried(arch, dict(F32, remat="none"))
    batch = _batch(cfg)
    jl, jm, jg = _ref_grads(cfg, rc, p, batch)
    tl, tm, tg = _port_grads(tcfg, trc, tp, batch)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(float(tm["aux"].detach()), float(jm["aux"]), rtol=1e-5,
                               atol=1e-7)
    assert sorted(tg) == sorted(jg)
    bad = {n: _rel_l2(tg[n], jg[n]) for n in jg if _rel_l2(tg[n], jg[n]) > GRAD_TOL}
    assert not bad, bad
