"""Port parity for the quantization front end: scales (the reference's
reciprocal-multiply form), int8 KV quantization (its division form), and a
QuantPolicy serialized by the reference loading in the port."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import _quantize_kv as j_quantize_kv
from repro.quant.policy import QuantPolicy as JPolicy
from repro.quant.quantize import compute_scale as j_compute_scale
from repro.quant.quantize import fused_scales as j_fused_scales
from repro_torch.models.attention import _quantize_kv as t_quantize_kv
from repro_torch.quant.policy import PolicyError
from repro_torch.quant.policy import QuantPolicy as TPolicy
from repro_torch.quant.quantize import compute_scale as t_compute_scale
from repro_torch.quant.quantize import fused_scales as t_fused_scales


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("axis", [None, 0, 1])
def test_compute_scale_bitexact(bits, axis):
    x = (np.random.default_rng(bits).standard_normal((13, 29)) * 3).astype(np.float32)
    x[2, 3] = 0.0
    j = np.asarray(j_compute_scale(jnp.asarray(x), bits, axis=axis))
    t = t_compute_scale(torch.from_numpy(x), bits, axis=axis).numpy()
    np.testing.assert_array_equal(j, t)


@pytest.mark.parametrize("per_token", [False, True])
@pytest.mark.parametrize("bits", [8, 2])
def test_fused_scales_bitexact(bits, per_token):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((17, 40)).astype(np.float32)
    w = (rng.standard_normal((40, 24)) * 0.05).astype(np.float32)
    w[:, 5] = 0.0    # an all-zero column takes the 1e-8 floor
    js = j_fused_scales(jnp.asarray(x), jnp.asarray(w), bits, per_token)
    ts = t_fused_scales(torch.from_numpy(x), torch.from_numpy(w), bits, per_token)
    for a, b in zip(js, ts):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("shape", [(3, 7, 2, 16), (2, 5, 64)])
def test_quantize_kv_bitexact(shape):
    x = (np.random.default_rng(11).standard_normal(shape) * 2).astype(np.float32)
    x[0, 1] = 0.0    # an all-zero token takes the 1e-8 floor
    jq, js = j_quantize_kv(jnp.asarray(x))
    tq, ts = t_quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())


@pytest.mark.parametrize("text", [
    "attn.*=int8,mlp.*=int2,*=bf16",
    "attn.*=int8:per_token:stats,mlp.down=int4,mlp.*=int2,*=bf16",
    "*=int8",
])
def test_policy_json_from_reference_loads(text):
    ref = JPolicy.parse(text)
    port = TPolicy.from_json(ref.to_json())
    assert port.to_json() == ref.to_json()
    assert port.describe() == ref.describe()
    for name in ("attn.q", "attn.o", "mlp.gate", "mlp.down", "lm_head"):
        a, b = ref.resolve(name), port.resolve(name)
        assert (a.kind, a.mode, a.bits, a.act_scale, a.collect_stats) == (
            b.kind, b.mode, b.bits, b.act_scale, b.collect_stats), name


def test_policy_rejects_reference_kernel_names():
    # the port's kernel paths are auto | torch | cuda; a Pallas path name
    # from the reference grammar is refused instead of silently ignored
    with pytest.raises(PolicyError):
        TPolicy.parse("attn.*=int8:pallas,*=bf16")
    assert TPolicy.parse("attn.*=int8:cuda,*=bf16").rules[0].impl == "cuda"
