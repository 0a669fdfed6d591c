"""Port parity for the rest of ``quant/``: ``QuantPolicy.compile``,
``uniform``, ``bits_used``, ``ResolvedPolicy.bits_for``, ``QuantConfig`` and
``fake_quant`` against the reference's (``tests/test_policy.py``,
``tests/test_quant.py``), on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.quant import PolicyError as JPolicyError
from repro.quant import QuantConfig as JQuantConfig
from repro.quant import QuantPolicy as JQuantPolicy
from repro.quant import fake_quant as j_fake_quant
from repro_torch.quant import PolicyError, QuantConfig, QuantPolicy, ResolvedPolicy, fake_quant

MIXED = "attn.*=int8,mlp.*=int2,*=bf16"
NAMES = ["attn.q", "attn.k", "attn.v", "attn.o", "mlp.gate", "mlp.up", "mlp.down", "lm_head"]
SPECS = [MIXED, "mlp.*=int4:prequant,*=int8:unfused:stats", "attn.q=int2,attn.*=int8,*=bf16",
         "*=int4", "*=bf16", "moe.*=int2:prequant,mla.*=int8,*=bf16"]


@pytest.mark.parametrize("text", SPECS)
def test_bits_used_matches_reference(text):
    assert QuantPolicy.parse(text).bits_used() == JQuantPolicy.parse(text).bits_used()


def test_bits_used_mixed():
    assert QuantPolicy.parse(MIXED).bits_used() == (8, 2)


def test_compile_builds_table_and_validates():
    """The reference's ``test_compile_builds_table_and_validates``: the
    table resolves every name as ``resolve`` does, ``bits_for`` reads it,
    and a rule that matches nothing raises."""
    p, jp = QuantPolicy.parse(MIXED), JQuantPolicy.parse(MIXED)
    rp, jrp = p.compile(NAMES), jp.compile(NAMES)
    assert isinstance(rp, ResolvedPolicy)
    for n in NAMES:
        assert rp.for_gemm(n) == p.resolve(n)
        assert rp.bits_for(n) == jrp.bits_for(n)
    assert rp.bits_for("mlp.down") == 2 and rp.bits_for("attn.v") == 8
    with pytest.raises(PolicyError):
        p.compile(["lm_head"])
    with pytest.raises(JPolicyError):
        jp.compile(["lm_head"])


@pytest.mark.parametrize("names", [
    ["attn.q", "attn.k"],
    [("attn.q", "groups.0.k0.attn.wq"), ("mlp.up", "groups.0.k0.ffn.w_up")],
])
def test_compile_shadowed_and_path_pairs_like_reference(names):
    """A shadowed rule raises in both packages; (name, path) pairs feed
    validation only and the table keys by name."""
    shadowed = "attn.*=int8,attn.q=int2,*=bf16"
    with pytest.raises(PolicyError, match="unreachable"):
        QuantPolicy.parse(shadowed).compile(names)
    with pytest.raises(JPolicyError, match="unreachable"):
        JQuantPolicy.parse(shadowed).compile(names)
    ok = "attn.*=int8,*=bf16" if isinstance(names[0], str) else MIXED
    rp, jrp = QuantPolicy.parse(ok).compile(names), JQuantPolicy.parse(ok).compile(names)
    for n in names:
        n = n if isinstance(n, str) else n[0]
        assert rp.bits_for(n) == jrp.bits_for(n)


@pytest.mark.parametrize("kind", ["int8", "int4", "int2", "bf16", 8, 4, 2, 16])
@pytest.mark.parametrize("mode", ["dynamic", "prequant"])
def test_uniform_matches_reference(kind, mode):
    p, jp = QuantPolicy.uniform(kind, mode), JQuantPolicy.uniform(kind, mode)
    assert p.describe() == jp.describe()
    assert p.to_json() == jp.to_json()
    assert p.bits_used() == jp.bits_used()
    assert p.any_prequant == jp.any_prequant and p.is_quant == jp.is_quant


def test_uniform_rejects_unknown_kind():
    with pytest.raises(PolicyError):
        QuantPolicy.uniform("int7")


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quant_config_like_reference(bits):
    c, jc = QuantConfig(bits=bits), JQuantConfig(bits=bits)
    assert (c.bits, c.per_channel, c.percentile, c.mode) == (
        jc.bits, jc.per_channel, jc.percentile, jc.mode)


@pytest.mark.parametrize("bits", [1, 3, 16])
def test_quant_config_rejects_bits(bits):
    with pytest.raises(ValueError, match="bits must be one of 2/4/8"):
        QuantConfig(bits=bits)
    with pytest.raises(ValueError):
        JQuantConfig(bits=bits)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("axis", [None, 0, 1])
def test_fake_quant_bitexact(bits, axis):
    """The quantize-dequantize value equals the reference's bit for bit."""
    rng = np.random.default_rng(2)
    w = (rng.normal(0, 1, (64, 32)) * rng.uniform(0.01, 3.0, (1, 32))).astype(np.float32)
    got = fake_quant(torch.from_numpy(w), bits, axis=axis).numpy()
    want = np.asarray(j_fake_quant(jnp.asarray(w), bits, axis=axis))
    np.testing.assert_array_equal(got, want)


def test_fake_quant_per_channel_beats_per_tensor():
    """The reference's ``test_per_channel_beats_per_tensor`` on the port."""
    rng = np.random.default_rng(2)
    w = torch.from_numpy((rng.normal(0, 1, (64, 32))
                          * rng.uniform(0.01, 3.0, (1, 32))).astype(np.float32))
    e_pt = (fake_quant(w, 4) - w).abs().mean()
    e_pc = (fake_quant(w, 4, axis=1) - w).abs().mean()
    assert float(e_pc) < float(e_pt)


def test_fake_quant_keeps_dtype():
    x = torch.randn(8, 16, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    assert fake_quant(x, 8).dtype == torch.bfloat16
