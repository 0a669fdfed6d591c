"""Port parity for the unfused expert route: ``qlinear.dense`` on an MoE
expert stack under an ``unfused`` rule, and the expert axis of the int8
and plane-packed GEMMs under it, against the reference's ``vmap`` of
``dense(..., fused=False)`` (``repro/models/moe.py::_expert_mm``) on the
same seeded numpy operands: the reference's kernels on its XLA twins and in
interpret-mode Pallas, the port's on its plain versions on the CPU.

Everything here is exact (but an f32 output with a bias, held to the
FMA bound of ``tests/test_torch_qlinear.py``). Under the reference's ``vmap`` a per-tensor
activation scale is per expert, taken over that expert's M rows (empty
dispatch slots and an expert that received no token included), so the
port's one call over the stack must give each expert its own scale: the
scales, y and every stats field are compared bit for bit. The dynamic
route's stats carry an (E,) axis and are pushed once, as the reference
re-pushes them after its ``vmap``; the prequant route has none (the
reference's unfused prequant GEMM returns no stats) and pushes nothing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.quant import capture as j_capture
from repro.quant.qlinear import GemmBackend as JBackend
from repro.quant.qlinear import QBits as JQBits
from repro.quant.qlinear import dense as j_dense
from repro.quant.quantize import compute_scale as j_compute_scale
from repro.quant.surgery import _prequant_leaf as j_prequant_leaf
from repro_torch.kernels import ops
from repro_torch.kernels.tugemm_int8 import tugemm_int8
from repro_torch.kernels.tugemm_packed import tugemm_packed
from repro_torch.quant import capture as t_capture
from repro_torch.quant.qlinear import GemmBackend as TBackend
from repro_torch.quant.qlinear import QBits as TQBits
from repro_torch.quant.qlinear import dense as t_dense
from repro_torch.quant.quantize import fused_scales as t_fused_scales
from repro_torch.quant.surgery import _prequant_leaf as t_prequant_leaf

torch.set_float32_matmul_precision("highest")
IMPLS = ["xla", "pallas_interpret"]
KIND = {8: "int8", 4: "int4", 2: "int2"}
E, M, K, N = 3, 8, 40, 24


def _operands(seed, bias=False):
    """x (E, M, K) f32 with two empty slots an expert and expert 1 empty
    (as the dispatch leaves them), w (E, K, N) f32, bias (E, N) or None."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((E, M, K)).astype(np.float32)
    x[:, M - 2:] = 0
    x[1] = 0
    w = (rng.standard_normal((E, K, N)) * 0.1).astype(np.float32)
    b = rng.standard_normal((E, N)).astype(np.float32) if bias else None
    return x, w, b


def _int8_operands(seed, bits=8):
    rng = np.random.default_rng(seed)
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    a = rng.integers(-128, 128, (E, M, K)).astype(np.int8)
    b = rng.integers(lo, hi + 1, (E, K, N)).astype(np.int8)
    return a, b


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("bits,per_token,bias", [(8, False, False), (2, False, True),
                                                 (8, True, True), (2, True, False)])
def test_dynamic_unfused_experts_match_reference_vmap(impl, bits, per_token, bias):
    """The dynamic unfused route over an expert stack: y and every stats
    field equal the reference's vmap, bit for bit (y with a bias within the
    documented FMA bound)."""
    x, w, b = _operands(1, bias)
    act = "token" if per_token else "tensor"
    be = JBackend(KIND[bits], "dynamic", fused=False, impl=impl, act_scale=act)

    def one(wi, xi, bi=None):
        leaf = {"kernel": wi} if bi is None else {"kernel": wi, "bias": bi}
        return j_dense(leaf, xi, backend=be, name="moe.up", return_stats=True)

    args = (jnp.asarray(w), jnp.asarray(x)) + (() if b is None else (jnp.asarray(b),))
    jy, jst = jax.vmap(one)(*args)
    leaf = {"kernel": torch.from_numpy(w)}
    if b is not None:
        leaf["bias"] = torch.from_numpy(b)
    tbe = TBackend(KIND[bits], fused=False, act_scale=act)
    y, st = t_dense(leaf, torch.from_numpy(x), backend=tbe, name="moe.up", return_stats=True)
    if b is None:
        np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    else:
        # XLA contracts the reference's dequant multiply + bias add into an
        # FMA; the port rounds the product first (ROADMAP C, "f32 output
        # with a bias"): within ulp(y without bias) + ulp(y)
        y0 = t_dense({"kernel": leaf["kernel"]}, torch.from_numpy(x), backend=tbe,
                     name="moe.up").numpy()
        assert (np.abs(np.asarray(jy) - y.numpy())
                <= np.spacing(np.abs(y0)) + np.spacing(np.abs(y.numpy()))).all()
    assert st.serial_cycles.shape == (E,) and st.step_cycles.shape == (E, K)
    for f, jf in zip(st, jst):
        np.testing.assert_array_equal(f.numpy(), np.asarray(jf))


@pytest.mark.parametrize("per_token", [False, True])
@pytest.mark.parametrize("bits", [8, 2])
def test_unfused_expert_scales_are_per_expert(bits, per_token):
    """The route's scales against the reference's per-expert
    ``compute_scale`` under vmap: sx over each expert's own M rows (the
    empty expert through the 1e-8 guard), sw per column per expert."""
    x, w, _ = _operands(2)
    sx, sw = t_fused_scales(torch.from_numpy(x), torch.from_numpy(w), bits, per_token)
    jsx = jax.vmap(lambda xi: j_compute_scale(xi, bits, axis=0 if per_token else None))(
        jnp.asarray(x))
    jsw = jax.vmap(lambda wi: j_compute_scale(wi, bits, axis=1))(jnp.asarray(w))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx))
    np.testing.assert_array_equal(sw.numpy(), np.asarray(jsw))
    whole = t_fused_scales(torch.from_numpy(x).reshape(E * M, K), torch.from_numpy(w[0]),
                           bits)[0]
    if not per_token:
        assert sx.shape == (E,) and not torch.equal(sx, whole.expand(E))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("bits", [8, 4, 2])
def test_prequant_unfused_experts_match_reference_vmap(impl, bits):
    """A surgered expert stack (int8 leaves, or int4 / int2 planes) under
    an unfused prequant rule: y exact against the reference's vmap; neither
    returns stats."""
    x, w, _ = _operands(3)
    jleaf = j_prequant_leaf(jnp.asarray(w), bits)
    be = JBackend(KIND[bits], "prequant", fused=False, impl=impl)
    fn = lambda qk, qs, xi: j_dense(  # noqa: E731
        {"qkernel": qk, "qscale": qs, "qbits": JQBits(bits)}, xi, backend=be, name="moe.down",
        return_stats=True)
    jy, jst = jax.vmap(fn)(jleaf["qkernel"], jleaf["qscale"], jnp.asarray(x))
    tleaf = {**t_prequant_leaf(torch.from_numpy(w), bits), "qbits": TQBits(bits)}
    y, st = t_dense(tleaf, torch.from_numpy(x), backend=TBackend(KIND[bits], "prequant",
                                                                 fused=False),
                    name="moe.down", return_stats=True)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    assert st is None and jst is None


@pytest.mark.parametrize("prequant", [False, True])
def test_unfused_expert_route_pushes_as_reference(prequant):
    """Under a capture: the dynamic route pushes one entry with (E,)-leading
    stats and M = the expert's rows, the reference's re-push after its vmap;
    the prequant route pushes nothing. One int8 / packed GEMM call a stack
    (the plain version's counter), not E."""
    from repro.models.moe import _expert_mm as j_expert_mm

    x, w, _ = _operands(4)
    if prequant:
        jw = {**j_prequant_leaf(jnp.asarray(w), 2), "qbits": JQBits(2)}
        tw = {**t_prequant_leaf(torch.from_numpy(w), 2), "qbits": TQBits(2)}
        jbe, tbe = JBackend("int2", "prequant", fused=False), TBackend("int2", "prequant",
                                                                       fused=False)
    else:
        jw, tw = jnp.asarray(w), torch.from_numpy(w)
        jbe, tbe = JBackend("int8", fused=False), TBackend("int8", fused=False)
    with j_capture.capture_stats() as jcap:
        jy = j_expert_mm(jw, jnp.asarray(x), jbe, "moe.gate")
    ops.reset_counts()
    with t_capture.capture_stats() as tcap:
        y = t_dense(tw if prequant else {"kernel": tw}, torch.from_numpy(x), backend=tbe,
                    name="moe.gate")
    counts = ops.kernel_counts()
    ops.reset_counts()
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    gemm = "tugemm_packed" if prequant else "tugemm_int8"
    assert counts[gemm]["plain_calls"] == 1
    assert counts["tugemm_stats"]["plain_calls"] == (0 if prequant else 1)
    jents = [e for _, e in j_capture.tree_entries(jcap.tree)]
    assert len(tcap.entries) == len(jents) == (0 if prequant else 1)
    for te, je in zip(tcap.entries, jents):
        assert (te.name, te.M, te.K, te.N, te.bits) == (je.name, je.M, je.K, je.N, je.bits)
        for f, jf in zip(te.stats, je.stats):
            np.testing.assert_array_equal(f.numpy(), np.asarray(jf))


@pytest.mark.parametrize("with_c", [False, True])
@pytest.mark.parametrize("impl", IMPLS)
def test_int8_gemm_over_experts_matches_reference_vmap(impl, with_c):
    """``ops.matmul_int8`` over a leading expert axis (one plain call, one
    stats assembly) against the reference's vmapped ``matmul_int8``: y and
    the stats exactly; C per expert."""
    a, b = _int8_operands(5)
    c = np.random.default_rng(6).integers(-999, 999, (E, M, N)).astype(np.int32)
    ta, tb, tc = torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)
    y = ops.matmul_int8(ta, tb, tc if with_c else None)
    jy = jax.vmap(lambda ai, bi, ci: jops.matmul_int8(ai, bi, ci if with_c else None,
                                                     impl=impl))(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(c))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    ops.reset_counts()
    y, st = ops.matmul_int8(ta, tb, collect_stats=True)
    counts = ops.kernel_counts()
    ops.reset_counts()
    assert counts["tugemm_int8"]["plain_calls"] == 1
    assert counts["tugemm_stats"]["plain_calls"] == 1
    jy, jst = jax.vmap(lambda ai, bi: jops.matmul_int8(ai, bi, collect_stats=True, impl=impl))(
        jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    for f, jf in zip(st, jst):
        np.testing.assert_array_equal(f.numpy(), np.asarray(jf))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("bits,k", [(4, 40), (2, 40), (2, 37)])
def test_packed_gemm_over_experts_matches_reference_vmap(impl, bits, k):
    """``ops.matmul_packed`` over a leading expert axis against the
    reference's vmapped ``matmul_packed``, exactly; K off the plane
    multiple (37) reads A's missing columns as zeros."""
    a, b = _int8_operands(7, bits)
    a = a[..., :k]
    packed = torch.stack([ops.pack_weights(torch.from_numpy(bi), bits) for bi in b])
    y = ops.matmul_packed(torch.from_numpy(np.ascontiguousarray(a)), packed, bits=bits)
    jy = jax.vmap(lambda ai, pi: jops.matmul_packed(ai, pi, bits=bits, impl=impl))(
        jnp.asarray(a), jnp.asarray(packed.numpy()))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))


def test_batched_plain_int_gemms_are_e_single_calls():
    """The wrappers' plain versions over a leading expert axis equal E
    single calls bit for bit: the int8 GEMM's y, C and stats maxima (ca
    (E, 1, K), rb (E, K, 1)); the packed GEMM's y."""
    a, b = _int8_operands(8)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    c = torch.from_numpy(np.random.default_rng(9).integers(-9, 9, (E, M, N)).astype(np.int32))
    y, ca, rb = tugemm_int8(ta, tb, c, collect_stats=True, impl="torch")
    assert ca.shape == (E, 1, K) and rb.shape == (E, K, 1)
    packed = torch.stack([ops.pack_weights(bi.clamp(-2, 1), 2) for bi in tb])
    yp = tugemm_packed(ta[..., :K - 3].contiguous(), packed, bits=2, impl="torch")
    for e in range(E):
        ye, cae, rbe = tugemm_int8(ta[e], tb[e], c[e], collect_stats=True, impl="torch")
        assert torch.equal(y[e], ye) and torch.equal(ca[e], cae) and torch.equal(rb[e], rbe)
        assert torch.equal(yp[e], tugemm_packed(ta[e, :, :K - 3].contiguous(), packed[e],
                                                bits=2, impl="torch"))
    ops.reset_counts()
