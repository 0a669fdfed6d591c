"""GEMM backend registry — every linear layer of the model routes here.

``gemm``/``dense`` accept a concrete :class:`GemmBackend` or a policy
object (``quant.policy`` — anything with ``for_gemm(name)``), resolved per
GEMM name, so one forward mixes int8 attention, int2 MLPs and bf16 heads.

- ``bf16``: plain ``torch.matmul`` in the activation dtype.
- ``int8|int4|int2``, the tuGEMM exact low-precision contract:
    * ``dynamic`` — activation scale (per-tensor, or per-row with
      ``act_scale="token"``) and per-out-channel weight scale computed on
      the fly, exact integer GEMM, dequantize.
    * ``prequant`` — weights quantized and plane-packed offline
      (``prequantize_tree`` / ``quant.surgery.apply_surgery``) into
      ``{'qkernel', 'qscale', 'qbits'}`` leaves.

The hot path is *fused*: one scale reduction and ONE ``ops.matmul_fused``
pass that quantizes on load, accumulates exactly in int32, applies the
dequant epilogue and bias, and — when stats are wanted — emits the tuGEMM
cycle statistics from the same pass. ``GemmBackend(fused=False)`` (policy
flag ``unfused``) keeps the legacy composition of separate passes — scales,
quantize X and W, ``ops.matmul_int8`` (with its stats when wanted: on the
card they come out of the int8 GEMM's own launch plus one assembly launch)
or ``ops.matmul_packed``, the dequant epilogue — bit-exact against the
fused path in outputs and stats.

Inside ``calibration.calibrating()`` every quantized GEMM's activation
absmax is observed first; under ``calibration.static_scales(reg)`` a GEMM
whose name is in ``reg`` takes the fixed per-tensor scale ``reg[name] / hi``
(both pipelines; ``_gemm_prequant`` consults no registry, as in the
reference).

Under a mesh program (``parallel.collectives``; the sharded serving step)
the scales are the mesh-global ones: the raw amax is max-merged over tp
when the GEMM's input features are tp-sharded (``prog.gather_gemms``) and
over dp when the scale is per tensor, then ``amax_to_scale``, which gives
the single-device ``fused_scales`` bit for bit. A gathered GEMM quantizes
its local feature chunk, puts the int plane on the wire (bit-packed below
8 bits) and runs the int8 GEMM with stats on the gathered full-K plane, then
the dequant epilogue; a gathered prequant GEMM hands the dequantized
full-K plane to the fused packed kernel (``round(q·s / s) == q`` in f32
for ``|q| <= 127``, so its on-load quantization reproduces the plane). A
gathered bf16 GEMM gathers its input at full precision.

An expert stack (a raw ``(E, K, N)`` kernel or its packed ``(E, Kp, N)``
leaf: the MoE expert GEMMs) takes x ``(E, M, K)`` and runs either pipeline
over all E experts at once, each expert with its own scales, as the
reference's ``vmap`` of ``dense`` runs them: a per-tensor activation scale
is per expert, over that expert's M rows (empty dispatch slots included).
The fused pipeline is one ``ops.matmul_fused`` launch; the unfused one
quantizes every expert's X and W, then one ``ops.matmul_int8`` (its stats
with an (E,) axis) or ``ops.matmul_packed`` launch over all experts, then
the dequant epilogue.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ..kernels import ops
from ..kernels.ref import dequant_bias_ref
from . import capture
from .calibration import active_scales, observe
from .quantize import (act_scale, amax_to_scale, compute_scale, fused_scales, int_range, quantize,
                       raw_amax, weight_scale)
from .stats import record_stats

__all__ = ["GemmBackend", "BF16", "QBits", "gemm", "dense", "prequantize_tree"]


@dataclass(frozen=True)
class GemmBackend:
    """A *resolved* per-GEMM spec: one precision, one mode, one kernel path."""

    kind: str = "bf16"            # bf16 | int8 | int4 | int2
    mode: str = "dynamic"         # dynamic | prequant (ignored for bf16)
    collect_stats: bool = False   # emit tuGEMM cycle stats per GEMM
    impl: str = "auto"            # kernel dispatch (kernels/ops.py)
    fused: bool = True            # one-pass pipeline (False = legacy unfused)
    act_scale: str = "tensor"     # "tensor" (batch-wide absmax) | "token"

    @property
    def bits(self) -> int:
        return {"bf16": 16, "int8": 8, "int4": 4, "int2": 2}[self.kind]

    def for_gemm(self, name: str) -> "GemmBackend":
        """A bare backend applies to every GEMM (the policy protocol)."""
        return self


BF16 = GemmBackend("bf16")


@dataclass(frozen=True)
class QBits:
    """Bitwidth marker inside a prequantized param leaf: the width its
    planes were packed at, so a mixed-precision tree stays self-describing
    (the leaf, not the runtime policy, decides the width it runs at)."""

    bits: int


def _impl(backend: GemmBackend, impl: str) -> str:
    """The kernel path: the caller's ``impl`` unless the rule pins one."""
    return backend.impl if backend.impl != "auto" else impl


def _want_stats(backend: GemmBackend, return_stats: bool) -> bool:
    """Stats come out of the pass when anyone wants them: the debug
    collector (``collect_stats``), the functional caller (``return_stats``)
    or an active capture."""
    return backend.collect_stats or return_stats or capture.stats_wanted()


def _sink_stats(stats, x2, N, backend: GemmBackend, name: str, return_stats: bool):
    """Route one GEMM's stats to the debug collector (one record a GEMM: an
    expert stack's stats carry a leading (E,) axis) and/or the capture
    (``return_stats=True``: the caller owns them, nothing is pushed)."""
    M, K = x2.shape[-2:]
    if backend.collect_stats:
        for a, s, p in zip(stats.act_max.reshape(-1), stats.serial_cycles.reshape(-1),
                           stats.parallel_cycles.reshape(-1)):
            record_stats(name, M, K, N, a, s, p, bits=backend.bits)
    if not return_stats:
        capture.push(name, M, K, N, stats, bits=backend.bits)


def _emit_fused(x2, w, sx, sw, bias, backend: GemmBackend, name: str, *,
                w_quantized: bool, return_stats: bool, impl: str, out_dtype=None):
    """One fused dispatch plus stats routing; returns (y, stats|None)."""
    want = _want_stats(backend, return_stats)
    out = ops.matmul_fused(
        x2, w, sx=sx, sw=sw, bias=bias, bits=backend.bits, w_quantized=w_quantized,
        collect_stats=want, out_dtype=out_dtype, impl=_impl(backend, impl), name=name,
    )
    if not want:
        return out, None
    y, stats = out
    _sink_stats(stats, x2, w.shape[-1], backend, name, return_stats)
    return y, stats


def _bf16_gemm(x, w, bias, name: str = "gemm"):
    prog = _mesh()
    if prog is None:
        return _plain_gemm(x, w, bias)
    # at the single-device row count (an expert stack's rows are axis 1);
    # the weight stays the rank's: no product moved with its columns or
    # experts
    return prog.at_full(f"gemm:{name}", _plain_gemm, (x, {int(w.ndim == 3): prog.dp}),
                        (w, {}), (bias, {}))


def _plain_gemm(x, w, bias):
    y = torch.matmul(x, w.to(x.dtype))
    if bias is not None:
        y = y + (bias if w.ndim == 2 else bias.unsqueeze(-2)).to(y.dtype)
    return y


def _mesh():
    """The active mesh program (``parallel.collectives``), or None."""
    from ..parallel import collectives

    return collectives.current_program()


def _mesh_act_scale(prog, x2: torch.Tensor, bits: int, per_token: bool, gathered: bool,
                    name: str) -> torch.Tensor:
    """The activation scale over the whole mesh: the local raw amax (per
    tensor, or per row), max-merged over tp when x's features are sharded
    and over dp when the scale is per tensor (rows are dp-sharded), in one
    ``all_reduce``. Consecutive GEMMs of one input (q, k, v; gate, up)
    share the sync, each metered as its own."""
    key = (x2.data_ptr(), tuple(x2.shape), tuple(x2.stride()), x2._version, per_token, gathered)
    hit = prog.memo is not None and prog.memo[0] == key
    amax = prog.memo[2] if hit else raw_amax(x2, axis=tuple(range(x2.ndim - 2 + per_token)))
    amax = prog.sync_amax(amax, name, tp=gathered, dp=not per_token, moved=not hit)
    prog.memo = (key, x2, amax)       # x2 held: its storage cannot be reused meanwhile
    return amax_to_scale(amax, bits)


def _lead_scale(s: torch.Tensor, ndim: int) -> torch.Tensor:
    """A scale of x's leading axes ((), (M,), (E,) or (E, M)) shaped to
    broadcast against x of ``ndim`` dims."""
    return s.reshape(s.shape + (1,) * (ndim - s.ndim))


def gemm(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    backend=BF16,
    name: str = "gemm",
    bias: torch.Tensor | None = None,
    return_stats: bool = False,
    impl: str = "auto",
):
    """x (..., K) · w (K, N) [+ bias (N,)] -> (..., N), in x.dtype; an
    expert stack x (E, M, K) · w (E, K, N) [+ bias (E, N)] -> (E, M, N).

    ``impl`` is the caller's kernel path; a backend whose own ``impl`` is
    not ``auto`` overrides it. ``return_stats=True`` returns
    ``(y, TuGemmStats | None)`` (None on the bf16 path). A float weight
    runs dynamic whatever the mode: a ``prequant`` rule on a leaf that was
    never packed quantizes on the fly, which is bit-exact with prequant."""
    backend = backend.for_gemm(name)
    prog = _mesh()
    gathered = prog is not None and name in prog.gather_gemms
    if backend.kind == "bf16":
        if gathered:
            # a bf16 GEMM on tp-sharded features gathers them at full precision
            x = prog.gather_features_f(x, name)
        y = _bf16_gemm(x, w, bias, name)
        return (y, None) if return_stats else y
    bits = backend.bits
    per_token = backend.act_scale == "token"
    lead = x.shape[:-1]
    x2 = x if w.ndim == 3 else x.reshape(-1, x.shape[-1])
    observe(name, x2)
    scales = active_scales()
    if scales is not None and name in scales:
        # static PTQ: the calibrated per-GEMM-name scale (a Python float
        # division, as the reference takes it), per tensor whatever
        # act_scale says; an expert stack shares it across its experts
        sx = torch.full(x2.shape[:-2], scales[name] / int_range(bits)[1],
                        dtype=torch.float32, device=x2.device)
        sw = weight_scale(w, bits)
        ops.count_dispatch("scale_w")
    elif prog is not None:
        sx = _mesh_act_scale(prog, x2, bits, per_token, gathered, name)
        sw = weight_scale(w, bits)
        ops.count_dispatch("scale_x")
        ops.count_dispatch("scale_w")
    else:
        sx, sw = fused_scales(x2, w, bits, per_token)
        if backend.fused:
            ops.count_dispatch("fused_scales")
        else:
            ops.count_dispatch("scale_x")
            ops.count_dispatch("scale_w")
    if gathered:
        # quantize-before-all-gather: quantize the local feature chunk with
        # the global scale, gather the int planes (bit-packed when sub-byte),
        # then the int8 GEMM with its stats on the full-K plane; bit-exact
        # against the single-device fused pass (the unfused composition is)
        path = _impl(backend, impl)
        xq = quantize(x2, _lead_scale(sx, x2.ndim), bits)
        wq = quantize(w, sw.unsqueeze(-2), bits)
        ops.count_dispatch("quantize_x")
        ops.count_dispatch("quantize_w")
        xq = prog.gather_features_quant(xq, bits, name)
        want = _want_stats(backend, return_stats)
        out = ops.matmul_int8(xq, wq, collect_stats=want, impl=path)
        y_int, stats = out if want else (out, None)
        if want:
            _sink_stats(stats, xq, w.shape[-1], backend, name, return_stats)
        y = dequant_bias_ref(y_int, sx, sw, bias, x.dtype)
        ops.count_dispatch("dequant_epilogue")
        y = y.reshape(*lead, w.shape[-1])
        return (y, stats) if return_stats else y
    if backend.fused:
        y, stats = _emit_fused(x2, w, sx, sw, bias, backend, name, w_quantized=False,
                               return_stats=return_stats, impl=impl)
        y = y.reshape(*lead, w.shape[-1])
        return (y, stats) if return_stats else y

    # ------------------------------------------------ legacy unfused pipeline
    # (an expert stack: every expert's scales and codes, then one launch)
    path = _impl(backend, impl)
    xq = quantize(x2, _lead_scale(sx, x2.ndim), bits)
    wq = quantize(w, sw.unsqueeze(-2), bits)
    ops.count_dispatch("quantize_x")
    ops.count_dispatch("quantize_w")
    want = _want_stats(backend, return_stats)
    out = ops.matmul_int8(xq, wq, collect_stats=want, impl=path)
    y_int, stats = out if want else (out, None)
    if want:
        # the stats come from the int8 operands; the record carries x's shape
        _sink_stats(stats, x2, w.shape[-1], backend, name, return_stats)
    y = dequant_bias_ref(y_int, sx, sw, bias, x.dtype)
    ops.count_dispatch("dequant_epilogue")
    y = y.reshape(*lead, w.shape[-1])
    return (y, stats) if return_stats else y


def _leaf_backend(leaf: dict, backend: GemmBackend) -> GemmBackend:
    """Reconcile a resolved backend with a packed leaf's own ``qbits``: the
    leaf decides the bitwidth (its planes were packed at that width). A
    leaf the runtime policy resolves to bf16 (path-pattern surgery) still
    runs prequant at its packed width."""
    qb = leaf.get("qbits")
    if qb is None:
        return backend
    kind = {8: "int8", 4: "int4", 2: "int2"}[qb.bits]
    if backend.kind == "bf16":
        return GemmBackend(kind, "prequant")
    if backend.kind != kind:
        return replace(backend, kind=kind)
    return backend


def _gemm_prequant(
    x: torch.Tensor,
    leaf: dict,
    backend: GemmBackend,
    name: str,
    bias: torch.Tensor | None = None,
    return_stats: bool = False,
    impl: str = "auto",
):
    backend = _leaf_backend(leaf, backend)
    bits = backend.bits
    per_token = backend.act_scale == "token"
    lead = x.shape[:-1]
    experts = leaf["qkernel"].ndim == 3
    x2 = x if experts else x.reshape(-1, x.shape[-1])
    prog = _mesh()
    gathered = prog is not None and name in prog.gather_gemms
    if prog is not None:
        sx = _mesh_act_scale(prog, x2, bits, per_token, gathered, name)
    else:
        sx = act_scale(x2, bits, per_token)
    ops.count_dispatch("scale_x")
    sw = leaf["qscale"]
    N = sw.shape[-1]
    if gathered:
        # quantize-before-all-gather into the fused packed-weight kernel:
        # the gathered plane goes in dequantized (f32) with the same scale,
        # so the kernel's on-load quantization reproduces it and its stats
        # are the full-K statistics (under an unfused rule too)
        xq = quantize(x2, _lead_scale(sx, x2.ndim), bits)
        ops.count_dispatch("quantize_x")
        xq = prog.gather_features_quant(xq, bits, name)
        xdq = xq.to(torch.float32) * _lead_scale(sx, xq.ndim)
        y, stats = _emit_fused(xdq, leaf["qkernel"], sx, sw, bias, backend, name,
                               w_quantized=True, return_stats=return_stats, impl=impl,
                               out_dtype=x.dtype)
        y = y.reshape(*lead, N)
        return (y, stats) if return_stats else y
    if backend.fused:
        # the plane decode runs inside the fused kernel, and real cycle
        # stats come out of the same pass
        y, stats = _emit_fused(x2, leaf["qkernel"], sx, sw, bias, backend, name,
                               w_quantized=True, return_stats=return_stats, impl=impl)
        y = y.reshape(*lead, N)
        return (y, stats) if return_stats else y

    path = _impl(backend, impl)
    xq = quantize(x2, _lead_scale(sx, x2.ndim), bits)
    ops.count_dispatch("quantize_x")
    if bits == 8:
        y_int = ops.matmul_int8(xq, leaf["qkernel"], impl=path)
    else:
        y_int = ops.matmul_packed(xq, leaf["qkernel"], bits=bits, impl=path)
    if backend.collect_stats:
        # the legacy path has no unpacked weights at hand: it records the
        # activation max only (one record an expert), with zero cycles, and
        # pushes nothing to a capture (the reference's behaviour; the fused
        # path does better)
        for xe in xq.reshape((-1,) + tuple(xq.shape[-2:])):
            record_stats(name, xe.shape[0], xe.shape[1], N, xe.abs().max(),
                         torch.zeros(()), torch.zeros(()), bits=backend.bits)
    y = dequant_bias_ref(y_int, sx, sw, bias, x.dtype)
    ops.count_dispatch("dequant_epilogue")
    y = y.reshape(*lead, N)
    return (y, None) if return_stats else y


def dense(
    params: dict,
    x: torch.Tensor,
    *,
    backend=BF16,
    name: str = "dense",
    return_stats: bool = False,
    impl: str = "auto",
):
    """Linear layer over a param leaf dict ``{'kernel': (K, N) [, 'bias']}``
    or its prequantized form ``{'qkernel', 'qscale' [, 'qbits'] [, 'bias']}``.
    ``return_stats=True`` -> ``(y, TuGemmStats | None)``.

    An expert stack — ``{'kernel': (E, K, N)}`` or a packed ``{'qkernel':
    (E, Kp, N), 'qscale': (E, N), 'qbits'}`` leaf — takes x (E, M, K) and
    runs all E GEMMs in one launch of either pipeline (stats fields with a
    leading (E,) axis)."""
    backend = backend.for_gemm(name)
    bias = params.get("bias")
    if "qkernel" in params:
        return _gemm_prequant(x, params, backend, name, bias=bias,
                              return_stats=return_stats, impl=impl)
    return gemm(x, params["kernel"], backend=backend, name=name, bias=bias,
                return_stats=return_stats, impl=impl)


def prequantize_tree(params, bits: int):
    """Offline PTQ: replace every ``{'kernel': (K, N)}`` linear leaf-dict
    with ``{'qkernel': packed int8, 'qscale': (N,) f32, 'qbits': QBits(bits)}``.
    Biases, norms and embeddings stay float. For per-layer mixed widths use
    ``quant.surgery.apply_surgery`` with a QuantPolicy."""

    def walk(node):
        if isinstance(node, dict):
            if "kernel" in node and getattr(node["kernel"], "ndim", 0) == 2:
                w = node["kernel"]
                sw = compute_scale(w, bits, axis=1)
                wq = quantize(w, sw.reshape(1, -1), bits)
                new = {"qkernel": ops.pack_weights(wq, bits), "qscale": sw,
                       "qbits": QBits(bits)}
                if "bias" in node:
                    new["bias"] = node["bias"]
                return new
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(params)
