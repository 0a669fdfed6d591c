"""GEMM backend registry — every linear layer of the model routes here.

``gemm``/``dense`` accept a concrete :class:`GemmBackend` or a policy
object (``quant.policy`` — anything with ``for_gemm(name)``), resolved per
GEMM name, so one forward mixes int8 attention, int2 MLPs and bf16 heads.

- ``bf16``: plain ``torch.matmul`` in the activation dtype.
- ``int8|int4|int2`` dynamic: activation scale (per-tensor, or per-row with
  ``act_scale="token"``) and per-out-channel weight scale from one
  :func:`~repro_torch.quant.quantize.fused_scales` call, then ONE fused
  ``ops.matmul_fused`` pass that quantizes on load, accumulates exactly in
  int32, applies the dequant epilogue and bias, and — when stats are wanted
  — emits the tuGEMM cycle statistics from the same pass.

This slice serves the fused dynamic path. Offline prequantized weights
(``qkernel`` leaves) and the legacy unfused pipeline belong to later slices
and raise ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..kernels import ops
from . import capture
from .quantize import fused_scales

__all__ = ["GemmBackend", "BF16", "gemm", "dense"]


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


def _bf16_gemm(x, w, bias):
    y = torch.matmul(x, w.to(x.dtype))
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


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
    """x (..., K) · w (K, N) [+ bias (N,)] -> (..., N), in x.dtype.

    ``impl`` is the caller's kernel path; a backend whose own ``impl`` is
    not ``auto`` overrides it. ``return_stats=True`` returns
    ``(y, TuGemmStats | None)`` (None on the bf16 path)."""
    backend = backend.for_gemm(name)
    if backend.kind == "bf16":
        y = _bf16_gemm(x, w, bias)
        return (y, None) if return_stats else y
    if backend.mode != "dynamic" or not backend.fused:
        raise NotImplementedError(
            f"GEMM {name!r}: {backend.kind}:{backend.mode}"
            f"{'' if backend.fused else ':unfused'} is not ported yet; the port "
            "serves the fused dynamic path"
        )
    bits = backend.bits
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    sx, sw = fused_scales(x2, w, bits, backend.act_scale == "token")
    want = backend.collect_stats or return_stats or capture.stats_wanted()
    out = ops.matmul_fused(
        x2, w, sx=sx, sw=sw, bias=bias, bits=bits, collect_stats=want,
        impl=backend.impl if backend.impl != "auto" else impl, name=name,
    )
    y, stats = out if want else (out, None)
    if stats is not None and not return_stats:
        capture.push(name, x2.shape[0], x2.shape[1], w.shape[1], stats, bits=bits)
    y = y.reshape(*lead, w.shape[1])
    return (y, stats) if return_stats else y


def dense(
    params: dict,
    x: torch.Tensor,
    *,
    backend=BF16,
    name: str = "dense",
    return_stats: bool = False,
    impl: str = "auto",
):
    """Linear layer over a param leaf dict ``{'kernel': (K, N) [, 'bias']}``."""
    if "qkernel" in params:
        raise NotImplementedError(
            f"GEMM {name!r}: prequantized (qkernel) leaves are not ported yet")
    return gemm(x, params["kernel"], backend=backend, name=name,
                bias=params.get("bias"), return_stats=return_stats, impl=impl)
