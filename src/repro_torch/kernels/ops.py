"""Public kernel entry points with device dispatch and path counters.

``impl`` selects the path of every kernel call: ``auto`` launches the
hand-written CUDA kernel for CUDA tensors and runs the plain PyTorch
version for CPU tensors; ``torch`` runs the plain version on any device;
``cuda`` insists on the kernel. A CUDA tensor under ``auto`` launches or
raises — there is no fallback. A ``meta`` tensor (the dry-run) under
``auto`` takes each kernel's meta path: empty outputs of the right shapes,
and one op charged at the kernel's own count (``roofline.kernel_cost``).
No ``impl`` value asks for that path: the tensor alone decides it.

Three kinds of counters answer "which path did the work take":
``kernel_counts()`` reads each kernel's launch counter and its plain
version's call counter (one entry per kernel wrapper: the eight TPU
kernels' counterparts, then ``tugemm_stats`` and ``unary_step_stats``);
``record_path``/``path_counts`` count, per GEMM or attention call-site
name, how many calls went down each path; and
``counting_dispatches`` lists, under the reference's names, the
operand-sized passes a GEMM pipeline makes (the fused pipeline's two
against the unfused one's six or more). Inside :func:`quiet_records` (the
recomputation of a rematerialized block, ``models/transformer.py``) the
path and dispatch records, the stats capture and the debug collector
record nothing: they hold what the forward recorded once.

No kernel has a backward (the reference's ``pallas_call`` has no
reverse-mode rule either). On the CUDA path :func:`resolve_path` refuses
an operand that requires grad while grad is enabled, instead of returning
an output that silently drops the gradient; the plain versions on the CPU
are differentiable where the reference's XLA twins are (the dequant scales
and the bias; rounding cuts the rest).

A GEMM's cycle statistics on the card: ``matmul_fused`` and
``matmul_int8(collect_stats=True)`` take the step maxima from the GEMM's own
tiles (one launch, after one memset) and ``unary_stats.tugemm_stats``
assembles ``TuGemmStats`` in one more launch; ``unary_step_stats`` takes
both operands' maxima in one launch and assembles them the same way. The
plain path takes the same route through each wrapper's plain version.
"""

from __future__ import annotations

from collections import Counter
from contextlib import contextmanager

import torch

from ..core.tugemm import TuGemmStats
from . import flash_paged as _flash
from . import quantize as _quantize
from . import temporal_unary as _temporal
from . import tugemm_fused as _tugemm
from . import tugemm_int8 as _int8
from . import tugemm_packed as _packed
from . import unary_stats as _stats
from .packing import PLANES, pack_planes, pad_to_multiple

__all__ = [
    "matmul_fused",
    "matmul_int8",
    "matmul_packed",
    "unary_step_stats",
    "temporal_gemm",
    "quantize_sym",
    "pack_weights",
    "count_dispatch",
    "counting_dispatches",
    "record_path",
    "kernel_impl",
    "path_counts",
    "kernel_counts",
    "kernel_counters",
    "kernel_counters_since",
    "add_counters",
    "reset_counts",
    "quiet_records",
    "recording",
]

_COUNTS = (_tugemm.COUNT, _flash.COUNT, _int8.COUNT, _packed.COUNT,
           _stats.COL_COUNT, _stats.ROW_COUNT, _quantize.COUNT, _temporal.COUNT,
           _stats.FINISH_COUNT, _stats.PAIR_COUNT)
_paths: Counter = Counter()
_dispatch_log: list[str] | None = None
_quiet = 0


@contextmanager
def quiet_records():
    """Record nothing inside (nestable): no path, dispatch, capture or
    debug-collector entry."""
    global _quiet
    _quiet += 1
    try:
        yield
    finally:
        _quiet -= 1


def recording() -> bool:
    """False inside :func:`quiet_records`."""
    return _quiet == 0


def count_dispatch(name: str) -> None:
    """Register one operand-sized device pass named ``name`` (only inside
    :func:`counting_dispatches`)."""
    if _dispatch_log is not None and not _quiet:
        _dispatch_log.append(name)


@contextmanager
def counting_dispatches():
    """Collect the pipeline's dispatch names into the yielded list."""
    global _dispatch_log
    prev, _dispatch_log = _dispatch_log, []
    try:
        yield _dispatch_log
    finally:
        _dispatch_log = prev


def record_path(name: str, path: str) -> None:
    """Count one call of ``name`` down ``path`` (cuda | torch)."""
    if not _quiet:
        _paths[(name, path)] += 1


def resolve_path(impl: str, t: torch.Tensor, *operands) -> str:
    """The path a call with ``impl`` takes for tensor ``t``: ``auto`` gives
    ``cuda`` on a CUDA tensor, ``meta`` on a meta tensor (the kernel's
    count charged, no data: ``roofline.op_cost``), else ``torch``; ``meta``
    is a path and no ``impl`` (a wrapper takes :func:`kernel_impl` of it). A CUDA path
    raises ``RuntimeError`` while grad is enabled and ``t`` or one of
    ``operands`` (tensors or None) requires grad: no kernel has a backward."""
    if impl == "auto":
        path = {"cuda": "cuda", "meta": "meta"}.get(t.device.type, "torch")
    elif impl in ("torch", "cuda"):
        path = impl
    else:
        raise ValueError(f"unknown impl {impl!r}")
    if path == "cuda" and torch.is_grad_enabled() and any(
            isinstance(o, torch.Tensor) and o.requires_grad for o in (t, *operands)):
        raise RuntimeError(
            "a tuGEMM CUDA kernel was called on an operand that requires grad: no TPU "
            "kernel has a backward, and the launch would drop the gradient. Train under "
            "a *=bf16 policy on the card, or run the plain versions (impl='torch')")
    return path


def kernel_impl(path: str) -> str:
    """The kernel wrapper's ``impl`` for a path from :func:`resolve_path`:
    the wrappers take ``meta`` from their ``auto`` on the meta tensor."""
    return "auto" if path == "meta" else path


def path_counts() -> dict:
    """{name: {path: calls}} since the last ``reset_counts``."""
    out: dict[str, dict[str, int]] = {}
    for (name, path), n in _paths.items():
        out.setdefault(name, {})[path] = n
    return out


def kernel_counts() -> dict:
    """{kernel: {"launches": n, "plain_calls": n}} since the last reset."""
    return {c.name: c.as_dict() for c in _COUNTS}


def kernel_counters() -> dict:
    """Snapshot of the process-wide counters: ``{"paths": {name: {path: n}},
    "kernels": {kernel: {"launches": n, "plain_calls": n}}}``. (The
    reference also keeps kernel-to-XLA fallbacks; the port has none: a CUDA
    tensor launches its kernel or raises.)"""
    return {"paths": path_counts(),
            "kernels": {k: dict(v) for k, v in kernel_counts().items()}}


def kernel_counters_since(base: dict) -> dict:
    """``kernel_counters()`` minus a baseline snapshot: the view one engine
    reports, so two schedulers in one process never claim each other's
    calls. Zero entries are dropped (a ``reset_counts`` since the baseline
    drops the rest)."""
    cur = kernel_counters()
    out: dict = {}
    for sec in ("paths", "kernels"):
        bs = base.get(sec, {})
        d: dict[str, dict[str, int]] = {}
        for name, by in cur[sec].items():
            bn = bs.get(name, {})
            row = {k: v - bn.get(k, 0) for k, v in by.items() if v - bn.get(k, 0) > 0}
            if row:
                d[name] = row
        out[sec] = d
    return out


def add_counters(delta: dict, sign: int = 1) -> None:
    """Add ``sign`` times a :func:`kernel_counters_since` delta to the
    process-wide counters: a CUDA graph of a serving step takes its
    capture's calls back out (the capture ran nothing) and adds them again
    on each replay (``serve/graphs.py``)."""
    for name, by in delta.get("paths", {}).items():
        for path, n in by.items():
            _paths[(name, path)] += sign * n
            if _paths[(name, path)] == 0:
                del _paths[(name, path)]
    counts = {c.name: c for c in _COUNTS}
    for name, by in delta.get("kernels", {}).items():
        c = counts[name]
        c.launches += sign * by.get("launches", 0)
        c.plain_calls += sign * by.get("plain_calls", 0)


def reset_counts() -> None:
    _paths.clear()
    for c in _COUNTS:
        c.reset()


def pack_weights(w: torch.Tensor, bits: int) -> torch.Tensor:
    """Offline weight packing for the sub-byte path (pads K to a plane
    multiple)."""
    if bits == 8:
        return w.to(torch.int8)
    return pack_planes(pad_to_multiple(w.to(torch.int8), 0, PLANES[bits]), bits)


def matmul_int8(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor | None = None, *,
                collect_stats: bool = False, impl: str = "auto"):
    """Exact int8 GEMM (the tuGEMM contract): A (M, K) · B (K, N) [+ C] ->
    (M, N) int32, or (y, TuGemmStats) when ``collect_stats``: the maxima
    come out of the GEMM (on the card, from its own tiles) and
    ``tugemm_stats`` assembles them. The reference's dispatch names are those
    of the GEMM then ``unary_step_stats``. A leading expert axis (A (E, M,
    K), B (E, K, N)) runs E GEMMs in one launch, and every stats field gets
    a leading (E,) axis, still from one ``tugemm_stats`` launch."""
    count_dispatch("matmul_int8")
    path = resolve_path(impl, a, b, c)
    if not collect_stats:
        return _int8.tugemm_int8(a, b, c, impl=kernel_impl(path))
    count_dispatch("absmax_a")
    count_dispatch("absmax_b")
    y, ca, rb = _int8.tugemm_int8(a, b, c, collect_stats=True, impl=kernel_impl(path))
    return y, TuGemmStats(*_stats.tugemm_stats(ca, rb, a.shape[-1], impl=kernel_impl(path)))


def unary_step_stats(a: torch.Tensor, b: torch.Tensor, *, impl: str = "auto") -> TuGemmStats:
    """tuGEMM data-dependent cycle statistics for A (M, K) @ B (K, N)."""
    count_dispatch("absmax_a")
    count_dispatch("absmax_b")
    return TuGemmStats(*_stats.unary_step_stats(a, b, impl=kernel_impl(resolve_path(impl, a, b))))


def matmul_packed(a: torch.Tensor, packed_b: torch.Tensor, *, bits: int,
                  impl: str = "auto") -> torch.Tensor:
    """A (M, K) int8 · plane-packed B (ceil(K/planes), N) -> (M, N) int32.
    A counts as zero-extended to ``planes * packed_b.shape[-2]`` columns
    (``pack_weights``' padding). A leading expert axis (A (E, M, K), B (E,
    Kp, N)) runs E GEMMs in one launch."""
    count_dispatch("matmul_packed")
    return _packed.tugemm_packed(a, packed_b, bits=bits,
                                  impl=kernel_impl(resolve_path(impl, a, packed_b)))


def temporal_gemm(a: torch.Tensor, b: torch.Tensor, *, bitwidth: int,
                  impl: str = "auto") -> torch.Tensor:
    """Thermometer-decomposed exact GEMM (the paper's C1 validation path):
    A (M, K) · B (K, N) -> (M, N) int32 as ``2**(w-1)`` unary steps. The
    kernel takes the operands cast to int8, as the reference's wrapper does;
    the plain version is a plain GEMM of the operands as given."""
    count_dispatch("temporal_gemm")
    path = resolve_path(impl, a, b)
    record_path("temporal_gemm", path)
    if path == "cuda":
        a, b = a.to(torch.int8).contiguous(), b.to(torch.int8).contiguous()
    return _temporal.temporal_unary_gemm(a, b, bitwidth=bitwidth, impl=kernel_impl(path))


def quantize_sym(x: torch.Tensor, scale, *, bitwidth: int, impl: str = "auto") -> torch.Tensor:
    """Symmetric quantization of x (M, N) by a per-tensor or per-column
    scale (a number, or a tensor of 1 or N values in any shape):
    ``clip(round(x · (1/scale)))`` with the reciprocal taken in f32, as the
    reference does. On the card the call is one launch: the scale goes to
    the kernel as given (a number as its f32 reciprocal, taken on the host)."""
    count_dispatch("quantize_sym")
    path = resolve_path(impl, x, scale)
    record_path("quantize_sym", path)
    if path == "cuda":
        x = x.contiguous()
    return _quantize.quantize_sym(x, scale, bitwidth=bitwidth, impl=kernel_impl(path))


def matmul_fused(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    sx: torch.Tensor,
    sw: torch.Tensor,
    bias: torch.Tensor | None = None,
    bits: int,
    w_quantized: bool = False,
    collect_stats: bool = False,
    out_dtype: torch.dtype | None = None,
    impl: str = "auto",
    name: str = "matmul_fused",
):
    """Fused dynamic-quant linear layer: ``Y = clip(round(X/sx)) @ Wq ·
    (sx·sw[n]) + bias`` with Wq quantized on load from float w (K, N)
    (``w_quantized=False``) or taken from storage: int8 (K, N) at 8 bits,
    plane-packed (ceil(K/planes), N) at 4/2 bits (``pack_weights`` layout).

    sx: per-tensor scalar or per-token (M,) vector; sw: per-column (N,).
    Returns y (M, N) ``out_dtype`` (default x.dtype), or (y, TuGemmStats)
    when ``collect_stats`` — the stats come out of the same pass.

    A leading expert axis (the MoE expert GEMMs) batches E GEMMs of one shape
    into one kernel launch: x (E, M, K), w (E, K|Kp, N), sx (E,) or (E, M),
    sw (E, N), bias (E, N); y (E, M, N) and TuGemmStats fields with a leading
    (E,) axis. It is recorded as one call of ``name``."""
    count_dispatch("matmul_fused")
    path = resolve_path(impl, x, w, sx, sw, bias)
    record_path(name, path)
    sx = torch.as_tensor(sx, dtype=torch.float32, device=x.device)
    lead = tuple(x.shape[:-2])
    E = lead[0] if lead else 1
    per_token = sx.numel() > E
    packed = w_quantized and bits < 8
    planes = PLANES[bits] if packed else 1
    w_mode = "packed" if packed else ("int8" if w_quantized else "quant")
    M, K = x.shape[-2:]
    Kw, N = w.shape[-2:]
    Klog = planes * Kw
    if ((K > Klog) if packed else (K != Kw)) or tuple(w.shape[:-2]) != lead:
        raise ValueError(f"x {tuple(x.shape)} does not match w {tuple(w.shape)} at {bits} bits")
    if packed and K < Klog:
        x = torch.nn.functional.pad(x, (0, Klog - K))
    out = _tugemm.tugemm_fused(
        x.contiguous(), w.contiguous(),
        sx.reshape(lead + ((-1, 1) if per_token else (1, 1))),
        sw.to(torch.float32).reshape(lead + (1, N)), bias,
        bits=bits, w_mode=w_mode, collect_stats=collect_stats,
        out_dtype=out_dtype if out_dtype is not None else x.dtype, impl=kernel_impl(path),
    )
    if not collect_stats:
        return out
    y, ca, rb = out
    # plane-major maxima; plane p holds the logical rows [p·Kw, (p+1)·Kw)
    return y, TuGemmStats(*_stats.tugemm_stats(ca, rb, K, impl=kernel_impl(path)))
