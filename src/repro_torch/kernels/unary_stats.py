"""tuGEMM cycle statistics: CUDA kernels + plain versions.

Replaces ``repro/kernels/unary_stats.py::colabsmax_pallas`` and
``::rowabsmax_pallas`` (the TPU kernels) and the assembly of their maxima
into ``TuGemmStats``. The CUDA source is ``csrc/unary_stats.cu``; its header
says what bounds them on the card (one read of the operands, less than a
launch at serving sizes) and how the design answers that: a GEMM's maxima
come out of the GEMM's own tiles and ``tugemm_stats`` assembles them in one
launch; ``unary_step_stats`` takes both operands' maxima in one launch
of the absmax kernel and assembles them in ``tugemm_stats``; ``colabsmax``
and ``rowabsmax`` launch the absmax kernel on one operand. Each launches its kernel for CUDA tensors and runs its plain
version (``kernels/ref.py``) for CPU tensors or under ``impl="torch"``;
everything is integer, so the two agree bit for bit, dtypes included.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from ._launch import KernelCount, charge_meta, check, meta_route, ptr, raise_on, stream_ptr
from .ref import colabsmax_ref, finish_stats_ref, rowabsmax_ref

__all__ = ["colabsmax", "rowabsmax", "unary_step_stats", "tugemm_stats", "stats_fields", "HDR",
           "COL_COUNT", "ROW_COUNT", "PAIR_COUNT", "FINISH_COUNT"]

COL_COUNT = KernelCount("colabsmax")
ROW_COUNT = KernelCount("rowabsmax")
PAIR_COUNT = KernelCount("unary_step_stats")
FINISH_COUNT = KernelCount("tugemm_stats")
# csrc/unary_stats.cu: int32 words of a stats output before step_cycles
# (serial_cycles as int64 in words 0-1, then parallel, max_abs, act_max)
HDR = 6
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = build.load("unary_stats")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.absmax_launch.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp]
        lib.absmax_launch.restype = ci
        lib.tugemm_stats_launch.argtypes = [vp, vp, ci, ci, ci, ci, ci, vp, vp]
        lib.tugemm_stats_launch.restype = ci
        _lib = lib
    return _lib


def _plain(x: torch.Tensor, impl: str, dtype: torch.dtype = torch.int8,
           ndim: tuple = (2,)) -> bool:
    if impl not in ("auto", "torch", "cuda"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "torch" or (impl == "auto" and x.device.type == "cpu"):
        return True
    check(x.device.type == "cuda", f"unary_stats: impl={impl!r} needs a CUDA tensor")
    _operand(x, dtype, ndim)
    return False


def _operand(x: torch.Tensor, dtype: torch.dtype, ndim: tuple = (2,)) -> None:
    check(x.dtype == dtype and x.ndim in ndim and x.is_contiguous(),
          lambda: f"unary_stats: needs a contiguous {'/'.join(map(str, ndim))}-D {dtype} "
                  f"tensor, got {x.dtype} {tuple(x.shape)}")


def stats_fields(out: torch.Tensor, K: int):
    """The five TuGemmStats fields, as views of one kernel output (HDR + K
    int32, or (E, even stride) rows of it for E GEMMs): step_cycles,
    serial_cycles (int64), parallel_cycles, max_abs, act_max."""
    return (out[..., HDR:HDR + K], out[..., 0:2].view(torch.int64)[..., 0], out[..., 2],
            out[..., 3], out[..., 4])


def colabsmax(a: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """``max_m |A[m, k]|``: (M, K) int8 -> (K,) int32 (the A-side stats)."""
    if meta_route(impl, a):
        return _meta_absmax(COL_COUNT, a, a.shape[1])
    if _plain(a, impl):
        COL_COUNT.plain_calls += 1
        return colabsmax_ref(a)
    M, K = a.shape
    out = torch.empty(K, dtype=torch.int32, device=a.device)
    if K > 0:
        raise_on(_load().absmax_launch(ptr(a), None, ptr(out), None, M, 0, K,
                                       stream_ptr(a.device)), "colabsmax")
        COL_COUNT.launches += 1
    return out


def rowabsmax(b: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """``max_n |B[k, n]|``: (K, N) int8 -> (K,) int32 (the B-side stats)."""
    if meta_route(impl, b):
        return _meta_absmax(ROW_COUNT, b, b.shape[0])
    if _plain(b, impl):
        ROW_COUNT.plain_calls += 1
        return rowabsmax_ref(b)
    K, N = b.shape
    out = torch.empty(K, dtype=torch.int32, device=b.device)
    if K > 0:
        raise_on(_load().absmax_launch(None, ptr(b), None, ptr(out), 0, N, K,
                                       stream_ptr(b.device)), "rowabsmax")
        ROW_COUNT.launches += 1
    return out


def unary_step_stats(a: torch.Tensor, b: torch.Tensor, *, impl: str = "auto"):
    """The TuGemmStats fields of A (M, K) @ B (K, N), int8, M, N, K > 0, from
    the operands: ``(step_cycles (K,) int32, serial_cycles int64,
    parallel_cycles, max_abs, act_max int32)``. Two launches: both maxima,
    then ``tugemm_stats``."""
    check(a.ndim == b.ndim == 2 and a.shape[1] == b.shape[0] and a.numel() and b.numel(),
          lambda: f"unary_step_stats: a {tuple(a.shape)}, b {tuple(b.shape)}: needs "
                  "A (M, K) and B (K, N) with M, N, K > 0")
    K = a.shape[1]
    if meta_route(impl, a):
        from ..roofline.kernel_cost import nbytes

        ca, rb = torch.empty((2, K), dtype=torch.int32, device=a.device).unbind()
        charge_meta(PAIR_COUNT, (nbytes(a, b, ca, rb), a.numel() + b.numel()), (2, K))
    elif _plain(a, impl):
        PAIR_COUNT.plain_calls += 1
        ca, rb = colabsmax(a, impl="torch"), rowabsmax(b, impl="torch")
    else:
        _operand(b, torch.int8)
        check(b.device == a.device, "unary_step_stats: a and b must share a device")
        ca, rb = torch.empty((2, K), dtype=torch.int32, device=a.device).unbind()
        raise_on(_load().absmax_launch(ptr(a), ptr(b), ptr(ca), ptr(rb), a.shape[0],
                                       b.shape[1], K, stream_ptr(a.device)), "unary_step_stats")
        PAIR_COUNT.launches += 1
    return tugemm_stats(ca.view(1, K), rb.view(K, 1), K, impl=impl)


def tugemm_stats(ca: torch.Tensor, rb: torch.Tensor, K: int, *, impl: str = "auto"):
    """The TuGemmStats fields of a GEMM from its plane-major maxima, ca
    (planes, Kw) and rb (Kw, planes) int32 (``tugemm_fused`` /
    ``tugemm_int8`` with stats), over the logical steps ``k = p·Kw + kk <
    K``: as ``unary_step_stats`` returns them. One launch. A leading expert
    axis (ca (E, planes, Kw), rb (E, Kw, planes): ``tugemm_fused`` over the
    MoE experts) gives every field a leading (E,) axis, still one launch."""
    meta = meta_route(impl, ca)
    if not meta and _plain(ca, impl, torch.int32, (2, 3)):
        FINISH_COUNT.plain_calls += 1
        return finish_stats_ref(ca, rb, K)
    if not meta:
        _operand(rb, torch.int32, (ca.ndim,))
    lead = tuple(ca.shape[:-2])
    E = ca.shape[0] if lead else 1
    planes, Kw = ca.shape[-2:]
    check(tuple(rb.shape) == lead + (Kw, planes) and 0 < K <= planes * Kw
          and rb.device == ca.device and E > 0,
          lambda: f"tugemm_stats: ca {tuple(ca.shape)}, rb {tuple(rb.shape)}, K={K}")
    stride = HDR + K + (K % 2 if lead else 0)   # rows keep the int64 sum aligned
    out = torch.empty(lead + (stride,), dtype=torch.int32, device=ca.device)
    if meta:
        from ..roofline.kernel_cost import stats_bytes_ops

        charge_meta(FINISH_COUNT, stats_bytes_ops((ca, rb), (out,)), out.shape)
        return stats_fields(out, K)
    raise_on(_load().tugemm_stats_launch(ptr(ca), ptr(rb), E, Kw, planes, K, stride,
                                         ptr(out), stream_ptr(ca.device)), "tugemm_stats")
    FINISH_COUNT.launches += 1
    return stats_fields(out, K)


def _meta_absmax(count: KernelCount, x: torch.Tensor, K: int) -> torch.Tensor:
    """The meta path of an absmax: an empty (K,) and one charge."""
    from ..roofline.kernel_cost import absmax_bytes_ops

    out = torch.empty(K, dtype=torch.int32, device=x.device)
    charge_meta(count, absmax_bytes_ops(x, out), out.shape)
    return out
