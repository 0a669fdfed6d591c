"""What each hand-written kernel must move and compute: one formula for the
card's bound and the dry-run's charge.

``chip_smoke.py`` divides these counts by the ``h100`` profile's rates
(:func:`bound`) for each kernel's ``bound_ms``; a kernel wrapper given
``meta`` tensors charges the same counts to the active
``op_cost.OpCost`` as one op (``kernels/*.py``, through
:func:`charge`). Bytes count each input read once and each output written
once; operations count the multiply-adds as two.

Attention has two counts. On the card :func:`attn_bytes_ops` reads the
positions and lengths and counts only what the rows can see (the pages
holding visible keys); on ``meta`` tensors there are no values to read,
and ``every_page=True`` counts every page of every row's table, which is
what the reference's XLA twin reads in a dry-run, so the FLOPs compare.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

from .analysis import HW, HW_PROFILES

__all__ = [
    "H100", "nbytes", "bound", "gemm_grid", "attn_bytes_ops", "gemm_bytes_ops",
    "stats_bytes_ops", "absmax_bytes_ops", "quantize_bytes_ops", "temporal_bytes_ops",
    "charge", "gemms_saved",
]

H100 = HW_PROFILES["h100"]


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(byts: int, ops: int, rate: str = "int8", hw: HW = H100) -> dict:
    """{bytes, ops, bound_ms, bound_by}: the larger of the bytes over the
    HBM rate and the operations over the peak rate of ``rate`` operations
    (``int8``, ``f32`` or ``bf16``)."""
    tb, to = byts / hw.hbm_bw, ops / hw.rate(rate)
    return dict(bytes=byts, ops=ops, bound_ms=max(tb, to) * 1e3,
                bound_by="bytes" if tb >= to else "operations")


def gemm_grid(M: int, N: int, Kw: int, planes: int, xbytes: int = 1, experts: int = 1) -> dict:
    """The grid of the GEMM kernels on the split-K mainloop (fused, int8 and
    packed) at a call's shapes on the current CUDA device: tile width, K
    splits (the cluster size) and blocks, from ``split_plan``."""
    from ..kernels.tugemm_fused import BM, split_plan

    sms = torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count
    bn, splits, chunks = split_plan(M, N, Kw, planes, sms, xbytes, experts)
    return dict(bn=bn, splits=splits, chunks=chunks,
                blocks=splits * -(-N // bn) * experts * -(-M // BM))


def attn_bytes_ops(args, kv, bs, window=None, every_page=False):
    """(bytes, f32 operations) of ``flash_paged_decode`` on ``args`` = (q,
    k_parts, k_scales, v, v_scale, tables, pos, kv_len): bytes each input
    once + the output, and 2·(hd + hdv) operations a query row a key.
    By default only what this run's rows can see: per row, the pages
    holding its visible keys (causal, window). ``every_page``: every page
    of every row's table for every query row (no values read)."""
    q, kparts, kscales, v, vs, tables, pos, kv_len = args
    B, sq, H, hd = q.shape
    hdv = v.shape[2] // kv
    if every_page:
        pages = B * tables.shape[1]
        flops = 2 * H * sq * pages * bs * (hd + hdv)
    else:
        pages, flops = 0, 0
        for p, n in zip(pos.tolist(), kv_len.tolist()):
            his = [min(n, p + s + 1) for s in range(sq)]
            los = [0 if window is None else max(0, p + s - window + 1) for s in range(sq)]
            vis = [max(0, h - l) for h, l in zip(his, los)]
            flops += sum(2 * H * x * (hd + hdv) for x in vis)
            if any(vis):
                pages += -(-max(his) // bs) - min(los) // bs
    per_tok = sum(p.shape[2] * p.element_size() for p in kparts)
    if not any(v is p for p in kparts):
        per_tok += v.shape[2] * v.element_size()
    scales = [s for s in (*kscales, vs) if s is not None]
    per_tok += 4 * len({id(s) for s in scales})
    out_b = B * sq * H * hdv * q.element_size()
    byts = nbytes(q, tables, pos, kv_len) + pages * bs * per_tok + out_b
    return byts, flops


def gemm_bytes_ops(ins, outs, M: int, K: int, N: int, experts: int = 1):
    """(bytes, int8 operations) of a GEMM kernel (fused, int8 or packed):
    its operands and results once, 2·E·M·K·N operations (K the columns of
    X or A that the kernel multiplies)."""
    return nbytes(*ins, *outs), 2 * experts * M * K * N


def stats_bytes_ops(ins, outs):
    """(bytes, operations) of ``tugemm_stats``: its maxima in, the fields
    out; no operation worth a rate."""
    return nbytes(*ins, *outs), 0


def absmax_bytes_ops(x, out):
    """(bytes, operations) of an absmax reduction: x in, the maxima out, one
    operation an element."""
    return nbytes(x, out), x.numel()


def quantize_bytes_ops(x, scale, q):
    """(bytes, f32 operations) of ``quantize_sym``: x, the scale as given
    (4 bytes for a number), q; one operation an element."""
    s_bytes = nbytes(scale) if isinstance(scale, torch.Tensor) else 4
    return nbytes(x, q) + s_bytes, q.numel()


def temporal_bytes_ops(a, b, y, bitwidth: int):
    """(bytes, int8 operations) of ``temporal_unary_gemm``: a, b and y once,
    2·M·K·N operations a unary step, 2^(w-1) steps."""
    M, K = a.shape[-2:]
    N = b.shape[-1]
    return nbytes(a, b, y), 2 ** (bitwidth - 1) * 2 * M * K * N


# the GEMM kernels, whose outputs block remat saves as it saves a linear
# layer's matmul output
GEMM_KERNELS = frozenset({"tugemm_fused", "tugemm_int8", "tugemm_packed"})
_saved = [0]


@contextmanager
def gemms_saved():
    """Inside, a GEMM kernel's meta call charges nothing: the recompute of
    a block whose remat saves the linear layers' outputs
    (``models/transformer.py``; the reference's
    ``dots_with_no_batch_dims_saveable``) reads them instead of running
    the GEMM again."""
    _saved[0] += 1
    try:
        yield
    finally:
        _saved[0] -= 1


def charge(kernel: str, byts: int, ops: int, shape=()) -> None:
    """One kernel call on ``meta`` tensors: charged to the active
    ``op_cost.OpCost`` as one op (nothing when none is active)."""
    from .op_cost import current_cost

    cost = current_cost()
    if cost is not None and not (_saved[0] and kernel in GEMM_KERNELS):
        cost.kernel(kernel, byts, ops, shape)
