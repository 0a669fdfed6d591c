"""Plain PyTorch versions of the kernels' arithmetic.

Each function is what its CUDA kernel is held against bit for bit (on the
card) and what runs on CPU tensors; each mirrors the function of the same
name in the reference's ``repro/kernels/ref.py`` op for op:

- ``matmul_int_ref`` — ``tugemm_int8.py`` (exact int8 GEMM [+ C])
- ``packed_matmul_ref`` — ``tugemm_packed.py`` (int8 x plane-packed int4/int2)
- ``colabsmax_ref``, ``rowabsmax_ref`` — ``unary_stats.py``;
  ``unary_stats_ref`` bundles both with the step cycles;
  ``assemble_stats_ref`` / ``finish_stats_ref`` turn the two maxima into
  the TuGemmStats fields (the reference's ``ops._assemble_stats``; the
  assembly of ``csrc/unary_stats.cu``)
- ``fused_gemm_ref`` — ``tugemm_fused.py``
- ``dequant_bias_ref`` — the unfused pipeline's epilogue (no kernel: the
  same multiply and add the fused kernel's epilogue makes)
- ``temporal_unary_gemm_ref`` — ``temporal_unary.py`` (the thermometer
  decomposition's oracle: a plain GEMM)
- ``quantize_sym_ref`` — ``quantize.py`` (symmetric round-half-even
  quantization by a reciprocal scale)
"""

from __future__ import annotations

import torch

from .packing import BITS_TO_PLANES, unpack_plane

__all__ = [
    "int_matmul",
    "matmul_int_ref",
    "packed_matmul_ref",
    "colabsmax_ref",
    "rowabsmax_ref",
    "unary_stats_ref",
    "assemble_stats_ref",
    "finish_stats_ref",
    "dequant_bias_ref",
    "fused_gemm_ref",
    "temporal_unary_gemm_ref",
    "quantize_sym_ref",
]


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer product of two int8 carriers, as int32.

    CUDA has no integer ``matmul``; there the product runs in float64, which
    is exact here because ``K * 128**2 < 2**53`` for every K a layer has,
    one slice of a leading (expert) axis at a time: a whole expert stack in
    float64 (a 128-expert llama4 stack: 43 GB) does not fit beside the model."""
    if a.device.type == "cpu":
        return torch.matmul(a.to(torch.int32), b.to(torch.int32))
    if a.ndim > 2:
        return torch.stack([int_matmul(ai, bi) for ai, bi in zip(a, b)])
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.int32)


def matmul_int_ref(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor | None = None) -> torch.Tensor:
    """Exact integer GEMM with int32 accumulation (the tuGEMM contract),
    the accumulators starting at ``c`` when given (paper §II-B)."""
    y = int_matmul(a, b)
    if c is not None:
        y = y + c.to(torch.int32)
    return y


def packed_matmul_ref(a: torch.Tensor, packed_b: torch.Tensor, bits: int,
                      c: torch.Tensor | None = None) -> torch.Tensor:
    """int8 A (M, planes·Kp) x plane-packed B (Kp, N): unpack the planes,
    then the exact GEMM (leading axes batch GEMMs: the MoE experts)."""
    planes = BITS_TO_PLANES[bits]
    if a.shape[-1] != packed_b.shape[-2] * planes:
        raise ValueError(f"a {tuple(a.shape)} does not match packed b "
                         f"{tuple(packed_b.shape)} at {bits} bits")
    b = torch.cat([unpack_plane(packed_b, bits, p) for p in range(planes)], dim=-2)
    return matmul_int_ref(a, b, c)


def colabsmax_ref(a: torch.Tensor) -> torch.Tensor:
    """``max_m |A[m, k]|`` as int32 (the abs in int32, so -128 counts 128);
    leading axes batch operands."""
    return a.to(torch.int32).abs().amax(dim=-2)


def rowabsmax_ref(b: torch.Tensor) -> torch.Tensor:
    """``max_n |B[k, n]|`` as int32 (the abs in int32, so -128 counts 128);
    leading axes batch operands."""
    return b.to(torch.int32).abs().amax(dim=-1)


def unary_stats_ref(a: torch.Tensor, b: torch.Tensor):
    """``(colmax_a, rowmax_b, step_cycles)``: per outer-product step k,
    ``max_m |A[m,k]|``, ``max_n |B[k,n]|`` and their cycle count
    ``colmax_a[k] * max(rowmax_b[k], 1)``."""
    ca, rb = colabsmax_ref(a), rowabsmax_ref(b)
    return ca, rb, ca * rb.clamp_min(1)


def assemble_stats_ref(ca: torch.Tensor, rb: torch.Tensor):
    """The TuGemmStats fields from the two logical-K maxima: ``(step_cycles
    (K,) int32, serial_cycles int64 (the sum of int32), parallel_cycles,
    max_abs, act_max)``, the last three int32 (the core cycle model).
    Leading axes (E GEMMs' maxima, (E, K)) carry into every field."""
    sc = ca * rb.clamp_min(1)
    return (sc, sc.sum(-1), sc.amax(-1), torch.maximum(ca.amax(-1), rb.amax(-1)),
            ca.amax(-1))


def finish_stats_ref(ca: torch.Tensor, rb: torch.Tensor, K: int):
    """``assemble_stats_ref`` on a GEMM's plane-major maxima, ca (planes,
    Kw) and rb (Kw, planes): plane p holds the logical steps ``[p·Kw,
    (p+1)·Kw)``, of which the first K count (leading axes batch GEMMs)."""
    lead = tuple(ca.shape[:-2])
    return assemble_stats_ref(ca.reshape(lead + (-1,))[..., :K],
                              rb.transpose(-1, -2).reshape(lead + (-1,))[..., :K])


def dequant_bias_ref(acc: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
                     bias: torch.Tensor | None, out_dtype: torch.dtype) -> torch.Tensor:
    """The unfused pipeline's epilogue: int32 acc -> out dtype (+ bias).
    ``sx`` is the per-tensor scalar or a per-token (M,) vector; the float
    ops are the fused kernel's own (``_dequant_bias``), so the two paths
    agree bit for bit. A leading expert axis (acc (E, M, N)) takes sx (E,)
    or (E, M), sw (E, N) and bias (E, N): each expert its own."""
    sx = torch.as_tensor(sx, dtype=torch.float32, device=acc.device)
    lead = tuple(acc.shape[:-2])
    per_token = sx.numel() > (lead[0] if lead else 1)
    sx2 = sx.reshape(lead + ((-1, 1) if per_token else (1, 1)))
    return _dequant_bias(acc, sx2, sw.to(torch.float32).reshape(lead + (1, -1)), bias,
                         out_dtype)


def _dequant_bias(acc, sx, sw, bias, out_dtype):
    """Epilogue: int32 acc -> ``acc * (sx*sw)`` in f32 -> out dtype, then the
    bias added in the out dtype (separate multiply and add, never an FMA)."""
    y = (acc.to(torch.float32) * (sx * sw)).to(out_dtype)
    if bias is not None:
        y = y + bias.unsqueeze(-2).to(out_dtype)
    return y


def _quant(x: torch.Tensor, s: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """round(x / s) (IEEE divide, half to even), clipped to [lo, hi]."""
    return torch.clamp(torch.round(x.to(torch.float32) / s), lo, hi).to(torch.int8)


def fused_gemm_ref(
    x: torch.Tensor,
    w: torch.Tensor,
    sx: torch.Tensor,
    sw: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    bits: int,
    w_mode: str = "quant",
    collect_stats: bool = False,
    out_dtype: torch.dtype = torch.float32,
):
    """``Y = clip(round(X/sx)) @ Wq · (sx·sw[n]) + bias``.

    x (M, planes·Kw) float; sx (1, 1) per-tensor or (M, 1) per-token f32;
    sw (1, N) f32. W by ``w_mode``: ``quant`` (Kw, N) float quantized with
    sw, ``int8`` (Kw, N) stored int8, ``packed`` (Kw, N) plane-packed
    int4/int2 whose plane p multiplies x columns ``[p·Kw, (p+1)·Kw)``.
    Leading axes batch independent GEMMs (the MoE experts: x (E, M, Kx),
    w (E, Kw, N), sx (E, 1|M, 1), sw (E, 1, N), bias (E, N)); every op is
    elementwise or per slice, so a batched call equals its slices' calls.

    Returns y (M, N) ``out_dtype``, or (y, ca (planes, Kw), rb (Kw, planes))
    with ``ca[p, k] = max_m |Xq[m, p·Kw + k]|`` and
    ``rb[k, p] = max_n |Wq_p[k, n]|`` — the kernel's stats layout (with
    the leading axes in front).

    On the card a leading axis is taken one slice at a time (the float
    temporaries of a whole 128-expert stack, 21.5 GB each in f32 for
    llama4's, do not fit beside the model); the results are the batched
    call's, as every op is per slice."""
    if x.ndim > 2 and x.device.type == "cuda":
        parts = [fused_gemm_ref(x[e], w[e], sx[e], sw[e], None if bias is None else bias[e],
                                bits=bits, w_mode=w_mode, collect_stats=collect_stats,
                                out_dtype=out_dtype) for e in range(x.shape[0])]
        if not collect_stats:
            return torch.stack(parts)
        return tuple(torch.stack(t) for t in zip(*parts))
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    Kw = w.shape[-2]
    lead = tuple(w.shape[:-2])
    xq = _quant(x, sx, lo, hi)
    if w_mode == "packed":
        planes = BITS_TO_PLANES[bits]
        wq = torch.cat([unpack_plane(w, bits, p) for p in range(planes)], dim=-2)
    elif w_mode == "quant":
        planes = 1
        wq = _quant(w, sw, lo, hi)
    elif w_mode == "int8":
        planes = 1
        wq = w
    else:
        raise ValueError(f"unknown w_mode {w_mode!r}")
    if xq.shape[-1] != wq.shape[-2]:
        raise ValueError(f"x {tuple(x.shape)} does not match w {tuple(w.shape)} ({w_mode})")
    y = _dequant_bias(int_matmul(xq, wq), sx, sw, bias, out_dtype)
    if not collect_stats:
        return y
    ca = xq.to(torch.int32).abs().amax(dim=-2).reshape(lead + (planes, Kw))
    rb = wq.to(torch.int32).abs().amax(dim=-1).reshape(lead + (planes, Kw))
    return y, ca, rb.transpose(-1, -2).contiguous()


def temporal_unary_gemm_ref(a: torch.Tensor, b: torch.Tensor, bitwidth: int,
                            c: torch.Tensor | None = None) -> torch.Tensor:
    """Oracle for the thermometer-decomposed GEMM: an independent plain GEMM
    (the decomposition must be exact, so the oracle does not share its
    structure). It takes the operands as they are: on w-bit operands it
    equals the decomposition, which saturates ``|a|`` at ``2**(w-1)``."""
    del bitwidth
    return matmul_int_ref(a, b, c)


def quantize_sym_ref(x: torch.Tensor, inv_scale: torch.Tensor, bitwidth: int) -> torch.Tensor:
    """Symmetric round-half-even quantization to w-bit two's complement:
    ``clip(round(x · inv_scale))`` in f32, int8 carrier. ``inv_scale``
    broadcasts against ``x`` (per-tensor (1, 1) or per-column (1, N)).
    The reciprocal-multiply form is this op's own (the fused GEMM divides),
    so the two may differ by one code at ties."""
    q = torch.round(x.to(torch.float32) * inv_scale)
    lo, hi = -(2 ** (bitwidth - 1)), 2 ** (bitwidth - 1) - 1
    return torch.clamp(q, lo, hi).to(torch.int8)
