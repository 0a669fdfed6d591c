"""Stochastic rate-coded unary GEMM — the paper's uGEMM [21] baseline.

The paper's accuracy claim (§III-B.2) is that exact temporal compute beats
stochastic rate-coded compute at low precision. This is a functional
simulator of rate-coded arithmetic: values are encoded as Bernoulli
bitstreams (probability of a '1' ∝ magnitude), multiplication is a bitwise
AND of independent streams, and accumulation is an accumulative parallel
counter (APC). The estimator is unbiased with variance O(1/L) in the stream
length L — the stochastic-computing error floor that tuGEMM removes.

Random bits come from an explicit ``torch.Generator`` (the reference draws
them from ``jax.random`` keys), so the two packages agree in distribution,
not bit for bit.
"""

from __future__ import annotations

import torch

from .encoding import max_magnitude

__all__ = ["ugemm_stochastic", "stochastic_stream"]


def stochastic_stream(x: torch.Tensor, bitwidth: int, length: int,
                      generator: torch.Generator) -> torch.Tensor:
    """Rate-coded bitstream for |x|/2**(w-1): (..., L) int8 with
    P(bit=1) = |x| / max_magnitude. The sign is carried separately."""
    m = max_magnitude(bitwidth)
    prob = x.to(torch.float32).abs() / m
    u = torch.rand((*x.shape, length), generator=generator, dtype=torch.float32,
                   device=x.device)
    return (u < prob[..., None]).to(torch.int8)


def ugemm_stochastic(
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor | None = None,
    *,
    bitwidth: int,
    stream_length: int | None = None,
    generator: torch.Generator,
) -> torch.Tensor:
    """Stochastic rate-coded GEMM (uGEMM-style): an int32 estimate of
    ``A @ B + C`` with stochastic error ~ O(1/sqrt(L)) per product.

    A: (M, K), B: (K, N). The stream length defaults to 2**bitwidth (one
    full unary period, uGEMM's configuration). ``generator`` draws A's
    streams, then B's."""
    m = max_magnitude(bitwidth)
    L = stream_length or (1 << bitwidth)
    sa = stochastic_stream(A, bitwidth, L, generator)    # (M, K, L)
    sb = stochastic_stream(B, bitwidth, L, generator)    # (K, N, L)
    sign = (A.to(torch.int32).sign()[:, :, None]
            * B.to(torch.int32).sign()[None, :, :])      # (M, K, N)
    # AND-multiply per stream bit, APC-accumulate over the stream axis:
    # E[popcount] = L * |a||b| / m². The popcounts run in float32 (CUDA has
    # no integer einsum); each is at most L <= 2**24, so they are exact.
    pop = torch.einsum("mkl,knl->mkn", sa.to(torch.float32), sb.to(torch.float32))
    est = (sign.to(torch.float32) * pop).sum(dim=1) * (m * m / L)
    y = torch.round(est).to(torch.int32)
    if C is not None:
        y = y + C.to(torch.int32)
    return y
