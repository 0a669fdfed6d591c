"""Temporal-unary (thermometer) encoding — the paper's C1 contribution.

A value ``n`` is represented as a contiguous pulse of ``|n|`` ones followed by
zeros on a single bitline (two transitions in all, against O(L) for rate
coding). The sign travels on a separate ``neg`` wire, as the paper's
``neg_col/row`` signals do.

For w-bit two's-complement inputs the paper treats the maximum magnitude as
``2**(w-1)`` (128 for 8 bits — Fig. 5's x-axis), so thermometer codes here
have ``2**(w-1)`` slots.
"""

from __future__ import annotations

import torch

__all__ = [
    "max_magnitude",
    "int_range",
    "thermometer_encode",
    "thermometer_decode",
    "temporal_bitstream",
]


def max_magnitude(bitwidth: int) -> int:
    """Largest magnitude a w-bit two's-complement value can take (paper §III-B)."""
    if bitwidth < 2:
        raise ValueError(f"bitwidth must be >= 2, got {bitwidth}")
    return 2 ** (bitwidth - 1)


def int_range(bitwidth: int) -> tuple[int, int]:
    """Inclusive representable range of w-bit two's complement."""
    m = max_magnitude(bitwidth)
    return -m, m - 1


def thermometer_encode(x: torch.Tensor, bitwidth: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Encode integer tensor ``x`` as (thermometer bits, neg flags).

    ``bits`` has a trailing axis of ``2**(bitwidth-1)`` slots with
    ``bits[..., u] = 1[u < |x|]`` (the state of the unary bitline at cycle
    ``u``), as int8 (a single wire); ``neg = x < 0`` (the ``neg_col/row``
    wire). The magnitude is taken in int32, so ``|-2**(w-1)|`` fills every
    slot."""
    m = max_magnitude(bitwidth)
    mag = x.to(torch.int32).abs()
    slots = torch.arange(m, dtype=torch.int32, device=x.device)
    bits = (slots < mag[..., None]).to(torch.int8)
    return bits, x < 0


def thermometer_decode(bits: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`thermometer_encode` (sum of pulse cycles, signed), int32."""
    mag = bits.to(torch.int32).sum(dim=-1, dtype=torch.int32)
    return torch.where(neg, -mag, mag)


def temporal_bitstream(x: torch.Tensor, bitwidth: int) -> torch.Tensor:
    """Signed temporal bitstream: +1 / -1 pulses, 0 after the pulse ends.

    ``stream[..., u] = sign(x) * 1[u < |x|]`` — what the output counter cell
    sees per cycle (increment, decrement, or hold)."""
    bits, neg = thermometer_encode(x, bitwidth)
    sign = torch.where(neg, -1, 1).to(torch.int8)
    return bits * sign[..., None]
