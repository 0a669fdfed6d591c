"""Host-side sub-byte packing for the plane-packed weight layout.

Plane layout (not nibble-interleaved): for int4, ``packed[k, n]`` holds
``W[k, n]`` in bits 0-3 and ``W[k + K/2, n]`` in bits 4-7. GEMM accumulation
is order-independent over K, so a kernel computes
``A[:, :K/2] @ low + A[:, K/2:] @ high`` — each unpacked plane feeds the
integer product directly, with no interleave."""

from __future__ import annotations

import torch

__all__ = ["BITS_TO_PLANES", "PLANES", "pack_planes", "unpack_plane", "pad_to_multiple"]

# sub-byte plane counts; PLANES adds the trivial 8-bit entry
BITS_TO_PLANES = {4: 2, 2: 4}
PLANES = {8: 1, **BITS_TO_PLANES}


def pad_to_multiple(x: torch.Tensor, axis: int, multiple: int) -> torch.Tensor:
    pad = (-x.shape[axis]) % multiple
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def pack_planes(w: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack int values (|w| < 2**(bits-1) two's complement) along axis 0.

    w: (K, N) int8 with K a multiple of the plane count. Returns
    (K/planes, N) int8 where plane ``p`` of row k holds ``w[k + p*K/planes, n]``
    in bit positions ``[p*bits, (p+1)*bits)``.
    """
    planes = BITS_TO_PLANES[bits]
    K = w.shape[0]
    if K % planes:
        raise ValueError(f"K={K} must be a multiple of {planes} for {bits}-bit packing")
    kp = K // planes
    w8 = w.to(torch.int8).to(torch.uint8)
    mask = (1 << bits) - 1
    out = torch.zeros((kp, *w.shape[1:]), dtype=torch.uint8, device=w.device)
    for p in range(planes):
        out |= (w8[p * kp : (p + 1) * kp] & mask) << (p * bits)
    return out.view(torch.int8)


def unpack_plane(packed: torch.Tensor, bits: int, plane: int) -> torch.Tensor:
    """Extract plane ``plane`` as sign-extended int8: shift the field to the
    top of the byte, then arithmetic-shift it back down."""
    planes = BITS_TO_PLANES[bits]
    if not 0 <= plane < planes:
        raise ValueError(f"plane {plane} out of range for {bits}-bit")
    shift_up = 8 - (plane + 1) * bits
    return (packed.to(torch.int8) << shift_up) >> (8 - bits)
