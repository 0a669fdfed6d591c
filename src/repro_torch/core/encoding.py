"""w-bit two's-complement ranges of the temporal-unary encoding (the
thermometer codes themselves are not on the serving path)."""

from __future__ import annotations

__all__ = ["max_magnitude", "int_range"]


def max_magnitude(bitwidth: int) -> int:
    """Largest magnitude a w-bit two's-complement value can take (paper §III-B)."""
    if bitwidth < 2:
        raise ValueError(f"bitwidth must be >= 2, got {bitwidth}")
    return 2 ** (bitwidth - 1)


def int_range(bitwidth: int) -> tuple[int, int]:
    """Inclusive representable range of w-bit two's complement."""
    m = max_magnitude(bitwidth)
    return -m, m - 1
