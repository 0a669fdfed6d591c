"""Eager, context-managed capture of per-GEMM tuGEMM statistics.

The reference threads stats through ``jit``/``scan`` as traced outputs
(trace-time frames). PyTorch runs eagerly, so the port's collector is a
plain list: while a :func:`capture_stats` context is active, ``qlinear``
appends every quantized GEMM's :class:`CapturedGemm` (one per executed
GEMM, layer by layer), and :func:`tree_totals_by_bits` sums the cycle
counts per bitwidth: :func:`stack_totals` reduces a capture to one small
int64 device tensor (a CUDA graph of a serving step captures that reduction
too, ``serve/graphs.py``), and :class:`StepTotals` brings it to the host in
one copy.

Leading axes on a GEMM's stats mean sequentially executed instances (the
MoE experts of one launch): the totals sum ``serial_cycles`` *and*
``parallel_cycles`` over them, as the reference does — distinct GEMMs
time-multiplex one unit even in the parallel micro-architecture. Named
scalars that are not GEMMs (``moe.dropped_tokens``) ride along as
:class:`CapturedScalar` entries; a ``scalars_only`` capture keeps only
those (the mesh step's MoE drop counter when energy tracking is off), and
no GEMM computes stats for it.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, field

import torch

from ..core.tugemm import TuGemmStats
from ..kernels.ops import recording

__all__ = [
    "CapturedGemm",
    "CapturedScalar",
    "Capture",
    "capture_stats",
    "stats_wanted",
    "capturing",
    "push",
    "push_scalar",
    "scalar_totals",
    "tree_totals_by_bits",
    "TotalsLayout",
    "StepTotals",
    "stack_totals",
]


@dataclass
class CapturedGemm:
    """One executed quantized GEMM (M, K) @ (K, N) at ``bits``."""

    name: str
    M: int
    K: int
    N: int
    stats: TuGemmStats
    bits: int = 8


@dataclass
class CapturedScalar:
    """One named non-GEMM counter (a device scalar)."""

    name: str
    value: torch.Tensor


@dataclass
class Capture:
    entries: list[CapturedGemm] = field(default_factory=list)
    scalars: list[CapturedScalar] = field(default_factory=list)
    scalars_only: bool = False


_ACTIVE: list[Capture] = []


def stats_wanted() -> bool:
    """Whether GEMMs should compute stats: a capture that takes them is
    active."""
    return bool(_ACTIVE) and not _ACTIVE[-1].scalars_only


def capturing() -> bool:
    """Whether named scalars are recorded: any capture is active."""
    return bool(_ACTIVE)


def push(name: str, M: int, K: int, N: int, stats: TuGemmStats, bits: int = 8) -> None:
    """Record one GEMM in the innermost capture (no-op when not capturing
    or inside ``ops.quiet_records``)."""
    if _ACTIVE and not _ACTIVE[-1].scalars_only and recording():
        _ACTIVE[-1].entries.append(CapturedGemm(name, int(M), int(K), int(N), stats, int(bits)))


def push_scalar(name: str, value: torch.Tensor) -> None:
    """Record one named scalar in the innermost capture (no-op when not
    capturing or inside ``ops.quiet_records``)."""
    if _ACTIVE and recording():
        _ACTIVE[-1].scalars.append(CapturedScalar(name, value))


@contextmanager
def capture_stats(*, scalars_only: bool = False):
    """Collect every quantized GEMM run inside the block (with
    ``scalars_only``, only the named scalars); yields the :class:`Capture`
    whose ``entries`` hold the result."""
    cap = Capture(scalars_only=scalars_only)
    _ACTIVE.append(cap)
    try:
        yield cap
    finally:
        _ACTIVE.pop()


@dataclass(frozen=True)
class TotalsLayout:
    """What :func:`stack_totals`' tensor holds: the serial then the parallel
    cycle total of each bitwidth in ``bits`` (first-seen order), then the
    sum of each named scalar in ``names``."""

    bits: tuple[int, ...] = ()
    names: tuple[str, ...] = ()


def stack_totals(cap: Capture) -> tuple[torch.Tensor | None, TotalsLayout]:
    """A capture's cycle totals per bitwidth and its named scalars' sums as
    one int64 tensor on the stats' device (None when the capture holds
    neither), and its layout. Device ops only: a few a bitwidth, none a
    GEMM, and no host copy."""
    by: dict[int, list[CapturedGemm]] = {}
    for e in cap.entries:
        by.setdefault(int(e.bits), []).append(e)
    names: dict[str, list[torch.Tensor]] = {}
    for sc in cap.scalars:
        names.setdefault(sc.name, []).append(sc.value)

    def total(ts) -> torch.Tensor:
        return torch.cat([t.reshape(-1).to(torch.int64) for t in ts]).sum()

    parts = []
    for es in by.values():
        parts.append(total([e.stats.serial_cycles for e in es]))
        parts.append(total([e.stats.parallel_cycles for e in es]))
    parts.extend(total(vs) for vs in names.values())
    layout = TotalsLayout(tuple(by), tuple(names))
    return (torch.stack(parts) if parts else None), layout


@dataclass
class StepTotals:
    """One step's :func:`stack_totals` on the device."""

    values: torch.Tensor | None
    layout: TotalsLayout

    @classmethod
    def of(cls, cap: Capture) -> "StepTotals":
        return cls(*stack_totals(cap))

    def host(self) -> tuple[dict[int, dict[str, int]], dict[str, int]]:
        """(cycle totals by bitwidth, scalar sums by name), in one copy."""
        if self.values is None:
            return {}, {}
        v = self.values.cpu().tolist()
        nb = len(self.layout.bits)
        by_bits = {b: {"serial_cycles": v[2 * i], "parallel_cycles": v[2 * i + 1]}
                   for i, b in enumerate(self.layout.bits)}
        return by_bits, dict(zip(self.layout.names, v[2 * nb:]))


def tree_totals_by_bits(cap: Capture) -> dict[int, dict[str, int]]:
    """Serial/parallel cycle totals per bitwidth over every captured GEMM,
    summed in int64 — cycles at different bitwidths are not interchangeable
    (clock and Table-I power differ per width)."""
    return StepTotals.of(cap).host()[0]


def scalar_totals(cap: Capture) -> dict[str, int]:
    """{name: sum over the capture's scalars of that name}, on the host."""
    return StepTotals.of(cap).host()[1]
