"""Workload statistics collection for tuGEMM (the paper's Fig 5 method):
the debug collector behind a policy rule's ``:stats`` flag.

While a :func:`collecting` context is active, every GEMM whose resolved
backend has ``collect_stats`` appends one :class:`GemmRecord` — max |value|
(the Fig 5 statistic), serial/parallel cycles and the GEMM shape. The
reference gets these values out of its jitted program with a host
callback; the port runs eagerly and reads them on the spot (one device
sync per record, and none when no collector is active).
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np

from ..core.latency import MaxValueProfile
from ..kernels.ops import recording

__all__ = ["GemmRecord", "StatsCollector", "collecting", "active_collector", "record_stats"]


@dataclass
class GemmRecord:
    name: str
    M: int
    N: int
    P: int
    max_abs: int
    serial_cycles: int
    parallel_cycles: int
    bits: int = 8                # bitwidth this GEMM ran at (mixed policies)


@dataclass
class StatsCollector:
    bitwidth: int = 8
    records: list[GemmRecord] = field(default_factory=list)

    def profile(self) -> MaxValueProfile:
        """Histogram of the records' max |value| at ``bitwidth`` (Fig 5)."""
        prof = MaxValueProfile.empty(self.bitwidth)
        if self.records:
            prof.add(np.array([r.max_abs for r in self.records]))
        return prof

    def total_cycles(self, variant: str) -> int:
        """Sum of the records' ``serial`` or ``parallel`` cycles."""
        key = f"{variant}_cycles"
        return int(sum(getattr(r, key) for r in self.records))


_collector: StatsCollector | None = None


def active_collector() -> StatsCollector | None:
    return _collector


@contextmanager
def collecting(bitwidth: int = 8):
    """Enable GEMM stats collection inside the block; yields the collector,
    whose :meth:`~StatsCollector.profile` bins max |value| at ``bitwidth``."""
    global _collector
    prev, _collector = _collector, StatsCollector(bitwidth=bitwidth)
    try:
        yield _collector
    finally:
        _collector = prev


def record_stats(name: str, M: int, N: int, P: int, max_abs, serial_cycles,
                 parallel_cycles, bits: int = 8) -> None:
    """Append one GEMM's record to the active collector (no-op without one,
    or inside ``ops.quiet_records``)."""
    if _collector is not None and recording():
        _collector.records.append(GemmRecord(
            name, int(M), int(N), int(P), int(max_abs), int(serial_cycles),
            int(parallel_cycles), int(bits)))
