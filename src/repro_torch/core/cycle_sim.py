"""Cycle-accurate simulator of the tuGEMM micro-architecture (golden model;
the port's own copy of the reference's numpy simulator).

Simulates, cycle by cycle, the gate-level behaviour described in §II of the
paper: index counter, vector generators, nested column/row down-counters,
and the MxP output counter (serial) / adder (parallel) array. Used by tests
to validate (a) exactness of the compute and (b) the analytic cycle model in
``core.tugemm`` / ``core.latency``.

RTL semantics per cycle (serial, within step ``i``):

1. enables sampled from current counts:
   ``en[m,p] = (col_cnt[m] != 0) & (row_cnt[p] != 0)``; every enabled output
   counter increments if ``neg_col[m] == neg_row[p]`` else decrements.
2. every non-zero row counter moves one toward zero.
3. if all row counters are (now) zero: every non-zero column counter moves
   one toward zero and the row counters reload ``B[i, :]``.
4. step ends when all column counters are zero.

numpy, intentionally slow and literal — this is the reference RTL, not the
perf path (that's ``kernels/``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["SimResult", "simulate_serial", "simulate_parallel", "simulate_step"]


class SimResult(NamedTuple):
    Y: np.ndarray              # (M, P) int32 — final output array contents
    total_cycles: int          # cycles until output_ready
    step_cycles: np.ndarray    # (N,) cycles spent in each outer-product step


def simulate_step(a_col: np.ndarray, b_row: np.ndarray, out: np.ndarray) -> int:
    """One outer-product step: accumulate sign(a)·sign(b)·|a||b| into ``out``.

    Mutates ``out`` in place; returns the number of cycles the step took.
    """
    M, P = a_col.shape[0], b_row.shape[0]
    col_cnt = np.abs(a_col.astype(np.int64)).copy()
    neg_col = a_col < 0
    row_init = np.abs(b_row.astype(np.int64))
    row_cnt = row_init.copy()
    neg_row = b_row < 0
    sign = np.where(neg_col[:, None] == neg_row[None, :], 1, -1).astype(np.int32)

    cycles = 0
    while col_cnt.any():
        en = (col_cnt[:, None] != 0) & (row_cnt[None, :] != 0)
        out += sign * en
        row_cnt = np.maximum(row_cnt - 1, 0)
        if not row_cnt.any():
            col_cnt = np.maximum(col_cnt - 1, 0)
            row_cnt = row_init.copy()
        cycles += 1
    return cycles


def _check(A: np.ndarray, B: np.ndarray, C: np.ndarray | None):
    A = np.asarray(A)
    B = np.asarray(B)
    if A.ndim != 2 or B.ndim != 2 or A.shape[1] != B.shape[0]:
        raise ValueError(f"bad GEMM shapes {A.shape} x {B.shape}")
    M, P = A.shape[0], B.shape[1]
    out = np.zeros((M, P), dtype=np.int32) if C is None else np.asarray(C).astype(np.int32).copy()
    return A, B, out


def simulate_serial(A: np.ndarray, B: np.ndarray, C: np.ndarray | None = None) -> SimResult:
    """Serial tuGEMM: the N steps run back to back (index counter serializes)."""
    A, B, out = _check(A, B, C)
    N = A.shape[1]
    per_step = np.zeros(N, dtype=np.int64)
    for i in range(N):  # index counter 0..N-1
        per_step[i] = simulate_step(A[:, i], B[i, :], out)
    return SimResult(out, int(per_step.sum()), per_step)


def simulate_parallel(A: np.ndarray, B: np.ndarray, C: np.ndarray | None = None) -> SimResult:
    """Parallel tuGEMM: N replicated vector counters; done when *all* assert
    col_done, so latency is the max over steps (output adder cells merge the
    N per-cycle contributions, which cannot be observed at this level beyond
    the final sums — bit-exact either way)."""
    A, B, out = _check(A, B, C)
    N = A.shape[1]
    per_step = np.zeros(N, dtype=np.int64)
    for i in range(N):  # all N vector counters start at cycle 0
        per_step[i] = simulate_step(A[:, i], B[i, :], out)
    return SimResult(out, int(per_step.max(initial=0)), per_step)
