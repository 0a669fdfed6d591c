"""Counted costs of a step run on ``meta`` tensors (the counterpart of the
reference's ``repro/roofline/hlo_parse.py``, which reads them from an
optimized XLA module's text).

The port has no compiler to ask, so :func:`count_ops` runs the step itself
on ``meta`` tensors (shapes and dtypes, no data, no device) under a
``TorchDispatchMode`` that sees every aten op, and yields an
:class:`OpCost`:

- **flops**: every matmul-class op (mm, addmm, bmm, baddbmm, convolution,
  the SDPA ops) by ``torch.utils.flop_counter``'s formulas: the
  reference's "every ``dot``" rule. Elementwise ops are free, as there.
- **hbm_bytes**: every op is charged its inputs' and outputs' bytes once,
  "each kernel touches its buffers once". Views, metadata ops and
  allocations are free (the reference's ``_SKIP_BYTES``); a scatter into
  a buffer is charged twice its update and a gather twice its result (the
  reference's ``dynamic-update-slice`` / ``gather`` rule), not the buffer.
  Each hand-written kernel's wrapper, given ``meta`` tensors, charges its
  own count as one op (``roofline.kernel_cost``).
- **collective_bytes**, ``collectives`` and ``collective_counts``: the
  collective calls the rank program makes on a meta group
  (``parallel.collectives.MetaGroup``), priced by
  ``roofline.analysis.COLLECTIVE_PRICE``.
- **peak_bytes**: the high-water mark of live meta storage (each output's
  storage tracked through a weak reference, plus what :meth:`OpCost.hold`
  is given), the counterpart of the compiled module's peak memory.
- **charges**: by (the innermost ``obs.profile.named_scope`` label, op):
  bytes, FLOPs, calls and the largest shape, for the probe's forensics;
  with ``trace=True`` also every op in order (:attr:`OpCost.trace`).

Plain PyTorch ops are charged as the eager program runs them, one kernel an
op; a fused XLA module moves fewer bytes, so the memory term is an upper
estimate where the reference's is a fusion-dependent one. FLOPs compare
(``tests/test_torch_dryrun.py``).
"""

from __future__ import annotations

import weakref
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from .analysis import CollectiveStats

__all__ = ["OpCost", "count_ops", "current_cost"]

_aten = torch.ops.aten

# allocations and fills (the reference's parameter / constant / iota /
# broadcast): free
_FREE = {
    _aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
    _aten.new_empty_strided, _aten.zeros, _aten.zeros_like, _aten.new_zeros, _aten.ones,
    _aten.ones_like, _aten.new_ones, _aten.full, _aten.full_like, _aten.new_full,
    _aten.scalar_tensor, _aten.arange, _aten.lift_fresh, _aten.lift_fresh_copy,
    _aten.detach, _aten.alias, _aten._unsafe_view,
}
# writes of a window into a buffer: twice the update (the last tensor argument)
_SCATTER = {
    _aten.index_put, _aten.index_put_, _aten._index_put_impl_, _aten.scatter,
    _aten.scatter_, _aten.scatter_add, _aten.scatter_add_, _aten.scatter_reduce,
    _aten.scatter_reduce_, _aten.index_copy, _aten.index_copy_, _aten.index_add,
    _aten.index_add_, _aten.slice_scatter, _aten.select_scatter,
}
# reads of a window out of a buffer: twice the result
_GATHER = {_aten.index, _aten.gather, _aten.index_select, _aten.embedding, _aten.take}


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


@dataclass
class OpCost:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    comms: CollectiveStats = field(default_factory=CollectiveStats)
    peak_bytes: int = 0
    live_bytes: int = 0
    ops: int = 0
    # (label, op) -> {"bytes", "flops", "calls", "shape"}
    charges: dict = field(default_factory=dict)
    trace: list | None = None
    _live: set = field(default_factory=set)

    @property
    def collective_bytes(self) -> float:
        return self.comms.total_bytes

    @property
    def collectives(self) -> dict:
        """kind -> bytes"""
        return self.comms.bytes_by_kind

    @property
    def collective_counts(self) -> dict:
        """kind -> calls"""
        return self.comms.count_by_kind

    # ----------------------------------------------------------- charging
    def op(self, name: str, byts: float, flops: float, shape: tuple = (),
           label: str | None = None) -> None:
        """One op: ``byts`` HBM bytes and ``flops`` FLOPs."""
        from ..obs.profile import current_scope

        label = current_scope() if label is None else label
        self.ops += 1
        self.hbm_bytes += byts
        self.flops += flops
        c = self.charges.setdefault((label, name), {"bytes": 0.0, "flops": 0.0, "calls": 0,
                                                    "shape": ()})
        c["bytes"] += byts
        c["flops"] += flops
        c["calls"] += 1
        if len(shape) and (not c["shape"] or _numel(shape) > _numel(c["shape"])):
            c["shape"] = tuple(shape)
        if self.trace is not None:
            self.trace.append({"op": name, "label": label, "bytes": byts, "flops": flops,
                               "shape": list(shape)})

    def kernel(self, name: str, byts: float, ops: float, shape: tuple = ()) -> None:
        """A hand-written kernel's call on meta tensors, at its own count."""
        self.op(name, byts, ops, shape)

    def collective(self, kind: str, operand_bytes: float, result_bytes: float) -> float:
        """One collective call, priced by the reference's table; returns its
        bytes."""
        nbytes = self.comms.charge(kind, operand_bytes, result_bytes)
        self.op(kind, 0.0, 0.0, ())
        return nbytes

    # ------------------------------------------------------------- memory
    def hold(self, tensors) -> None:
        """Count the storage of ``tensors`` (a tree) as live from now until
        it is freed: the state a step runs on."""
        for t in _tensors(tensors):
            self._track(t)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live.add(key)
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key, n) -> None:
        if key in self._live:
            self._live.discard(key)
            self.live_bytes -= n

    # ---------------------------------------------------------- forensics
    def top_bytes(self, n: int = 10) -> list:
        """The ``n`` largest byte charges: [(label, op, {bytes, flops,
        calls, shape})]."""
        rows = sorted(self.charges.items(), key=lambda kv: -kv[1]["bytes"])
        return [(label, op, c) for (label, op), c in rows[:n]]


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


_COSTS: list[OpCost] = []


def current_cost() -> OpCost | None:
    return _COSTS[-1] if _COSTS else None


class _Counter(TorchDispatchMode):
    def __init__(self, cost: OpCost):
        super().__init__()
        self.cost = cost

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        cost = self.cost
        for t in outs:
            if t.device.type == "meta":
                cost._track(t)
        packet = func._overloadpacket
        if not outs or func.is_view or packet in _FREE:
            return out
        ins = _tensors((args, kwargs))
        if packet in _SCATTER:
            byts = 2 * _nbytes(ins[-1:]) if len(ins) > 1 else _nbytes(outs)
        elif packet in _GATHER:
            byts = 2 * _nbytes(outs)
        else:
            byts = _nbytes(ins) + _nbytes(outs)
        fn = flop_registry.get(packet)
        flops = fn(*args, **kwargs, out_val=out) if fn is not None else 0
        cost.op(packet.__name__, byts, flops, tuple(outs[0].shape))
        return out


@contextmanager
def count_ops(trace: bool = False):
    """Count every op of the enclosed block (run it on ``meta`` tensors);
    yields the :class:`OpCost`. ``trace`` keeps every op in order."""
    cost = OpCost(trace=[] if trace else None)
    _COSTS.append(cost)
    try:
        with _Counter(cost):
            yield cost
    finally:
        _COSTS.pop()
