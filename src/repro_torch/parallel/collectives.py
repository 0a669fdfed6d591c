"""Quantize-before-all-gather collectives and the mesh program of one
sharded step (the reference's ``repro/parallel/collectives.py`` on
``torch.distributed``).

The sharded serving step (``parallel/serve_mesh.py``) runs the unmodified
model body on every rank of a (dp, tp) process mesh. Model layers cannot
take a mesh handle through their signatures without rewriting every call
site, so the step activates a :class:`MeshProgram` for the duration of the
call and the quant / attention / MoE layers consult it
(``current_program()``), as ``quant.capture`` does for stats.

The paper's thesis applied to the interconnect: a tensor-parallel GEMM whose
input features are sharded (o-proj, down-proj) all-gathers the *quantized*
planes, not the bf16 activations: int8 moves half the bytes, int4 a quarter
(2 values a byte), int2 an eighth (4 values a byte), plus the f32 scales.
Dequantization happens after the collective, on the gathered int planes,
with scales synced by a MAX ``all_reduce`` over the raw amax (max is exact,
so the synced scale is bit-identical to the single-device global scale).

Every collective is metered: the program accumulates the bytes of each
call per (label, bits), with the reference's labels and byte counts (the
elements one rank receives, their bytes on the wire, the f32 scale bytes,
and what the same gather would move at bf16); the scheduler rolls them into
interconnect totals that ``core.report`` prices as an energy column.

The sharded train step (``parallel/train_mesh.py``) activates a
:class:`TrainProgram` instead: the conjugate pair of Megatron's
tensor-parallel cut (``enter``: identity forward, sum over tp backward;
``exit``: sum over tp forward, identity backward) as autograd Functions,
their sequence-parallel pair (an all-gather of the sequence forward and a
reduce-scatter backward into a sub-block; a reduce-scatter forward and an
all-gather backward out of it), the vocab-parallel embedding and
cross-entropy, and the sums over the batch's ranks.

Tensors move as bytes: every gather reinterprets its operand as ``uint8``
and views the result back, which is exact whatever dtypes a backend's
``all_gather`` accepts. With ``host_staged`` (gloo ranks whose tensors live
on a card) every collective copies through host memory.

A :class:`MetaGroup` stands in for a group of any size in the dry-run
(``launch/dryrun.py``): one rank's program runs on ``meta`` tensors, and
each collective returns a meta result of the right shape and charges the
active ``roofline.op_cost.OpCost`` (the reference's HLO collective table).
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch

from .host_shm import ShmGroup

__all__ = [
    "CollectiveRecord",
    "MetaGroup",
    "MeshProgram",
    "current_program",
    "activate",
    "TrainProgram",
    "current_train",
    "activate_train",
    "pack_wire",
    "unpack_wire",
    "wire_bits",
]


# ----------------------------------------------------------- wire bit-packing
def wire_bits(bits: int, feature_dim: int) -> int:
    """Bitwidth used on the wire for a quantized gather: sub-byte planes
    pack ``8 // bits`` values a byte along the feature axis, which needs the
    local feature count to be a multiple of the packing factor; otherwise
    the plane ships unpacked at 8 bits (and is metered so)."""
    if bits >= 8:
        return 8
    return bits if feature_dim % (8 // bits) == 0 else 8


def pack_wire(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack an int8 plane of ``bits``-wide values along the last axis.

    Values are offset-encoded (``+ 2^(bits-1)``) and packed little-endian
    within each byte, so a tiled all-gather of packed chunks concatenates to
    the packed form of the concatenated plane."""
    if wire_bits(bits, q.shape[-1]) == 8:
        return q
    vpb = 8 // bits
    g = q.reshape(q.shape[:-1] + (q.shape[-1] // vpb, vpb)).to(torch.int32) + (1 << (bits - 1))
    shifts = torch.arange(vpb, dtype=torch.int32, device=q.device) * bits
    return torch.bitwise_left_shift(g, shifts).sum(dim=-1).to(torch.uint8)


def unpack_wire(p: torch.Tensor, bits: int, features: int) -> torch.Tensor:
    """Inverse of :func:`pack_wire`; ``features`` is the unpacked last dim."""
    if wire_bits(bits, features) == 8:
        return p
    vpb = 8 // bits
    shifts = torch.arange(vpb, dtype=torch.int32, device=p.device) * bits
    vals = torch.bitwise_right_shift(p.to(torch.int32)[..., None], shifts) & ((1 << bits) - 1)
    return (vals - (1 << (bits - 1))).to(torch.int8).reshape(p.shape[:-1] + (features,))


# ------------------------------------------------------------- comms metering
@dataclass
class CollectiveRecord:
    """Byte accounting of one collective call site."""

    calls: int = 0
    elems: int = 0            # logical elements received (before packing)
    payload_bytes: int = 0    # bytes on the wire (after packing)
    scale_bytes: int = 0      # f32 scale syncs riding the collective
    bf16_bytes: int = 0       # what the same gather would move at bf16

    def add(self, elems: int, payload: int, scales: int) -> None:
        self.calls += 1
        self.elems += elems
        self.payload_bytes += payload
        self.scale_bytes += scales
        self.bf16_bytes += 2 * elems


def _to_host(x: torch.Tensor, host_staged: bool) -> torch.Tensor:
    x = x.detach().contiguous()
    return x.cpu() if host_staged else x


def _to_device(t: torch.Tensor, dev, host_staged: bool) -> torch.Tensor:
    """Back to the card without waiting: a pinned copy queued on the
    stream (the kernels after it wait for it, the host does not)."""
    return t.pin_memory().to(dev, non_blocking=True) if host_staged else t


def _bytes(x: torch.Tensor) -> torch.Tensor:
    """``x`` (contiguous) as uint8, one trailing axis of its element bytes."""
    return x.reshape(x.shape + (1,)).view(torch.uint8)


class MetaGroup:
    """A group of ``size`` ranks for a program run on ``meta`` tensors: the
    interface of ``host_shm.ShmGroup`` (and the serving path's gathers),
    each call returning an empty result of the shape the real collective
    gives and charging the active ``OpCost`` one collective of its kind
    (``calls`` keeps (kind, operand bytes, result bytes) of each)."""

    def __init__(self, size: int):
        self.size = int(size)
        self.calls: list = []

    def _charge(self, kind: str, operand: int, result: int) -> None:
        from ..roofline.op_cost import current_cost

        self.calls.append((kind, operand, result))
        cost = current_cost()
        if cost is not None:
            cost.collective(kind, operand, result)

    @staticmethod
    def _nb(x: torch.Tensor) -> int:
        return x.numel() * x.element_size()

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        self._charge("all-reduce", self._nb(x), self._nb(x))
        return torch.empty(x.shape, dtype=x.dtype, device=x.device)

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        shape = list(x.shape)
        shape[dim] *= self.size
        self._charge("all-gather", self._nb(x), self._nb(x) * self.size)
        return torch.empty(shape, dtype=x.dtype, device=x.device)

    def reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        shape = list(x.shape)
        shape[dim] //= self.size
        self._charge("reduce-scatter", self._nb(x), self._nb(x) // self.size)
        return torch.empty(shape, dtype=x.dtype, device=x.device)

    def gather_rows(self, xs: list) -> list:
        """Several tensors of one row count gathered along axis 0 in one
        ``all_gather`` (``_gather_rows``)."""
        nb = sum(self._nb(x) for x in xs)
        self._charge("all-gather", nb, nb * self.size)
        return [torch.empty((self.size * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                            device=x.device) for x in xs]

    def max_many(self, xs: list) -> list:
        """Several tensors MAX-reduced in one ``all_reduce`` (``_max``)."""
        nb = sum(self._nb(x) for x in xs)
        self._charge("all-reduce", nb, nb)
        return [torch.empty(x.shape, dtype=x.dtype, device=x.device) for x in xs]


def _gather(x: torch.Tensor, group, world: int, dim: int, host_staged: bool) -> torch.Tensor:
    """``all_gather`` over ``group`` concatenated along ``dim``, moving the
    operand's bytes."""
    if isinstance(group, MetaGroup):
        return group.all_gather(x, dim)
    src = _to_host(x, host_staged)
    raw = _bytes(src)
    parts = [torch.empty_like(raw) for _ in range(world)]
    torch.distributed.all_gather(parts, raw, group=group)
    out = torch.cat(parts, dim=dim).view(x.dtype).reshape(
        src.shape[:dim] + (world * src.shape[dim],) + src.shape[dim + 1:])
    return _to_device(out, x.device, host_staged)


def _gather_rows(xs: list, group, world: int, host_staged: bool) -> list:
    """Several tensors of the same row count all-gathered along axis 0 in
    one ``all_gather``: each row's bytes of every tensor travel together."""
    if isinstance(group, MetaGroup):
        return group.gather_rows(xs)
    srcs = [_to_host(x, host_staged) for x in xs]
    rows = srcs[0].shape[0]
    raw = torch.cat([_bytes(s).reshape(rows, -1) for s in srcs], dim=1)
    parts = [torch.empty_like(raw) for _ in range(world)]
    torch.distributed.all_gather(parts, raw, group=group)
    full = torch.cat(parts, dim=0)
    out, c = [], 0
    for x, s in zip(xs, srcs):
        n = s[:1].numel() * s.element_size()
        piece = full[:, c:c + n].contiguous().view(x.dtype).reshape((world * rows,) + s.shape[1:])
        out.append(_to_device(piece, x.device, host_staged))
        c += n
    return out


def _max(xs: list, group, host_staged: bool) -> list:
    """Elementwise MAX ``all_reduce`` over ``group`` of several f32
    tensors in one call (new tensors)."""
    if isinstance(group, MetaGroup):
        return group.max_many(xs)
    buf = torch.cat([_to_host(x, host_staged).reshape(-1) for x in xs])
    torch.distributed.all_reduce(buf, op=torch.distributed.ReduceOp.MAX, group=group)
    out, c = [], 0
    for x in xs:
        out.append(_to_device(buf[c:c + x.numel()].reshape(x.shape), x.device, host_staged))
        c += x.numel()
    return out


@dataclass
class MeshProgram:
    """One rank's view of a sharded step: its (d, t) coordinates, its dp
    group (the ranks of its tp column) and tp group (the ranks of its dp
    row), and what the layers do under the mesh.

    Consulted by ``quant.qlinear`` (feature gathers and amax syncs, float
    GEMMs at the single-device row count), ``models.attention`` (the KV
    scale sync, the dp row gather of pool writes, MLA's absorbed products
    at the single-device batch and heads), ``models.flash`` (the attention kernel's launch
    plan), ``models.moe`` (the expert slice and the output gather) and the
    tied LM head. ``comm_s`` accumulates the wall time spent inside the
    collectives."""

    dp: int = 1
    tp: int = 1
    d: int = 0
    t: int = 0
    dp_group: object = None
    tp_group: object = None
    world_group: object = None          # every rank (a dp and tp sync at once)
    host_staged: bool = False
    # GEMM names whose *input features* are tp-sharded (the upstream GEMM
    # was column-parallel) and are gathered before the contraction
    gather_gemms: frozenset = frozenset()
    # KV cache leaves with a tp-sharded head axis (their per-token scale is
    # amax-synced over tp); empty for MLA (the latent has no heads)
    kv_sync_names: frozenset = frozenset()
    # full-batch write view of the dp-replicated paged pool (None: the
    # dense layout, whose caches are batch-sharded and written locally)
    write_view: object = None
    # (label, bits) -> CollectiveRecord, filled as the step runs
    meter: dict = field(default_factory=dict)
    comm_s: float = 0.0
    # the last activation amax synced, keyed by its input (the q, k, v GEMMs
    # of one input, and gate / up, share one sync)
    memo: object = None

    # ---------------------------------------------------------------- meter
    def _timed(self, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            self.comm_s += time.perf_counter() - t0

    def _rec(self, label: str, bits: int) -> CollectiveRecord:
        return self.meter.setdefault((label, int(bits)), CollectiveRecord())

    def meter_snapshot(self) -> dict:
        """{(label, bits): {calls, elems, payload_bytes, scale_bytes,
        bf16_bytes}}: plain data, safe to accumulate on the host."""
        return {k: {"calls": r.calls, "elems": r.elems, "payload_bytes": r.payload_bytes,
                    "scale_bytes": r.scale_bytes, "bf16_bytes": r.bf16_bytes}
                for k, r in self.meter.items()}

    # --------------------------------------------------------- attention
    def attn_plan_dims(self, batch: int, heads: int, kv_heads: int, sq: int) -> tuple:
        """(batch, kv heads, rows a kv head) of the single-device launch
        that this rank's attention call is a slice of: the paged kernel
        takes its split plan from these, so each head's float combine order
        is the single-device one. Batch rows are dp-sharded; query heads
        are tp-sharded, kv heads too where the pool's head axis is."""
        kv = kv_heads * self.tp if self.kv_sync_names else kv_heads
        return batch * self.dp, kv, heads * self.tp // kv * sq

    # -------------------------------------------- float products at full shape
    def at_full(self, site: str, fn, *operands):
        """``fn`` over ``operands``, each a ``(tensor or None, {dim:
        factor})`` pair whose dim ``d`` is zero-padded ``factor``-fold to
        the single-device launch's shape, the result cut back along the
        first operand's padded dims. cuBLAS picks a float product's
        algorithm by its shape, and on the card a rank's shape moved two
        kinds of product by an ulp (``scripts/mesh_full_probe.py``): the
        bf16 GEMMs with the row count, MLA's absorbed einsums with the head
        count. Padded so, the rank's entries are the single-device ones
        bit for bit. ``site`` names the product. Integer GEMMs are exact at
        any shape and need no padding."""
        def pad(x, dims):
            if x is None:
                return x
            full = list(x.shape)
            for d, f in dims.items():
                full[d] *= f
            if full == list(x.shape):
                return x
            z = x.new_zeros(full)
            z[tuple(slice(0, n) for n in x.shape)] = x
            return z

        y = fn(*(pad(x, dims) for x, dims in operands))
        x, dims = operands[0]
        for d in dims:
            y = y.narrow(d, 0, x.shape[d])
        return y

    # ---------------------------------------------------------- scale syncs
    def sync_amax(self, amax: torch.Tensor, label: str, *, tp: bool = False, dp: bool = False,
                  moved: bool = True) -> torch.Tensor:
        """The global amax over tp (features or heads are tp-sharded)
        and / or dp (activation rows are dp-sharded): the reference's
        ``sync_amax_tp`` and ``sync_amax_dp`` as one MAX ``all_reduce`` over
        the ranks that span the asked axes, metered as the reference's one
        record an axis. ``moved=False`` meters the sync without moving
        anything (the caller holds its result already)."""
        tp, dp = tp and self.tp > 1, dp and self.dp > 1
        for on, n in ((tp, self.tp), (dp, self.dp)):
            if on:
                self._rec(f"amax:{label}", 32).add(amax.numel(), 0, 4 * amax.numel() * (n - 1))
        if not moved or not (tp or dp):
            return amax
        group = self.world_group if tp and dp else self.tp_group if tp else self.dp_group
        return self._timed(_max, [amax], group, self.host_staged)[0]

    def sync_amax_tp_many(self, items: list) -> list:
        """[(label, amax)] synced over tp in one ``all_reduce``, each
        metered as its own sync (the KV leaves of one write)."""
        if self.tp == 1 or not items:
            return [a for _, a in items]
        for label, a in items:
            self.sync_amax(a, label, tp=True, moved=False)
        return self._timed(_max, [a for _, a in items], self.tp_group, self.host_staged)

    # ---------------------------------------------------- quantized gathers
    def gather_features_quant(self, q: torch.Tensor, bits: int, label: str) -> torch.Tensor:
        """All-gather a locally quantized int8 plane over tp along the last
        (feature) axis, packed to ``bits`` on the wire when the local
        feature count allows. Returns the full-feature int8 plane."""
        if self.tp == 1:
            return q
        k_local = q.shape[-1]
        wb = wire_bits(bits, k_local)
        elems = q.numel() * (self.tp - 1)
        self._rec(f"gather:{label}", bits).add(elems, elems * wb // 8, 0)
        full = self._timed(_gather, pack_wire(q, bits), self.tp_group, self.tp, q.ndim - 1,
                           self.host_staged)
        return unpack_wire(full, bits, k_local * self.tp)

    def gather_features_f(self, x: torch.Tensor, label: str) -> torch.Tensor:
        """Full-precision feature gather over tp (the bf16 path; metered so
        the byte comparison is honest)."""
        if self.tp == 1:
            return x
        elems = x.numel() * (self.tp - 1)
        self._rec(f"gather:{label}", 16).add(elems, elems * x.element_size(), 0)
        return self._timed(_gather, x, self.tp_group, self.tp, x.ndim - 1, self.host_staged)

    def gather_rows_dp_many(self, items: list) -> list:
        """[(label, x)] of one row count all-gathered over dp to the full
        batch along axis 0 in one ``all_gather`` (the paged pool's KV
        writes: every rank writes every row's tokens), each metered as the
        reference's ``gather_rows_dp`` meters it."""
        if self.dp == 1 or not items:
            return [x for _, x in items]
        for label, x in items:
            elems = x.numel() * (self.dp - 1)
            self._rec(f"gather:{label}", 8 * x.element_size()).add(
                elems, elems * x.element_size(), 0)
        return self._timed(_gather_rows, [x for _, x in items], self.dp_group, self.dp,
                           self.host_staged)

    def gather_experts(self, y: torch.Tensor, label: str) -> torch.Tensor:
        """All-gather expert-local outputs over tp along the experts axis
        (axis 0), at full precision: the combine's gate-weighted sum must
        equal the single-device result bit for bit."""
        if self.tp == 1:
            return y
        elems = y.numel() * (self.tp - 1)
        self._rec(f"gather:{label}", 16).add(elems, elems * y.element_size(), 0)
        return self._timed(_gather, y, self.tp_group, self.tp, 0, self.host_staged)


_PROGRAM: list[MeshProgram] = []


def current_program() -> MeshProgram | None:
    return _PROGRAM[-1] if _PROGRAM else None


@contextmanager
def activate(prog: MeshProgram):
    """Activate ``prog`` for the enclosed step."""
    _PROGRAM.append(prog)
    try:
        yield prog
    finally:
        _PROGRAM.pop()


# ------------------------------------------------------------ training mesh
def ring_bytes(kind: str, nbytes: int, world: int) -> int:
    """Bytes one rank receives in a ring collective over ``world`` ranks
    whose operand on this rank is ``nbytes``: an all-reduce ``2(n-1)/n`` of
    it, a reduce-scatter ``(n-1)/n``, an all-gather ``(n-1)`` times it."""
    if world <= 1:
        return 0
    if kind == "all_reduce":
        return 2 * (world - 1) * nbytes // world
    if kind == "reduce_scatter":
        return (world - 1) * nbytes // world
    return (world - 1) * nbytes


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """A new tensor: ``x`` summed (or maxed) over ``group`` (a
    ``host_shm.ShmGroup``, or a process group whose backend takes ``x``
    where it lies: nccl on the card)."""
    if isinstance(group, (ShmGroup, MetaGroup)):
        return group.all_reduce(x, op)
    buf = x.detach().clone(memory_format=torch.contiguous_format)
    red = torch.distributed.ReduceOp.SUM if op == "sum" else torch.distributed.ReduceOp.MAX
    torch.distributed.all_reduce(buf, op=red, group=group)
    return buf


def all_gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """``x`` of every rank of ``group``, in group-rank order, concatenated
    along ``dim``."""
    if isinstance(group, (ShmGroup, MetaGroup)):
        return group.all_gather(x, dim)
    return _gather(x, group, torch.distributed.get_world_size(group), dim, False)


def reduce_scatter_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """``x`` summed over ``group``, this rank's ``1/n`` part along ``dim``
    (group-rank order)."""
    if isinstance(group, (ShmGroup, MetaGroup)):
        return group.reduce_scatter(x, dim)
    n = torch.distributed.get_world_size(group)
    src = x.detach().movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    torch.distributed.reduce_scatter(out, list(src.chunk(n)), group=group)
    return out.movedim(0, dim)


class _Enter(torch.autograd.Function):
    """Where a replicated activation enters a tensor-parallel region:
    identity forward, the gradient summed over tp backward (each tp rank
    holds the part of the gradient its heads, columns or experts made)."""

    @staticmethod
    def forward(ctx, x, prog):
        ctx.prog = prog
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.prog.reduce_tp(g, "tp_all_reduce:enter_bwd"), None


class _SeqGather(torch.autograd.Function):
    """Where the sequence-sharded residual stream enters a sub-block under
    sequence parallelism: every tp rank's columns all-gathered along the
    sequence (dim 1) forward; backward, the ranks' partial gradients summed
    and each rank's columns kept (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, prog):
        ctx.prog = prog
        return prog.run("tp_all_gather:seq", "all_gather", x, prog.tp, all_gather_dim,
                        prog.tp_group, 1)

    @staticmethod
    def backward(ctx, g):
        p = ctx.prog
        return p.run("tp_reduce_scatter:seq_bwd", "reduce_scatter", g, p.tp, reduce_scatter_dim,
                     p.tp_group, 1), None


class _SeqScatter(torch.autograd.Function):
    """Where a cut sub-block's partial sums leave it under sequence
    parallelism: summed over tp and each rank's columns kept forward (a
    reduce-scatter along the sequence); backward, the columns' gradients
    all-gathered (every rank's partial sum needs every column's)."""

    @staticmethod
    def forward(ctx, x, prog, label):
        ctx.prog = prog
        return prog.run(label, "reduce_scatter", x, prog.tp, reduce_scatter_dim, prog.tp_group, 1)

    @staticmethod
    def backward(ctx, g):
        p = ctx.prog
        return p.run("tp_all_gather:seq_bwd", "all_gather", g, p.tp, all_gather_dim, p.tp_group,
                     1), None, None


class _Exit(torch.autograd.Function):
    """Where a tensor-parallel region's partial sums leave it: summed over
    tp forward, identity backward (every tp rank's consumer is the same
    replicated computation, so its gradient is already whole)."""

    @staticmethod
    def forward(ctx, x, prog, label):
        return prog.reduce_tp(x, label)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


@dataclass
class TrainProgram:
    """One rank's view of a sharded train step (``parallel/train_mesh.py``),
    consulted by the model body: ``models.transformer`` (a block's
    sub-blocks between :meth:`block_in` and :meth:`block_out`, the
    vocab-parallel embedding), ``models.ssm`` (the row-parallel
    ``x_proj``'s sum), ``models.moe`` (the rank's experts, the batch-global
    aux loss) and ``models.model.loss_fn`` (the vocab-parallel
    cross-entropy, the loss over the global batch). ``cuts`` names the
    sub-blocks cut over tp (``attn``, ``mlp``, ``moe``, ``ssm``, and
    ``vocab`` for the embedding and head); one that tp does not divide runs
    whole on every tp rank. ``sp``: sequence parallelism (``seq ->
    model``), the residual stream between sub-blocks holds this rank's
    ``S/tp`` columns. Every collective is metered by label: calls, operand
    bytes and the ring model's bytes received a rank (:func:`ring_bytes`);
    ``comm_s`` is the wall time inside them."""

    tp: int = 1
    t: int = 0
    tp_group: object = None
    dp_group: object = None             # the ranks of this tp column: the batch's split
    dp: int = 1
    cuts: frozenset = frozenset()
    sp: bool = False
    meter: dict = field(default_factory=dict)
    comm_s: float = 0.0

    def run(self, label: str, kind: str, x: torch.Tensor, world: int, fn, *args):
        """``fn(x, *args)``, metered under ``label`` as a ``kind``
        collective over ``world`` ranks whose operand is ``x``."""
        nbytes = x.numel() * x.element_size()
        r = self.meter.setdefault(label, {"calls": 0, "bytes": 0, "wire_bytes": 0,
                                          "seconds": 0.0})
        t0 = time.perf_counter()
        try:
            return fn(x, *args)
        finally:
            dt = time.perf_counter() - t0
            r["calls"] += 1
            r["bytes"] += nbytes
            r["wire_bytes"] += ring_bytes(kind, nbytes, world)
            r["seconds"] += dt
            self.comm_s += dt

    def reduce_tp(self, x: torch.Tensor, label: str, op: str = "sum") -> torch.Tensor:
        return self.run(label, "all_reduce", x, self.tp, all_reduce, self.tp_group, op)

    def sum_dp(self, x: torch.Tensor, label: str) -> torch.Tensor:
        """``x`` (no gradient) summed over the batch's ranks."""
        if self.dp == 1:
            return x.detach()
        return self.run(label, "all_reduce", x, self.dp, all_reduce, self.dp_group)

    def sum_tp(self, x: torch.Tensor, label: str) -> torch.Tensor:
        """``x`` (no gradient) summed over tp."""
        if self.tp == 1:
            return x.detach()
        return self.run(label, "all_reduce", x, self.tp, all_reduce, self.tp_group)

    # ------------------------------------------------------ model-body hooks
    def cut(self, kind: str) -> bool:
        """Whether the sub-block ``kind`` runs cut over tp (else whole on
        every tp rank)."""
        return self.tp > 1 and kind in self.cuts

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return _Enter.apply(x, self) if self.tp > 1 else x

    def exit(self, x: torch.Tensor, label: str = "tp_all_reduce:exit") -> torch.Tensor:
        return _Exit.apply(x, self, label) if self.tp > 1 else x

    def seq_shard(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's ``1/tp`` of the sequence (dim ``dim``) of ``x``."""
        n = x.shape[dim] // self.tp
        return x.narrow(dim, self.t * n, n)

    def block_in(self, x: torch.Tensor, cut: bool) -> torch.Tensor:
        """A sub-block's input from the residual stream: under sequence
        parallelism the whole sequence, gathered (its backward sums the
        ranks' gradients); else, into a cut sub-block, :meth:`enter`; a
        sub-block run whole takes ``x`` as it is."""
        if self.sp:
            return _SeqGather.apply(x, self)
        return self.enter(x) if cut else x

    def block_out(self, y: torch.Tensor, cut: bool, label: str = "tp_all_reduce:exit"):
        """A sub-block's output back to the residual stream: a cut one's
        partial sums summed over tp (under sequence parallelism
        reduce-scattered to this rank's columns); a whole one's ``y`` (its
        own columns under sequence parallelism: the other ranks' columns'
        gradients are theirs)."""
        if self.sp:
            return _SeqScatter.apply(y, self, "tp_reduce_scatter:seq") if cut else self.seq_shard(y)
        return self.exit(y, label) if cut else y

    def embed(self, table: torch.Tensor, tokens: torch.Tensor, dtype) -> torch.Tensor:
        """The vocab-parallel lookup: this rank's rows of the table (a
        ``1/tp`` vocab range), zero for a token outside it, summed over tp
        (reduce-scattered to this rank's columns under sequence
        parallelism). A vocab that tp does not divide is looked up whole (on
        this rank's columns under sequence parallelism)."""
        if not self.cut("vocab"):
            return table.to(dtype)[self.seq_shard(tokens) if self.sp else tokens]
        v = table.shape[0]
        local = tokens.long() - self.t * v
        inside = (local >= 0) & (local < v)
        x = table.to(dtype)[local.clamp(0, v - 1)] * inside[..., None].to(dtype)
        if self.sp:
            return _SeqScatter.apply(x, self, "tp_reduce_scatter:embed")
        return self.exit(x, "tp_all_reduce:embed")

    def xent(self, logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor):
        """The vocab-parallel token cross-entropy of logits over this rank's
        vocab range: (sum of masked NLL, sum of the mask) over this rank's
        rows, each the same on every tp rank. The log-sum-exp takes the max
        over tp, then one sum over tp of (the exp sums, the gold logit)."""
        lf = logits.to(torch.float32)
        m = self.reduce_tp(lf.detach().amax(dim=-1), "tp_all_reduce:xent_max", op="max")
        s = torch.exp(lf - m[..., None]).sum(dim=-1)
        v = lf.shape[-1]
        local = labels.long() - self.t * v
        inside = (local >= 0) & (local < v)
        gold = torch.gather(lf, -1, local.clamp(0, v - 1)[..., None])[..., 0] * inside
        s, gold = self.exit(torch.stack([s, gold]), "tp_all_reduce:xent_sum").unbind(0)
        nll = (m + torch.log(s) - gold) * mask
        return nll.sum(), mask.sum()


_TRAIN: list[TrainProgram] = []


def current_train() -> TrainProgram | None:
    return _TRAIN[-1] if _TRAIN else None


@contextmanager
def activate_train(prog: TrainProgram):
    """Activate ``prog`` for the enclosed forward and backward."""
    _TRAIN.append(prog)
    try:
        yield prog
    finally:
        _TRAIN.pop()
