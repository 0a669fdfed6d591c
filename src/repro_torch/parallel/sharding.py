"""Logical-axis sharding rules and the mesh context (the reference's
``repro/parallel/sharding.py``).

Parameters, state and activations carry *logical* axis names ("embed",
"heads", "mlp", "vocab", "experts", "batch", ...). A rules table maps each
to a mesh axis; :func:`spec_for` applies it with a divisibility guard (a
dim that does not divide its mesh axis is replicated, loudly: one
:class:`ReplicatedDimWarning` per distinct site and a running count). One
table gives DP / FSDP / TP / EP:

- DP:   "batch" -> ("pod", "data")
- FSDP: "embed" -> "data"   (parameters and their state sharded on embed)
- TP:   "heads" / "mlp" / "vocab" -> "model"
- EP:   "experts" -> "model"

The mesh is a shape (:class:`MeshShape`: axis names with sizes), not a set
of devices: the port's ranks are processes (``launch/mesh.py``) and each
one cuts its own part of a tree by the specs (``parallel/state_sharding.py``).
The reference's ``sharding_for``, ``shape_structs`` and ``with_sharding``
hand layouts to XLA's partitioner; an eager program has no partitioner to
hand them to, so they have no counterpart here: the sharded steps
(``parallel/serve_mesh.py``, ``parallel/train_mesh.py``) issue their
collectives themselves. :func:`constrain`, called at the reference's 15
sites of the model body, keeps only the reference's *accounting*: under an
active context it asks :func:`spec_for` for the activation's spec, so a dim
that does not divide its mesh axis counts in ``replicated_dims`` (what
``health()["sharding"]`` and the dry-run report); it lays nothing out and
moves nothing. The reference counts at trace time; the port counts each
(site, layer, shape, step width) once a context, which equals the reference
traced with ``scan_layers=False``, one trace a step width. A spec is a tuple with one
entry a dim: a mesh axis, a tuple of them, or None (the reference's
``PartitionSpec`` entries).
"""

from __future__ import annotations

import math
import sys
import threading
import warnings
from contextlib import contextmanager
from dataclasses import dataclass, field

__all__ = [
    "DEFAULT_RULES",
    "MeshShape",
    "MeshContext",
    "ReplicatedDimWarning",
    "use_mesh",
    "suspend_mesh",
    "current_ctx",
    "spec_for",
    "constrain",
    "at_layer",
]


class ReplicatedDimWarning(UserWarning):
    """A logical dim did not divide its mesh axis and was replicated.

    Replicating is *correct* but can be a large silent cost (40 heads on a
    16-way model axis keep every head on every chip): the warning fires
    once per distinct (logical axis, dim, mesh axis) per
    :class:`MeshContext`, whose ``replicated_dims`` counter keeps the total."""


# logical axis -> mesh axis (str), tuple of mesh axes, or None (replicate)
DEFAULT_RULES: dict[str, object] = {
    "batch": ("pod", "data"),
    "group": ("pod", "data", "model"),   # MoE dispatch groups (batch × seq shard)
    "group_data": ("pod", "data"),       # token dim of EP-resharded buffers
    "seq": None,
    "act_embed": None,
    "act_heads": "model",
    "act_mlp": "model",
    "act_vocab": "model",
    "act_inner": "model",
    "act_experts": "model",
    "layers": None,
    "embed": "data",          # FSDP
    "heads": "model",         # TP
    "kv_heads": "model",
    "head_dim": None,
    "qk_dim": None,
    "mlp": "model",
    "vocab": "model",
    "experts": "model",       # EP
    "kv_lora": None,
    "kv_seq": "model",        # serving KV-cache sequence dim (baseline layout)
    "cache_heads": None,      # cache kv-head dim (rarely divides `model`)
    "conv": None,
    "state": None,
    "dt": None,
    "inner": "model",
    "classes": None,
    None: None,
}


@dataclass(frozen=True)
class MeshShape:
    """A mesh as axis names with sizes, e.g. ``MeshShape(("data", "model"),
    (2, 2))``. ``shape`` is {axis: size}, as a JAX mesh's."""

    axes: tuple
    sizes: tuple

    def __post_init__(self):
        if len(self.axes) != len(self.sizes) or len(set(self.axes)) != len(self.axes):
            raise ValueError(f"mesh axes {self.axes} and sizes {self.sizes} do not match")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axes, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def coords(self, rank: int) -> dict:
        """{axis: index} of ``rank`` (row-major over the axes: the last
        axis varies fastest)."""
        out = {}
        for ax, n in reversed(list(zip(self.axes, self.sizes))):
            rank, out[ax] = divmod(rank, n)
        return {ax: out[ax] for ax in self.axes}


_local = threading.local()


@dataclass
class MeshContext:
    mesh: MeshShape
    rules: dict = field(default_factory=lambda: dict(DEFAULT_RULES))
    dropped: list = field(default_factory=list)   # (axis, dim, mesh axis) divisibility drops
    replicated_dims: int = 0
    _warned: set = field(default_factory=set)
    # rules whose mesh axes were absent from this mesh at use_mesh() time:
    # {logical axis: original mesh axis spec}
    dropped_rules: dict = field(default_factory=dict)
    # (site, layer, shape, step) of every constrain call counted under this context
    constrained: set = field(default_factory=set)
    # whether any mesh axis is larger than 1 (else no dim can replicate)
    splits: bool = field(init=False, default=False)

    def __post_init__(self):
        self.splits = self.mesh.size > 1

    def note_replicated(self, name, dim: int, mesh_ax) -> None:
        """Record one divisibility drop; warn the first time this exact
        (logical axis, dim, mesh axis) replicates under this context."""
        self.dropped.append((name, dim, mesh_ax))
        self.replicated_dims += 1
        key = (name, int(dim), mesh_ax)
        if key not in self._warned:
            self._warned.add(key)
            warnings.warn(
                f"sharding: logical axis {name!r} (dim {dim}) does not divide "
                f"mesh axis {mesh_ax!r} (size {self.axis_size(mesh_ax)}) — "
                f"replicating (MeshContext.replicated_dims={self.replicated_dims})",
                ReplicatedDimWarning,
                stacklevel=3,
            )

    def axis_size(self, axis) -> int:
        if axis is None:
            return 1
        if isinstance(axis, tuple):
            return math.prod(self.mesh.shape[a] for a in axis)
        return int(self.mesh.shape[axis])


def current_ctx() -> MeshContext | None:
    return getattr(_local, "ctx", None)


@contextmanager
def use_mesh(mesh: MeshShape, rules: dict | None = None, overrides: dict | None = None):
    """Activate a mesh shape and rules table for the enclosed spec calls.
    A rule naming a mesh axis this mesh lacks ("pod" on a two-axis mesh)
    is cut to the axes present, and what was cut is recorded in the
    context's ``dropped_rules``."""
    r = dict(DEFAULT_RULES)
    if rules:
        r.update(rules)
    if overrides:
        r.update(overrides)
    dropped_rules: dict = {}
    present = mesh.shape

    def _filter(k, ax):
        if ax is None:
            return None
        if isinstance(ax, tuple):
            kept = tuple(a for a in ax if a in present)
            if kept != ax:
                dropped_rules[k] = ax
            return kept or None
        if ax not in present:
            dropped_rules[k] = ax
            return None
        return ax

    r = {k: _filter(k, v) for k, v in r.items()}
    prev = getattr(_local, "ctx", None)
    _local.ctx = MeshContext(mesh=mesh, rules=r, dropped_rules=dropped_rules)
    try:
        yield _local.ctx
    finally:
        _local.ctx = prev


@contextmanager
def suspend_mesh():
    """Deactivate the mesh context for the enclosed block (restored on
    exit): :func:`spec_for` then replicates everything."""
    prev = getattr(_local, "ctx", None)
    _local.ctx = None
    try:
        yield
    finally:
        _local.ctx = prev


def spec_for(axes: tuple, shape: tuple | None = None) -> tuple:
    """The spec of logical ``axes`` under the active context (all None
    without one), with the divisibility guard when ``shape`` is known. A
    mesh axis shards at most one dim: the first logical axis that maps to
    it wins (MoE expert weights ("experts", "embed", "mlp") shard on
    "experts" only)."""
    ctx = current_ctx()
    if ctx is None:
        return (None,) * len(axes)
    out = []
    used: set = set()
    for i, name in enumerate(axes):
        mesh_ax = ctx.rules.get(name)
        if mesh_ax is None:
            out.append(None)
            continue
        flat = mesh_ax if isinstance(mesh_ax, tuple) else (mesh_ax,)
        if any(a in used for a in flat):
            out.append(None)
            continue
        if shape is not None and shape[i] % ctx.axis_size(mesh_ax) != 0:
            ctx.note_replicated(name, shape[i], mesh_ax)
            out.append(None)
            continue
        # one mesh axis in a tuple is that axis (as a PartitionSpec has it)
        out.append(flat[0] if len(flat) == 1 else mesh_ax)
        used.update(flat)
    return tuple(out)


_layer = [None, None]


def at_layer(key, step=None) -> None:
    """Mark the layer the model body is in (``models/transformer.py``;
    None outside the layers) and, at a forward's start, the step's input
    shape (the reference's trace), for :func:`constrain`'s count."""
    _layer[0] = key
    if step is not None:
        _layer[1] = step


def constrain(x, *axes):
    """The reference's ``constrain`` as accounting only: under an active
    context the spec of ``x`` by logical ``axes`` is taken once for each
    (calling site, layer, shape, step width), so a dim that does not divide counts in
    ``replicated_dims``; ``x`` is returned as it is (no layout, no copy).
    A context whose mesh axes are all 1 replicates nothing: nothing is taken."""
    ctx = current_ctx()
    if ctx is None or not ctx.splits:
        return x
    from .collectives import current_program

    if current_program() is not None:
        # a rank of the serving mesh holds a slice of each activation: its
        # shapes are not the layout's, and count nothing
        return x
    f = sys._getframe(1)
    key = (f.f_code.co_filename, f.f_lineno, _layer[0], _layer[1], tuple(x.shape))
    if key not in ctx.constrained:
        ctx.constrained.add(key)
        spec_for(tuple(axes), tuple(x.shape))
    return x
