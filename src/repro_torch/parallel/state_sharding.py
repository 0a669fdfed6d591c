"""Partition specs of the whole train and serve state, and the cuts that
go with them (the reference's ``repro/parallel/state_sharding.py``).

Every spec comes from the logical axes under the active mesh context
(``parallel.sharding.use_mesh``): a parameter's from ``models.param_axes``;
an optimizer-state leaf mirrors its parameter's axes (the int8 moments'
``q`` and ``s`` leaves have the parameter's rank, so the same axes apply and
the divisibility guard replicates a block-count dim that no longer
divides); step counters and scalars replicate; cache leaves take the
serving layout; batch leaves shard rows on ``batch``. The functions return
flat {leaf path: spec} maps, the paths as ``tree.leaves_with_paths`` names
them (``opt/1/groups/0/k0/attn/wq/kernel``), each spec a tuple with one
entry a dim (``parallel.sharding.spec_for``).

:func:`shard_tree` cuts a full tree to one rank's part by such a map;
:func:`gather_tree` puts the full tree back together from every rank's.
"""

from __future__ import annotations

import math

import torch

from ..configs.base import ModelConfig, RunConfig
from ..tree import leaves_with_paths, tree_map_with_path
from .sharding import MeshShape, spec_for

__all__ = [
    "BATCH_AXES",
    "abstract_train_state",
    "train_state_specs",
    "cache_specs",
    "batch_specs",
    "prequant_param_specs",
    "part_slices",
    "part_shape",
    "shard_leaf",
    "shard_tree",
    "gather_tree",
]

BATCH_AXES = {
    "tokens": ("batch", "seq"),
    "labels": ("batch", "seq"),
    "loss_mask": ("batch", "seq"),
    "embeds": ("batch", "seq", None),
    "positions": (None, "batch", "seq"),
}

_CACHE_AXES = {
    "k": ("layers", "batch", "kv_seq", "cache_heads", None),
    "v": ("layers", "batch", "kv_seq", "cache_heads", None),
    "k_scale": ("layers", "batch", "kv_seq"),
    "v_scale": ("layers", "batch", "kv_seq"),
    "ckv": ("layers", "batch", "kv_seq", None),
    "kr": ("layers", "batch", "kv_seq", None),
    "ckv_scale": ("layers", "batch", "kv_seq"),
    "kr_scale": ("layers", "batch", "kv_seq"),
    "h": ("layers", "batch", "inner", None),
    "conv": ("layers", "batch", None, "inner"),
}

# paged layout: a KV leaf is a page pool (layers, pages+1, block, ...):
# pages replicate (any slot's block table must reach any page from its data
# shard) and the pool shards on heads
_PAGED_CACHE_AXES = {
    "k": ("layers", None, None, "cache_heads", None),
    "v": ("layers", None, None, "cache_heads", None),
    "k_scale": ("layers", None, None),
    "v_scale": ("layers", None, None),
    "ckv": ("layers", None, None, None),
    "kr": ("layers", None, None, None),
    "ckv_scale": ("layers", None, None),
    "kr_scale": ("layers", None, None),
}


def _axes_by_path(cfg: ModelConfig) -> dict:
    """{parameter path: logical axes} from ``models.param_axes``."""
    from ..models import param_axes

    out: dict = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{prefix}/{k}" if prefix else k)
        elif isinstance(node, tuple) and node and isinstance(node[0], dict):
            for i, v in enumerate(node):
                walk(v, f"{prefix}/{i}" if prefix else str(i))
        else:
            out[prefix] = node

    walk(param_axes(cfg), "")
    return out


def _tensor_specs(fn, tree) -> dict:
    """{path: fn(path, leaf)} over the tensor leaves of ``tree`` (a packed
    leaf's ``QBits`` marker is no array, and has no spec)."""
    return {n: fn(n, leaf) for n, leaf in leaves_with_paths(tree)
            if isinstance(leaf, torch.Tensor)}


def abstract_train_state(cfg: ModelConfig, rc: RunConfig) -> dict:
    """``train.init_train_state``'s tree as ``meta`` tensors."""
    from ..models.model import abstract_params
    from ..train.train_step import init_train_state

    return init_train_state(cfg, rc, abstract_params(cfg, rc))


def train_state_specs(cfg: ModelConfig, rc: RunConfig, state) -> dict:
    """{path: spec} of every leaf of a train state (``params/...``,
    ``opt/<field>/...`` with ``.../q`` and ``.../s`` under int8 moments,
    ``ef/...``): a leaf takes its parameter's axes, a leaf with no
    parameter (the step counter) replicates."""
    axes_by_path = _axes_by_path(cfg)

    def leaf_axes(path: str, leaf) -> tuple:
        parts = path.split("/")
        if parts[-1] in ("q", "s"):
            parts = parts[:-1]
        if parts[0] in ("params", "ef"):
            parts = parts[1:]
        elif parts[0] == "opt":
            parts = parts[2:]
        return axes_by_path.get("/".join(parts), (None,) * leaf.ndim)

    return _tensor_specs(lambda n, leaf: spec_for(leaf_axes(n, leaf), tuple(leaf.shape)), state)


def cache_specs(cfg: ModelConfig, rc: RunConfig, caches) -> dict:
    """{path: spec} of a cache tree: the dense layout shards slots on
    ``batch`` and the sequence on ``kv_seq``; a paged pool replicates its
    pages and shards on ``cache_heads``."""
    axes_map = dict(_CACHE_AXES)
    if rc.kv_layout == "paged":
        axes_map.update(_PAGED_CACHE_AXES)

    def one(path, leaf):
        axes = axes_map.get(path.split("/")[-1], (None,) * leaf.ndim)
        return spec_for(axes, tuple(leaf.shape))

    return _tensor_specs(one, caches)


def batch_specs(batch) -> dict:
    """{name: spec} of a batch's leaves (rows on ``batch``)."""
    def one(path, leaf):
        axes = BATCH_AXES.get(path.split("/")[-1], (None,) * leaf.ndim)
        return spec_for(axes, tuple(leaf.shape))

    return _tensor_specs(one, batch)


def prequant_param_specs(cfg: ModelConfig, rc: RunConfig, params_q) -> dict:
    """{path: spec} of a prequantized tree (``quant.surgery.apply_surgery``):
    ``qkernel`` takes its kernel's axes (packing shrinks K in place);
    ``qscale`` keeps the leading stack axes and the output axis (it drops
    K); every other leaf its own parameter's."""
    axes_by_path = _axes_by_path(cfg)

    def kernel_axes(base: str):
        # a nested linear leaf (.../wq/kernel) or a raw expert stack whose
        # spec sits at the key itself (.../experts/w_gate)
        axes = axes_by_path.get(base + "/kernel")
        return axes if axes is not None else axes_by_path.get(base)

    def one(path, leaf):
        if path.endswith("/qkernel"):
            kaxes = kernel_axes(path[: -len("/qkernel")])
            axes = kaxes if kaxes is not None else (None,) * leaf.ndim
        elif path.endswith("/qscale"):
            kaxes = kernel_axes(path[: -len("/qscale")])
            axes = (kaxes[:-2] + (kaxes[-1],)) if kaxes is not None else (None,) * leaf.ndim
        else:
            axes = axes_by_path.get(path, (None,) * leaf.ndim)
        return spec_for(axes, tuple(leaf.shape))

    return _tensor_specs(one, params_q)


# ------------------------------------------------------------------- cutting
def _flat(entry) -> tuple:
    return () if entry is None else entry if isinstance(entry, tuple) else (entry,)


def _count(entry, mesh: MeshShape) -> int:
    """The number of parts a dim whose spec entry is ``entry`` is cut into."""
    return math.prod(mesh.shape[ax] for ax in _flat(entry))


def _index(entry, mesh: MeshShape, coords: dict) -> int:
    """The rank at ``coords``'s part along a dim whose spec entry is
    ``entry``: a tuple of mesh axes counts row-major (its first axis the
    slowest), as a JAX PartitionSpec does."""
    idx = 0
    for ax in _flat(entry):
        idx = idx * mesh.shape[ax] + coords[ax]
    return idx


def part_slices(spec: tuple, shape: tuple, mesh: MeshShape, coords: dict) -> tuple:
    """The slices of a full leaf of ``shape`` that the rank at ``coords``
    holds."""
    out = []
    for entry, size in zip(spec, shape):
        n = size // _count(entry, mesh)
        i = _index(entry, mesh, coords)
        out.append(slice(i * n, (i + 1) * n))
    return tuple(out) + tuple(slice(None) for _ in shape[len(spec):])


def part_shape(spec: tuple, shape: tuple, mesh: MeshShape) -> tuple:
    """The shape of every rank's part of a leaf of ``shape``."""
    return tuple(size // _count(entry, mesh) for entry, size in zip(spec, shape)) + \
        tuple(shape[len(spec):])


def shard_leaf(spec: tuple, leaf: torch.Tensor, mesh: MeshShape, coords: dict) -> torch.Tensor:
    """The rank's part of one full leaf: a contiguous copy where it is
    cut (never a view holding the whole storage), else the leaf."""
    sl = part_slices(spec, tuple(leaf.shape), mesh, coords)
    if all(s == slice(None) or (s.start == 0 and s.stop == n) for s, n in zip(sl, leaf.shape)):
        return leaf
    return leaf[sl].clone(memory_format=torch.contiguous_format)


def shard_tree(specs: dict, tree, coords: dict, mesh: MeshShape):
    """Rank ``coords``'s part of a full ``tree`` by ``specs`` ({path:
    spec}); a leaf without a spec (a ``QBits`` marker) is kept as is."""
    return tree_map_with_path(
        lambda n, leaf: shard_leaf(specs[n], leaf, mesh, coords) if n in specs else leaf, tree)


def gather_tree(specs: dict, parts: list, mesh: MeshShape):
    """The full tree from ``parts[r]``, rank r's part (every rank's, in
    rank order), by ``specs``."""
    flat = [dict(leaves_with_paths(p)) for p in parts]

    def one(name, leaf):
        if name not in specs:
            return leaf
        spec = specs[name]
        shape = tuple(n * _count(e, mesh) for e, n in zip(spec, leaf.shape)) + \
            tuple(leaf.shape[len(spec):])
        full = torch.empty(shape, dtype=leaf.dtype, device=leaf.device)
        for r, fl in enumerate(flat):
            full[part_slices(spec, shape, mesh, mesh.coords(r))] = fl[name].to(leaf.device)
        return full

    return tree_map_with_path(one, parts[0])
