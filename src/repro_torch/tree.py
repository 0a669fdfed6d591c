"""Pytree helpers over the port's trees: nested dicts, tuples and lists of
tensors, and dataclass nodes (``optim.AdamWState``) whose children are
their fields in order.

The order and the names are the reference's (``jax.tree_util``): dict keys
in sorted order, sequence and dataclass children by index, and a leaf's
name is its path joined by ``/`` (``params/groups/0/k0/attn/wq/kernel``,
``opt/0`` for a dataclass's first field). ``None`` is an empty subtree.
"""

from __future__ import annotations

import dataclasses

__all__ = ["leaves", "leaves_with_paths", "tree_map", "tree_map_with_path", "unflatten_like"]


def _children(node):
    """[(key, child)] of an inner node, or None for a leaf."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (tuple, list)):
        return list(enumerate(node))
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(i, getattr(node, f.name)) for i, f in enumerate(dataclasses.fields(node))]
    return None


def _rebuild(node, children: list):
    if isinstance(node, dict):
        return dict(zip(sorted(node), children))
    if isinstance(node, (tuple, list)):
        return type(node)(children)
    return type(node)(*children)


def leaves_with_paths(tree, prefix: str = "") -> list:
    """[(name, leaf)] in the reference's flatten order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for k, v in kids:
        out += leaves_with_paths(v, f"{prefix}/{k}" if prefix else str(k))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure, or with a subtree where ``tree``
    has a leaf: that subtree is passed whole, as ``flatten_up_to`` does)."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    others = [_children(r) for r in rest]
    return _rebuild(tree, [tree_map(fn, v, *(o[i][1] for o in others))
                           for i, (_, v) in enumerate(kids)])


def tree_map_with_path(fn, tree, prefix: str = ""):
    """``fn(name, leaf)`` over the leaves of ``tree``, ``name`` as
    :func:`leaves_with_paths` gives it."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    return _rebuild(tree, [tree_map_with_path(fn, v, f"{prefix}/{k}" if prefix else str(k))
                           for k, v in kids])


def unflatten_like(tree, flat: list):
    """A tree of ``tree``'s structure holding ``flat`` (in flatten order)."""
    it = iter(flat)
    out = tree_map(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out
