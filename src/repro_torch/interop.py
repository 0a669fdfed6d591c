"""Carry reference (JAX) trees across to the port through numpy.

The caller converts the reference's pytree leaves to numpy arrays
(``jax.tree.map(np.asarray, tree)``); these functions turn a nested
dict/tuple/list of numpy arrays into the same tree of torch tensors.
bfloat16 leaves (numpy dtype name ``"bfloat16"``, which ``torch.from_numpy``
rejects) are reinterpreted as int16 and viewed back as ``torch.bfloat16``
without importing the extension dtype package that defines them.

A surgered reference tree (``repro.quant.surgery.apply_surgery``) carries a
``QBits`` marker in every packed leaf; it reaches these functions as a
non-array object with an int ``bits`` and becomes the port's
:class:`~repro_torch.quant.qlinear.QBits` (the reference class is never
imported). :func:`flat_leaves` flattens either package's tree to
{dotted path: raw numpy bytes | QBits}, so two trees compare byte for byte.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.quant.qlinear import QBits

__all__ = ["tensor_from_numpy", "params_from_reference", "caches_from_reference", "to_numpy",
           "flat_leaves"]


def _as_qbits(node) -> QBits | None:
    """The port's QBits for a bitwidth marker of either package, else None."""
    if isinstance(node, (np.ndarray, np.generic, torch.Tensor)):
        return None
    bits = getattr(node, "bits", None)
    return QBits(bits) if isinstance(bits, int) else None


def tensor_from_numpy(arr, device=None) -> torch.Tensor:
    """One numpy array -> a tensor on ``device`` (``cuda`` unless the caller
    passes ``"cpu"``)."""
    device = resolve_device(device)
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(arr, copy=True, order="C").view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True, order="C"))
    return t.to(device)


def _tree(node, device):
    if isinstance(node, dict):
        return {k: _tree(v, device) for k, v in node.items()}
    if isinstance(node, (tuple, list)):
        return type(node)(_tree(v, device) for v in node)
    if node is None:
        return None
    qb = _as_qbits(node)
    if qb is not None:
        return qb
    return tensor_from_numpy(node, device)


def params_from_reference(tree, device=None):
    """Reference parameter tree (numpy leaves) -> the port's tree of
    tensors, same layout (``embed``, stacked ``groups``, ``final_norm``)."""
    return _tree(tree, resolve_device(device))


def caches_from_reference(tree, device=None):
    """Reference KV-cache tree (numpy leaves, paged pools stacked per group)
    -> the port's cache tree."""
    return _tree(tree, resolve_device(device))


def to_numpy(tree):
    """The port's tree of tensors -> numpy copies (bf16 widened to f32); a
    copy, because the port updates its caches in place."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_numpy(v) for v in tree)
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def _raw(arr) -> np.ndarray:
    """A leaf's bytes as numpy: bf16 (numpy extension dtype or torch) as
    its int16 bit pattern, everything else as it is."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().copy()
    arr = np.asarray(arr)
    return arr.view(np.int16) if arr.dtype.name == "bfloat16" else arr


def flat_leaves(tree, prefix: str = "") -> dict:
    """{dotted path: leaf} of a port tree (tensors) or a reference tree
    (numpy leaves): arrays as raw numpy bytes, bitwidth markers as the
    port's QBits — what a byte-for-byte comparison of two trees needs."""
    out: dict = {}
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree) if isinstance(tree, (tuple, list)) else None)
    if items is None:
        qb = _as_qbits(tree)
        out[prefix] = qb if qb is not None else _raw(tree)
        return out
    for k, v in items:
        out.update(flat_leaves(v, f"{prefix}.{k}" if prefix else str(k)))
    return out
