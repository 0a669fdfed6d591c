"""Carry reference (JAX) trees across to the port through numpy.

The caller converts the reference's pytree leaves to numpy arrays
(``jax.tree.map(np.asarray, tree)``); these functions turn a nested
dict/tuple/list of numpy arrays into the same tree of torch tensors.
bfloat16 leaves (numpy dtype name ``"bfloat16"``, which ``torch.from_numpy``
rejects) are reinterpreted as int16 and viewed back as ``torch.bfloat16``
without importing the extension dtype package that defines them.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device

__all__ = ["tensor_from_numpy", "params_from_reference", "caches_from_reference", "to_numpy"]


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
