"""Checkpointing in the reference's on-disk layout: one ``.npy`` per leaf
plus a JSON manifest (the reference's ``repro/train/checkpoint.py``).

``step_XXXXXXXX/`` holds a leaf per file, named by its tree path
(``params/groups/0/k0/attn/wq/kernel``; the optimizer state as ``opt/0``
(step), ``opt/1/...`` (master), ``opt/2/...`` (m), ``opt/3/...`` (v), with
``.../q`` and ``.../s`` under int8 moments; ``ef/...``), and the manifest
records only logical metadata (path, shape, dtype, step). A save writes
``step_XXXXXXXX.tmp`` and renames it, so a crash mid-save never corrupts
the latest good checkpoint. A bf16 leaf is stored as its raw 16-bit
pattern with ``"bfloat16"`` in the manifest; a reference checkpoint's bf16
leaves (numpy's extension dtype) load as the same pattern. So the port
restores the reference's checkpoints bit for bit.

``AsyncCheckpointer.save_async`` copies the state to the host before it
returns (the training step updates the state in place), then writes it on
a daemon thread, and keeps the newest ``keep`` checkpoints.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading

import numpy as np
import torch

from ..tree import leaves_with_paths, tree_map

__all__ = ["save", "restore", "latest_step", "AsyncCheckpointer"]

_SAFE = re.compile(r"[^A-Za-z0-9_.-]")


def _leaf_file(name: str) -> str:
    return _SAFE.sub("_", name) + ".npy"


def _host(leaf) -> tuple[np.ndarray, str]:
    """(numpy array to store, manifest dtype) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return arr.view(np.int16), "bfloat16"
    return arr, str(arr.dtype)


def save(ckpt_dir: str, step: int, tree, *, extra: dict | None = None) -> str:
    """Write the checkpoint of ``step``; returns its directory."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}, "extra": extra or {}}
    for name, leaf in leaves_with_paths(tree):
        arr, dtype = _host(leaf)
        fname = _leaf_file(name)
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][name] = {"file": fname, "shape": list(arr.shape), "dtype": dtype}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", d)
        if m and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def _load(path: str, dtype: str) -> torch.Tensor:
    arr = np.asarray(np.load(path), order="C")
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(ckpt_dir: str, step: int, like):
    """Restore into the structure of ``like`` (a state or params tree):
    each leaf takes the template's dtype and device. Returns (tree,
    manifest)."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    names = iter(n for n, _ in leaves_with_paths(like))

    def one(tmpl):
        name = next(names)
        meta = manifest["leaves"][name]
        t = _load(os.path.join(d, meta["file"]), meta["dtype"])
        want = tuple(tmpl.shape)
        assert tuple(t.shape) == want, (name, tuple(t.shape), want)
        return t.to(dtype=tmpl.dtype, device=tmpl.device)

    return tree_map(one, like), manifest


class AsyncCheckpointer:
    """Saves on a background thread (at most one in flight; a second save
    waits for the first)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save_async(self, step: int, tree, *, extra: dict | None = None):
        self.wait()
        # a host copy now: the step updates the state in place
        host = tree_map(lambda t: t.detach().to("cpu", copy=True), tree)

        def work():
            save(self.dir, step, host, extra=extra)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self):
        steps = sorted(
            int(m.group(1))
            for d in os.listdir(self.dir)
            if (m := re.fullmatch(r"step_(\d+)", d))
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)
