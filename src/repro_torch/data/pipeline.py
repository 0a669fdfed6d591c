"""Synthetic data pipeline: deterministic, host-sharded, prefetching (the
reference's ``repro/data/pipeline.py``).

No datasets ship offline, so the pipeline generates structured synthetic
streams (Zipf-ish marginals + short-range Markov structure, so an LM has
something to learn and its loss falls). ``SyntheticLM`` and
``FastSynthetic`` are the reference's numpy generators, so both packages
draw the same tokens for a seed and step. Each process builds its slice of
the global batch (``host_slice``: the world of ``torch.distributed`` when
it is initialised, else one process; the ranks of a ``launch/mesh.py`` pool
count as one), and a background thread keeps ``prefetch`` batches of CPU
tensors ahead of the loop. The thread makes no
CUDA call: the trainer moves each batch to the card itself.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeConfig

__all__ = ["SyntheticLM", "FastSynthetic", "host_slice", "Prefetcher", "make_batches"]


class SyntheticLM:
    """Markov-chain token stream: ~``order``-gram structure over the vocab.

    A fixed random transition table over ``num_states`` latent states emits
    Zipf-distributed tokens; an LM that learns the transitions reaches a loss
    well below the unigram entropy."""

    def __init__(self, vocab_size: int, seed: int = 0, num_states: int = 64):
        self.vocab = vocab_size
        rng = np.random.default_rng(seed)
        self.ns = num_states
        trans = rng.dirichlet(np.full(num_states, 0.2), size=num_states)
        self.trans = trans.astype(np.float32)
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        zipf = 1.0 / ranks
        emit = np.stack([rng.permutation(zipf) for _ in range(num_states)])
        self.emit = (emit / emit.sum(1, keepdims=True)).astype(np.float64)

    def batch(self, batch: int, seq: int, step: int) -> dict:
        rng = np.random.default_rng(hash((step, 0x7A3)) % (2**31))
        states = rng.integers(0, self.ns, size=batch)
        toks = np.empty((batch, seq + 1), np.int32)
        for t in range(seq + 1):
            for b in range(batch):
                toks[b, t] = rng.choice(self.vocab, p=self.emit[states[b]])
            states = np.array(
                [rng.choice(self.ns, p=self.trans[s]) for s in states]
            )
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class FastSynthetic:
    """Vectorized variant for big batches (numpy, no per-token loop):
    tokens are ``(state_embedding + noise) mod vocab`` over a sub-vocabulary
    of at most 4,096 ids, so short runs revisit each embedding row often
    enough for the loss to drop."""

    def __init__(self, vocab_size: int, seed: int = 0):
        self.vocab = vocab_size
        self.vocab_eff = min(vocab_size, 4096)
        self.seed = seed

    def batch(self, batch: int, seq: int, step: int) -> dict:
        rng = np.random.default_rng((self.seed * 9176 + step) % (2**31))
        base = rng.integers(0, self.vocab_eff, size=(batch, 1), dtype=np.int64)
        drift = rng.integers(0, 7, size=(batch, seq + 1), dtype=np.int64).cumsum(1)
        toks = ((base + drift) % self.vocab_eff).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _world() -> tuple[int, int]:
    """(world size, rank) of ``torch.distributed``, or (1, 0). The ranks of
    a rank pool (``launch/mesh.py``) are one host: its controller builds
    the global batch and hands every rank its rows."""
    from ..launch.mesh import in_rank_pool

    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() and not in_rank_pool():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def host_slice(global_batch: int) -> tuple[int, int]:
    """(start, size) of this process's slice of the global batch."""
    n, i = _world()
    per = global_batch // n
    assert per * n == global_batch, (global_batch, n)
    return i * per, per


class Prefetcher:
    """Background-thread prefetch of ``depth`` batches."""

    def __init__(self, make_batch, start_step: int = 0, depth: int = 2):
        self._make = make_batch
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            try:
                self._q.put(self._make(step), timeout=0.1)
                step += 1
            except queue.Full:
                continue

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)


def make_batches(
    cfg: ModelConfig,
    shape: ShapeConfig,
    *,
    seed: int = 0,
    fast: bool = True,
    start_step: int = 0,
    prefetch: int = 2,
):
    """Host-sharded prefetching iterator of batches of CPU tensors for (cfg,
    shape): ``tokens`` and ``labels`` (B, S) int32, or for an audio
    frontend ``embeds`` (B, S, 512) f32 and ``labels``; with M-RoPE also
    ``positions`` (3, B, S) int32 (t = h = w = the column)."""
    start, per_host = host_slice(shape.global_batch)
    world, _ = _world()
    src = (FastSynthetic if fast else SyntheticLM)(cfg.vocab_size, seed)

    def make(step: int) -> dict:
        b = src.batch(per_host, shape.seq_len, step * world + start)
        if cfg.frontend == "audio":
            rng = np.random.default_rng(step)
            return {
                "embeds": torch.from_numpy(
                    rng.standard_normal((per_host, shape.seq_len, 512), np.float32)),
                "labels": torch.from_numpy(b["labels"] % cfg.vocab_size),
            }
        out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}
        if cfg.mrope_sections is not None:
            pos = torch.arange(shape.seq_len, dtype=torch.int32).expand(per_host, shape.seq_len)
            out["positions"] = torch.stack([pos, pos, pos])
        return out

    return Prefetcher(make, start_step=start_step, depth=prefetch)
