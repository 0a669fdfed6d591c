"""Legacy dense-slot serving engine: one-shot B=1 prefill + lock-step decode
(the reference's ``repro/serve/engine.py``).

The baseline the block-managed ``Scheduler`` was refactored out of, and the
serving path of SSM and hybrid stacks, whose mixer state cannot resume a
chunked prefill. Its two step builders:

- ``build_prefill(cfg, rc)``: (params, caches, batch) -> (caches, last_logits)
- ``build_decode(cfg, rc)``:  (params, caches, tokens, pos) -> (caches, logits)

Where the reference jits them with the cache pool donated, the port runs
them eagerly: KV caches are written in place, the SSM state comes back as
new leaves. Admission runs the whole prompt as a separate B=1 prefill into
fresh caches and copies them into the slot's row of the pool; all slots
share one decode position, so a request admitted with a shorter prompt
than the position decodes past a gap of zero K/V rows (ROADMAP C). The
dense pool reserves ``max_batch × capacity`` tokens whatever the load.

With ``track_energy=True`` the steps run under a stats capture and the
engine keeps per-slot :class:`SlotMeter`\\ s: prefill cycles charged exactly
(B=1), each decode step's split evenly over the active slots
(``add_decode_share``: every active row decodes one token). Greedy sampling
is the reference's argmax; at temperature > 0 each token is drawn from the
request's own Philox stream at its sequence position (``sample``), so the
bits differ from the reference's (ROADMAP C7).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import resolve_device
from ..configs.base import ModelConfig, RunConfig
from ..models import forward, init_caches, input_batch, lm_logits
from ..quant import capture as stats_capture
from ..quant.capture import tree_totals_by_bits
from .scheduler import Request, SlotMeter, sample, upload

__all__ = ["build_prefill", "build_decode", "sample", "Engine", "Request", "SlotMeter"]


def build_prefill(cfg: ModelConfig, rc: RunConfig, *, with_stats: bool = False,
                  impl: str = "auto"):
    """(params, caches, {"tokens": (B, S)}) -> (caches, last-column logits
    (B, V)[, capture]): the prompt written from position 0; an M-RoPE
    config's batch gains (3, B, S) positions t = h = w = 0..S-1, as the
    reference's ``Engine._admit`` gives it."""

    @torch.no_grad()
    def prefill(params, caches, batch):
        if cfg.mrope_sections is not None and "positions" not in batch:
            batch = input_batch(cfg, batch["tokens"])
        h, caches, _ = forward(cfg, rc, params, batch, caches=caches, cache_pos=0, impl=impl)
        return caches, lm_logits(cfg, rc, params, h[:, -1:, :], impl=impl)[:, 0, :]

    if not with_stats:
        return prefill

    def prefill_stats(params, caches, batch):
        with stats_capture.capture_stats() as cap:
            caches, logits = prefill(params, caches, batch)
        return caches, logits, cap

    return prefill_stats


def build_decode(cfg: ModelConfig, rc: RunConfig, *, with_stats: bool = False,
                 impl: str = "auto"):
    """(params, caches, tokens (B, 1), pos: int) -> (caches, logits (B, V)
    [, capture]): every row writes at the shared position ``pos`` (an
    M-RoPE config's positions t = h = w = ``pos``)."""

    @torch.no_grad()
    def decode(params, caches, tokens, pos):
        h, caches, _ = forward(cfg, rc, params, input_batch(cfg, tokens, pos), caches=caches,
                               cache_pos=pos, impl=impl)
        return caches, lm_logits(cfg, rc, params, h, impl=impl)[:, 0, :]

    if not with_stats:
        return decode

    def decode_stats(params, caches, tokens, pos):
        with stats_capture.capture_stats() as cap:
            caches, logits = decode(params, caches, tokens, pos)
        return caches, logits, cap

    return decode_stats


def _insert_rows(pool, rows, idx: int) -> None:
    """Copy one request's cache tree (batch 1) into slot ``idx`` of the
    pool, leaf by leaf, in place (leaves are (layers, batch, ...)). A leaf
    shorter than the pool's along a later axis (a prompt shorter than
    ``ssm_conv - 1`` gives such a ``conv`` state) fills the leading part of
    it and leaves the rest as it was, as ``dynamic_update_slice`` does."""
    if isinstance(pool, dict):
        for k in pool:
            _insert_rows(pool[k], rows[k], idx)
    elif isinstance(pool, (tuple, list)):
        for p, r in zip(pool, rows):
            _insert_rows(p, r, idx)
    else:
        at = (slice(None), slice(idx, idx + 1)) + tuple(slice(0, n) for n in rows.shape[2:])
        pool[at] = rows.to(pool.dtype)


class Engine:
    """Synchronous continuous-batching engine over a fixed dense slot pool.

    All slots share a decode position counter (the pool advances in lock
    step); slots admit new requests as soon as they free up. ``params``
    must live on ``device`` (default ``cuda``); ``impl`` selects every
    kernel's path (``kernels/ops.py``)."""

    def __init__(self, cfg: ModelConfig, rc: RunConfig, params: dict, *, capacity: int,
                 max_batch: int, temperature: float = 0.0, seed: int = 0,
                 track_energy: bool = False, device=None, impl: str = "auto"):
        if rc.kv_layout != "dense":
            raise ValueError(
                "the legacy Engine only speaks the dense slot layout; "
                "use serve.Scheduler for rc.kv_layout='paged'")
        if getattr(rc, "spec_gamma", 0):
            raise ValueError(
                "speculative decoding (rc.spec_gamma) needs the mixed-step "
                "Scheduler's draft/verify tick planning; the legacy Engine "
                "would silently ignore it")
        self.cfg, self.rc, self.params = cfg, rc, params
        self.capacity, self.max_batch = capacity, max_batch
        self.temperature, self.seed = temperature, seed
        self.track_energy = track_energy
        self.device = resolve_device(device)
        self._prefill = build_prefill(cfg, rc, with_stats=track_energy, impl=impl)
        self._decode = build_decode(cfg, rc, with_stats=track_energy, impl=impl)
        self.caches = init_caches(cfg, rc, max_batch, capacity, device=self.device)
        self.prefill_seconds: list[float] = []   # wall time of each admission's prefill
        self.step_seconds: list[float] = []      # wall time of each decode step
        self.reset()

    def reset(self) -> None:
        """Return the engine to an empty pool without rebuilding it. The
        shared position restarts at 0; stale cache rows are harmless because
        every read is length-masked at the live kv_len."""
        self.slots: list[Request | None] = [None] * self.max_batch
        self.meters: list[SlotMeter | None] = [None] * self.max_batch
        self.finished_meters: list[SlotMeter] = []
        self.finished_requests: list[Request] = []
        self.pos = 0                                 # shared decode position
        self.queue: list[Request] = []
        self.last_tokens = np.zeros((self.max_batch, 1), np.int32)

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _finish(self, i: int, req: Request) -> None:
        req.done = True
        self.finished_requests.append(req)
        if self.track_energy and self.meters[i] is not None:
            self.finished_meters.append(self.meters[i])

    def _admit(self) -> None:
        for i, slot in enumerate(self.slots):
            if not ((slot is None or slot.done) and self.queue):
                continue
            req = self.queue.pop(0)
            S = len(req.prompt)
            toks = upload(np.asarray(req.prompt, np.int64)[None, :], self.device)
            fresh = init_caches(self.cfg, self.rc, 1, self.capacity, device=self.device)
            t0 = time.perf_counter()
            out = self._prefill(self.params, fresh, {"tokens": toks})
            logits = out[1].to(torch.float32).cpu().numpy()
            self.prefill_seconds.append(time.perf_counter() - t0)
            if self.track_energy:
                meter = SlotMeter(rid=req.rid, prompt_tokens=S)
                meter.add_prefill(tree_totals_by_bits(out[2]))
                self.meters[i] = meter
            tok = int(sample(logits, self.temperature, seed=self.seed, rids=[req.rid],
                             positions=[S])[0])
            req.out.append(tok)
            if self.track_energy:
                self.meters[i].emitted_tokens += 1
            _insert_rows(self.caches, out[0], i)
            self.slots[i] = req
            self.last_tokens[i, 0] = tok
            # decode continues from the longest prompt in the pool
            self.pos = max(self.pos, S)
            if len(req.out) >= req.max_new:
                # the prefill-sampled token already satisfied max_new: finish
                # before any decode step charges it a share
                self._finish(i, req)

    def step(self) -> bool:
        """One synchronous decode step for every active slot."""
        self._admit()
        active = [i for i, s in enumerate(self.slots) if s is not None and not s.done]
        if not active:
            return False
        t0 = time.perf_counter()
        out = self._decode(self.params, self.caches, upload(self.last_tokens, self.device),
                           self.pos)
        self.caches = out[0]
        logits = out[1].to(torch.float32).cpu().numpy()   # the step's one sync
        self.step_seconds.append(time.perf_counter() - t0)
        step_by_bits = tree_totals_by_bits(out[2]) if self.track_energy else {}
        rids = [s.rid if s is not None else 0 for s in self.slots]
        positions = [len(s.prompt) + len(s.out) if s is not None else self.pos
                     for s in self.slots]
        self.pos += 1
        toks = sample(logits, self.temperature, seed=self.seed, rids=rids, positions=positions)
        self.last_tokens = toks[:, None].astype(np.int32)
        for i in active:
            req = self.slots[i]
            req.out.append(int(toks[i]))
            if self.track_energy and self.meters[i] is not None:
                m = self.meters[i]
                m.decode_tokens += 1
                m.emitted_tokens += 1
                # the pool-wide step's cycles split evenly over the active
                # slots (the GEMM's M axis is the whole pool)
                m.add_decode_share(step_by_bits, len(active))
            if len(req.out) >= req.max_new or self.pos >= self.capacity - 1:
                self._finish(i, req)
        return True

    def run(self, max_steps: int = 10_000) -> list[Request]:
        """Step until the queue and the slots drain; returns every finished
        request, then any still in flight."""
        steps = 0
        while (self.queue or any(s and not s.done for s in self.slots)) and steps < max_steps:
            if not self.step() and not self.queue:
                break
            steps += 1
        live = [s for s in self.slots if s is not None and not s.done]
        return self.finished_requests + live

    def energy_summary(self, variant: str = "serial") -> list[dict]:
        """Per-request {rid, tokens, cycles, cycles_by_bits, latency_s,
        energy_j} on the paper's 16×16 unit, finished requests first, then
        in-flight slots. Requires ``track_energy=True``."""
        active = [m for i, m in enumerate(self.meters)
                  if m is not None and self.slots[i] is not None and not self.slots[i].done]
        return [m.energy(variant) for m in self.finished_meters + active]
