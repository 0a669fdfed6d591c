"""Token-budget scheduler: chunked prefill + decode packed into one mixed
step per tick over a paged KV pool (the reference's
``repro/serve/scheduler.py`` main path).

Each tick packs decode rows first (one token each), then FIFO prompt chunks
of up to ``rc.prefill_chunk`` tokens, into one step of shape
``(max_batch, prefill_chunk)`` — width 1 when only decode rows run. The
step carries a :class:`~repro_torch.models.KVView` (per-row write
position, live width and block table); idle and padded columns write to the
trash page and their outputs are never read. Under pool pressure the
youngest slot is recompute-preempted: its pages are released and it is
requeued at the front, its generated tokens joining its prompt.

Pool pressure also drives the degradation ladder (``serve/admission.py``):
a preemption lifts it to ``preempt``, a stalled row one level per tick (up
to ``preempt``), and from ``shrink_chunk`` up the prefill share of a tick's
token budget halves per level; ``rc.ladder_relax_ticks`` clean ticks relax
it one level. Every tick advances a logical ``clock``, the ladder's time.

Cycle attribution (``track_energy=True``): a tick's tuGEMM cycles are split
across scheduled rows by active-token weight ``lens[b] / sum(lens)``, and
each tick's MoE capacity drops (the capture's ``moe.dropped_tokens``) are
kept in ``tick_dropped_tokens``. ``health()`` reports
``moe_dropped_tokens``, which counts drops on the expert-parallel mesh path
only and stays 0 on one device, as the reference's does.

This slice has plain FIFO admission. Admission classes, shedding, fault
injection, speculative decoding, prefix caching, tracing and the dense
layout are later slices; the knobs that select them raise
``NotImplementedError``.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import resolve_device
from ..configs.base import ModelConfig, RunConfig
from ..core.report import slot_energy
from ..models import KVView, forward, init_caches, lm_logits
from ..models.transformer import check_supported
from ..quant import capture as stats_capture
from ..quant.capture import scalar_totals, tree_totals_by_bits
from .admission import DegradationLadder
from .cache import BlockManager, num_pages_for

__all__ = ["Request", "SlotMeter", "Scheduler", "build_mixed_step", "sample",
           "STREAM_SAMPLE"]

STREAM_SAMPLE = 0    # the canonical next-token draw at a position


def sample(logits: np.ndarray, temperature: float = 0.0, *, seed: int = 0,
           rids=None, positions=None, stream: int = STREAM_SAMPLE) -> np.ndarray:
    """Greedy argmax at temperature <= 0. Otherwise a Gumbel-max draw per
    row from a counter-based Philox stream keyed by (seed, rid) at counter
    (position, stream): a request's draws depend only on (seed, rid,
    position, stream), never on how ticks were packed, so temperature > 0
    runs are reproducible and schedule-invariant (the reference keys
    ``jax.random.fold_in`` the same way; the bits themselves differ)."""
    if temperature <= 0.0:
        return np.argmax(logits, axis=-1).astype(np.int32)
    out = np.empty(logits.shape[0], np.int32)
    for b in range(logits.shape[0]):
        bitgen = np.random.Philox(
            key=np.array([seed, rids[b]], np.uint64),
            counter=np.array([positions[b], stream, 0, 0], np.uint64))
        g = np.random.Generator(bitgen).gumbel(size=logits.shape[-1])
        out[b] = np.argmax(logits[b].astype(np.float64) / temperature + g)
    return out


@dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int = 32
    out: list[int] = field(default_factory=list)
    done: bool = False


@dataclass
class SlotMeter:
    """Per-request tuGEMM accounting across prefill + decode, bucketed per
    bitwidth (mixed policies run int8 and int2 cycles at different clocks
    and Table-I power points). Shared-step cycles accumulate as floats (a
    step's total times this slot's active-token weight); rounding happens
    once at read."""

    rid: int
    prompt_tokens: int = 0
    decode_tokens: int = 0
    emitted_tokens: int = 0
    decode_by_bits: dict = field(default_factory=dict)    # bits -> {variant: float}

    def add_share(self, by_bits: dict, weight: float) -> None:
        for b, tot in by_bits.items():
            d = self.decode_by_bits.setdefault(b, {"serial": 0.0, "parallel": 0.0})
            d["serial"] += tot["serial_cycles"] * weight
            d["parallel"] += tot["parallel_cycles"] * weight

    def cycles_by_bits(self, variant: str = "serial") -> dict[int, int]:
        return {b: int(round(d[variant])) for b, d in self.decode_by_bits.items()}

    def energy(self, variant: str = "serial") -> dict:
        """Latency/energy of this request's GEMM work on the paper's 16×16
        unit, each bitwidth at its own clock and power."""
        by = self.cycles_by_bits(variant)
        lat = e_j = 0.0
        for b, cyc in by.items():
            l, e = slot_energy(b, variant, cyc)
            lat += l
            e_j += e
        return {
            "rid": self.rid,
            "tokens": self.prompt_tokens + self.decode_tokens,
            "generated_tokens": self.emitted_tokens,
            "cycles": sum(by.values()),
            "cycles_by_bits": by,
            "latency_s": lat,
            "energy_j": e_j,
        }


# ------------------------------------------------------------------- step fn
def build_mixed_step(cfg: ModelConfig, rc: RunConfig, *, with_stats: bool = False,
                     impl: str = "auto"):
    """One tick: (params, caches, tokens (B,W), pos (B,), lens (B,), tables)
    -> (caches, logits (B, V)[, capture]). Row b's logits come from hidden
    column lens[b]-1. Caches are updated in place. ``impl`` selects every
    kernel's path (``kernels/ops.py``)."""

    @torch.no_grad()
    def step(params, caches, tokens, pos, lens, tables):
        view = KVView(pos=pos, lens=lens, tables=tables, block_size=rc.block_size,
                      layout=rc.kv_layout)
        h, caches, _ = forward(cfg, rc, params, {"tokens": tokens}, caches=caches,
                               cache_pos=pos, kv_view=view, impl=impl)
        idx = torch.clamp(lens.long() - 1, 0, tokens.shape[1] - 1)
        h_last = h[torch.arange(h.shape[0], device=h.device), idx][:, None]
        return caches, lm_logits(cfg, rc, params, h_last, impl=impl)[:, 0, :]

    if not with_stats:
        return step

    def step_stats(params, caches, tokens, pos, lens, tables):
        with stats_capture.capture_stats() as cap:
            caches, logits = step(params, caches, tokens, pos, lens, tables)
        return caches, logits, cap

    return step_stats


# ----------------------------------------------------------------- scheduler
@dataclass
class _Slot:
    req: Request
    prompt: list[int]            # original prompt + tokens generated before a preemption
    admit_seq: int = 0           # admission order (preemption picks youngest)
    pos: int = 0                 # tokens already written to this row's cache
    last_token: int = 0          # next decode input (last sampled token)
    meter: SlotMeter | None = None

    @property
    def prefilling(self) -> bool:
        return self.pos < len(self.prompt)


class Scheduler:
    """Block-managed, continuously batched serving engine.

    One mixed step of shape ``(max_batch, prefill_chunk)`` serves prefill
    and decode alike; each tick fills rows under a token budget with decode
    rows first, then FIFO prompt chunks. ``params`` must live on ``device``
    (default ``cuda``); the paged pools are allocated there.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        rc: RunConfig,
        params: dict,
        *,
        capacity: int,
        max_batch: int,
        num_pages: int | None = None,
        temperature: float = 0.0,
        seed: int = 0,
        track_energy: bool = False,
        device=None,
        impl: str = "auto",
    ):
        check_supported(cfg, rc)
        if getattr(rc, "spec_gamma", 0) > 0:
            raise NotImplementedError("speculative decoding is not ported yet (spec_gamma>0)")
        if getattr(rc, "prefix_cache", False):
            raise NotImplementedError("prefix caching is not ported yet (prefix_cache=True)")
        self.device = resolve_device(device)
        self.cfg, self.rc, self.params = cfg, rc, params
        self.capacity, self.max_batch = capacity, max_batch
        self.chunk = max(rc.prefill_chunk, 1)
        self.token_budget = rc.token_budget or max_batch * self.chunk
        self.temperature = temperature
        self.seed = seed
        self.track_energy = track_energy
        pages = num_pages if num_pages is not None else num_pages_for(
            capacity, rc.block_size, max_batch)
        self.mgr = BlockManager(pages, rc.block_size, max_batch, capacity)
        self.caches = init_caches(cfg, rc, max_batch, capacity, num_pages=pages,
                                  device=self.device)
        self._step = build_mixed_step(cfg, rc, with_stats=track_energy, impl=impl)
        self.queue: deque[Request] = deque()
        self.slots: list[_Slot | None] = [None] * max_batch
        self.finished: list[Request] = []
        self.finished_meters: list[SlotMeter] = []
        self.final_kv_lens: dict[int, int] = {}     # rid -> live KV at finish
        self.cycles_by_bits: dict = {}              # bits -> exact int cycle totals
        self.moe_dropped_tokens = 0                 # expert-parallel drops (0 on one device)
        self.tick_dropped_tokens: list[int] = []    # capture's MoE drops a tick (track_energy)
        self.tick_seconds: list[float] = []         # wall time of every step tick
        self.generated_tokens = 0
        self.ticks = 0
        self.clock = 0                   # logical time: every tick, run or idle
        self.preemptions = 0
        self.ladder = DegradationLadder(relax_after=rc.ladder_relax_ticks)
        self._admit_counter = 0
        self._meters_by_rid: dict[int, SlotMeter] = {}
        self._tables_dev = None          # device copy of mgr.tables ...
        self._tables_version = -1        # ... keyed on mgr.version
        self._rr = 0                     # rotating plan start (fairness)

    # ---------------------------------------------------------------- admin
    def submit(self, req: Request) -> None:
        if len(req.prompt) > self.capacity - 1:
            raise ValueError(
                f"request {req.rid}: prompt of {len(req.prompt)} tokens "
                f"exceeds capacity {self.capacity} - 1")
        self.queue.append(req)

    def _admit(self) -> None:
        for i, sl in enumerate(self.slots):
            if sl is not None:
                continue
            if not self.queue:
                break
            req = self.queue.popleft()
            meter = None
            if self.track_energy:
                # a preempted request resumes its meter: charged cycles stay
                meter = self._meters_by_rid.get(req.rid)
                if meter is None:
                    meter = SlotMeter(rid=req.rid, prompt_tokens=len(req.prompt))
                    self._meters_by_rid[req.rid] = meter
            self.slots[i] = _Slot(req=req, prompt=list(req.prompt) + list(req.out),
                                  admit_seq=self._admit_counter, meter=meter)
            self._admit_counter += 1

    def _finish(self, i: int) -> None:
        sl = self.slots[i]
        sl.req.done = True
        self.finished.append(sl.req)
        self.final_kv_lens[sl.req.rid] = sl.pos
        if sl.meter is not None:
            self.finished_meters.append(sl.meter)
            self._meters_by_rid.pop(sl.req.rid, None)
        self.mgr.release(i)
        self.slots[i] = None

    def _preempt_one(self) -> bool:
        """Recompute-preemption under pool pressure: release the youngest
        slot's pages and requeue it first; its effective prompt (original +
        generated) is re-prefilled on readmission. Never preempts the last
        active slot (it must be able to drain)."""
        cand = [i for i, s in enumerate(self.slots) if s is not None]
        if len(cand) <= 1:
            return False
        i = max(cand, key=lambda j: self.slots[j].admit_seq)
        self.mgr.release(i)
        self.queue.appendleft(self.slots[i].req)
        self.slots[i] = None
        self.preemptions += 1
        self.ladder.escalate_to(self.clock, 3, "preemption")
        return True

    def _note_stall(self) -> None:
        """Rows whose page allocation failed this tick escalate the ladder
        (allocation stalls stop at ``preempt``)."""
        self.ladder.note_pressure(self.clock, "alloc_stall", ceil=3)

    # ----------------------------------------------------------------- tick
    def _plan(self):
        """Fill one tick's rows under the token budget: decode rows first,
        then prompt chunks FIFO, in a per-tick rotated slot order. Rows
        whose page allocation fails sit this tick out (counted as
        ``stalled``). From ladder level 2 the prefill share of the budget
        shrinks; decode rows, which release pages soonest, keep priority."""
        rows, W = self.max_batch, self.chunk
        tokens = np.zeros((rows, W), np.int32)
        pos = np.zeros(rows, np.int32)
        lens = np.zeros(rows, np.int32)
        budget = self.token_budget
        stalled = 0
        decode_rows: list[int] = []
        prefill_rows: list[int] = []
        order = [(self._rr + k) % rows for k in range(rows)]
        for i in order:
            sl = self.slots[i]
            if sl is None:
                continue
            pos[i] = sl.pos
            if not sl.prefilling and budget > 0:
                if not self.mgr.extend(i, sl.pos + 1):
                    stalled += 1  # pool exhausted — row stalls this tick
                    continue
                tokens[i, 0] = sl.last_token
                lens[i] = 1
                budget -= 1
                decode_rows.append(i)
        pbudget = min(budget, self.ladder.prefill_budget(self.token_budget, W))
        for i in order:
            sl = self.slots[i]
            if sl is None or lens[i] or not sl.prefilling or pbudget <= 0:
                continue
            n = min(W, len(sl.prompt) - sl.pos, pbudget)
            if not self.mgr.extend(i, sl.pos + n):
                stalled += 1
                continue
            tokens[i, :n] = sl.prompt[sl.pos : sl.pos + n]
            lens[i] = n
            pbudget -= n
            prefill_rows.append(i)
        return tokens, pos, lens, decode_rows, prefill_rows, stalled

    def _tables(self) -> torch.Tensor:
        """Device copy of the block tables, re-uploaded only when the host
        manager mutated since the last tick."""
        if self._tables_version != self.mgr.version:
            self._tables_dev = torch.from_numpy(self.mgr.tables.copy()).to(self.device)
            self._tables_version = self.mgr.version
        return self._tables_dev

    def _emit(self, i: int, token: int) -> None:
        """Append a sampled token. A request's first token rides its prefill;
        any later one counts as a decode token."""
        sl = self.slots[i]
        continuing = bool(sl.req.out)
        sl.req.out.append(token)
        sl.last_token = token
        self.generated_tokens += 1
        if sl.meter is not None:
            sl.meter.emitted_tokens += 1
            if continuing:
                sl.meter.decode_tokens += 1

    def _end_tick(self, ran: bool) -> bool:
        """Per-tick ladder bookkeeping: relax toward healthy on a clean tick
        (the ladder ignores it if pressure was noted at this clock)."""
        self.ladder.note_clean(self.clock)
        self.ladder.tick()
        return ran

    def tick(self) -> bool:
        """Plan + run one mixed step. Returns False when nothing ran."""
        self.clock += 1
        self._admit()
        tokens, pos, lens, decode_rows, prefill_rows, stalled = self._plan()
        if stalled:
            self._note_stall()
        # pool pressure: nothing schedulable while slots are active means
        # every row's page allocation failed — preempt until one can proceed
        while not (decode_rows or prefill_rows) and self._preempt_one():
            tokens, pos, lens, decode_rows, prefill_rows, stalled = self._plan()
            if stalled:
                self._note_stall()
        scheduled = decode_rows + prefill_rows
        if not scheduled:
            if any(s is not None for s in self.slots):
                raise RuntimeError(
                    f"page pool cannot back a single active sequence "
                    f"({self.mgr.num_pages} pages of {self.rc.block_size} tokens)")
            return self._end_tick(False)
        t0 = time.perf_counter()
        # decode-only ticks run at width 1 instead of the full chunk width
        width = self.chunk if prefill_rows else 1
        dev = self.device
        out = self._step(
            self.params, self.caches,
            torch.from_numpy(tokens[:, :width].copy()).to(dev),
            torch.from_numpy(pos).to(dev), torch.from_numpy(lens).to(dev),
            self._tables(),
        )
        step_by_bits: dict = {}
        if self.track_energy:
            self.caches, logits, cap = out
            step_by_bits = tree_totals_by_bits(cap)
            if cap.scalars:
                self.tick_dropped_tokens.append(
                    scalar_totals(cap).get("moe.dropped_tokens", 0))
        else:
            self.caches, logits = out
        for b, d in step_by_bits.items():
            acc = self.cycles_by_bits.setdefault(b, {"serial_cycles": 0, "parallel_cycles": 0})
            for k, v in d.items():
                acc[k] += int(v)
        logits_np = logits.to(torch.float32).cpu().numpy()
        self.tick_seconds.append(time.perf_counter() - t0)
        self.ticks += 1

        rids = [sl.req.rid if (sl := self.slots[i]) is not None else 0
                for i in range(self.max_batch)]
        toks = sample(logits_np, self.temperature, seed=self.seed, rids=rids,
                      positions=[int(pos[i]) + int(lens[i]) for i in range(self.max_batch)])
        total = float(sum(int(lens[i]) for i in scheduled)) or 1.0
        for i in scheduled:
            sl = self.slots[i]
            if self.track_energy and sl.meter is not None:
                sl.meter.add_share(step_by_bits, int(lens[i]) / total)
            was_decoding = not sl.prefilling
            sl.pos += int(lens[i])
            if was_decoding or not sl.prefilling:
                # decode rows and just-completed prefills both sampled a token
                self._emit(i, int(toks[i]))
                if len(sl.req.out) >= sl.req.max_new or sl.pos >= self.capacity - 1:
                    self._finish(i)
        self._rr = (self._rr + 1) % self.max_batch
        return self._end_tick(True)

    def run(self, max_ticks: int = 100_000) -> list[Request]:
        """Drain the queue and all active slots; returns finished requests."""
        for _ in range(max_ticks):
            if not self.queue and not any(s is not None for s in self.slots):
                break
            if not self.tick() and not self.queue:
                break
        return self.finished

    def health(self) -> dict:
        """Host-side snapshot: ladder state, slot and queue occupancy, the
        counters of this engine, and ``moe_dropped_tokens`` (router
        capacity drops on the mesh path; 0 on one device)."""
        return {
            "clock": self.clock,
            "ticks": self.ticks,
            "ladder": self.ladder.snapshot(),
            "active_slots": sum(1 for s in self.slots if s is not None),
            "max_batch": self.max_batch,
            "queued": len(self.queue),
            "completed": len(self.finished),
            "preemptions": self.preemptions,
            "pages_in_use": self.mgr.pages_in_use,
            "moe_dropped_tokens": self.moe_dropped_tokens,
        }

    def energy_summary(self, variant: str = "serial") -> list[dict]:
        """Per-request {rid, tokens, cycles, cycles_by_bits, latency_s,
        energy_j} — finished requests first, then in-flight slots.
        Requires ``track_energy=True``."""
        active = [s.meter for s in self.slots if s is not None and s.meter is not None]
        return [m.energy(variant) for m in self.finished_meters + active]
