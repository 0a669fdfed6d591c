"""Speculative decoding: int-low self-drafting + batched verify (the
reference's ``repro/serve/spec.py``; DESIGN.md §9).

Table I's PPA slope is the point of tuGEMM — a 2-bit GEMM unit costs a small
fraction of the 8-bit point — so a *draft* forward pass at int2 is nearly
free in hardware energy. Each decode slot drafts ``rc.spec_gamma``
candidate tokens a tick by running the **same weights** under a second,
low-bit :class:`~repro_torch.quant.policy.QuantPolicy` (``rc.draft_policy``,
default ``*=int2``) against a **draft KV pool**, and the target model then
judges all γ+1 positions of every slot in ONE mixed step built with
``all_logits=True``. Serial decode (one target pass a token) becomes one
target pass per *accepted run* of tokens.

- **Draft weight view** — :func:`repro_torch.quant.surgery.draft_quant_view`
  turns ``rc.draft_policy`` into a standalone RunConfig and, for prequant
  draft rules, packs a second view of the same float params. Dynamic draft
  policies reuse the target's float leaves: the fused kernel quantizes on
  load at the draft width.
- **Draft KV pool** — a second cache tree at the draft policy's numerics,
  backed by the one :class:`~repro_torch.serve.cache.BlockManager`: a page
  id addresses the same row in both pools, so rollback is a single
  ``truncate`` and preemption's ``release`` frees both at once. Prefill
  chunks are mirrored into the draft pool so a slot can draft from its first
  decode tick. Under ``rc.prefix_cache`` rollback and release decrement
  refcounts, and the scheduler applies every copy-on-write page copy to
  BOTH pools before the next write.
- **Acceptance** — greedy exact match at temperature 0 (every emitted token
  is a target argmax, so the output equals non-speculative greedy decode);
  standard speculative rejection sampling otherwise, on the per-request
  (seed, rid, position, stream) draws of ``serve.scheduler``.
- **Energy attribution** — draft-pass cycles land in the SlotMeter's draft
  bucket at the *draft* policy's bitwidths, verify cycles in the target
  bucket; rejected candidates' cycles are never subtracted.

The draft steps run back to back on the card: at temperature 0 each step's
proposals are its logits' argmax on the device, fed to the next step
without a host copy; at temperature > 0 each step's logits come to the host,
where the draws are made. On the card the draft step is a CUDA graph a width
(``serve/graphs.py``): the greedy loop replays its width-1 graph up to γ−1
times a tick, each replay's logits read on the device before the next, and
each replay's cycle totals a copy of their own.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .. import resolve_device
from ..configs.base import ModelConfig, RunConfig
from ..models import init_caches
from .graphs import upload
from .scheduler import (
    STREAM_ACCEPT,
    STREAM_DRAFT,
    STREAM_RESIDUAL,
    STREAM_SAMPLE,
    build_mixed_step,
    categorical,
    sample,
    uniform,
)

__all__ = ["DraftRow", "SpecDecoder", "greedy_accept", "rejection_accept"]


@dataclass
class DraftRow:
    """One decode slot's inputs to a tick's draft phase."""

    row: int                        # step-batch row index
    rid: int                        # request id (draw stream)
    pos: int                        # target live KV length at tick start
    draft_pos: int                  # draft-pool live length at tick start
    gap: list[int] = field(default_factory=list)  # committed tokens the draft
    #                                 has not ingested (seq idx draft_pos..pos-1)
    last_token: int = 0             # sequence token at index pos (not yet in KV)
    g: int = 0                      # candidates to draft this tick (>= 1)


def _softmax(logits: np.ndarray) -> np.ndarray:
    x = logits.astype(np.float64) - float(logits.max())
    e = np.exp(x)
    return e / e.sum()


def greedy_accept(props: list[int], argmax_row: np.ndarray) -> tuple[int, list[int]]:
    """Temperature-0 acceptance: keep the longest prefix of proposals that
    matches the target's per-position argmax, then emit the target's own
    argmax at the first divergence (or the bonus position when everything
    matched). ``argmax_row`` covers positions 0..len(props). Every emitted
    token is a target argmax."""
    n = 0
    for j, d in enumerate(props):
        if int(argmax_row[j]) != int(d):
            break
        n += 1
    return n, [int(t) for t in props[:n]] + [int(argmax_row[n])]


def rejection_accept(seed: int, rid: int, pos0: int, props: list[int],
                     p_logits: np.ndarray, q_logits: np.ndarray,
                     temperature: float) -> tuple[int, list[int]]:
    """Standard speculative rejection sampling (Leviathan et al.) on the
    request's own draw streams.

    ``p_logits`` (g+1, V) are the target's distributions over positions
    pos0+1 .. pos0+g+1; ``q_logits`` (g, V) the draft's over pos0+1 ..
    pos0+g. Candidate j is accepted with probability min(1, p(d)/q(d)) (a
    STREAM_ACCEPT uniform); the first rejection draws from the residual
    ``max(p - q, 0)`` (STREAM_RESIDUAL) and stops; a clean sweep draws the
    bonus token from the target's next distribution on STREAM_SAMPLE —
    exactly the draw a non-speculative run makes at that position. The
    emitted sequence is distributed as sampling from the target alone.
    Returns (accepted count, emitted tokens)."""
    g = len(props)
    for j, d in enumerate(props):
        p = _softmax(p_logits[j] / temperature)
        q = _softmax(q_logits[j] / temperature)
        u = uniform(seed=seed, rid=rid, position=pos0 + 1 + j, stream=STREAM_ACCEPT)
        if u < min(1.0, float(p[d]) / max(float(q[d]), 1e-30)):
            continue
        resid = np.maximum(p - q, 0.0)
        total = resid.sum()
        dist = resid / total if total > 0.0 else p   # p == q: the residual is empty
        logp = np.full(dist.shape, -np.inf)
        nz = dist > 0
        logp[nz] = np.log(dist[nz])
        t = categorical(logp, seed=seed, rid=rid, position=pos0 + 1 + j,
                        stream=STREAM_RESIDUAL)
        return j, [int(x) for x in props[:j]] + [t]
    t = int(sample(p_logits[g][None], temperature, seed=seed, rids=[rid],
                   positions=[pos0 + g + 1], stream=STREAM_SAMPLE)[0])
    return g, [int(x) for x in props] + [t]


class SpecDecoder:
    """Draft-side state of the speculative engine: the policy-quantized
    weight view, the draft KV pool and the draft step.

    The scheduler owns slots, block tables and the target pool; this object
    owns what the *draft* pass needs: :meth:`mirror_prefill` keeps the draft
    pool in step with prompt chunks, :meth:`draft` proposes γ candidates
    per decode row. Draft steps have three widths (γ+1 catch-up, 1, the
    prefill chunk). ``runner(step, name)`` wraps the draft step: the
    Scheduler's ``_runner``, a graph a width on the card."""

    def __init__(self, cfg: ModelConfig, rc: RunConfig, params: dict, *, max_batch: int,
                 capacity: int, num_pages: int | None, runner, track_energy: bool = False,
                 draft_params: dict | None = None, device=None, impl: str = "auto"):
        from ..quant.surgery import draft_quant_view

        if rc.spec_gamma < 1:
            raise ValueError(f"spec_gamma must be >= 1, got {rc.spec_gamma}")
        self.cfg, self.rc = cfg, rc
        self.gamma = int(rc.spec_gamma)
        self.max_batch = max_batch
        self.track_energy = track_energy
        # draft_params (when given) must be the ORIGINAL float tree: the
        # caller passes it when target-policy surgery packed ``params``
        self.rc_draft, self.draft_params = draft_quant_view(
            cfg, rc, params if draft_params is None else draft_params)
        self.device = resolve_device(device)
        self.caches = init_caches(cfg, self.rc_draft, max_batch, capacity,
                                  num_pages=num_pages, device=self.device)
        self._step = runner(build_mixed_step(cfg, self.rc_draft, with_stats=track_energy,
                                             impl=impl, scope="serve/draft"), "draft")

    def describe_draft(self) -> str:
        from ..quant.policy import effective_policy

        return effective_policy(self.rc_draft).describe()

    # ------------------------------------------------------------- draft ops
    def _run_step(self, toks, dpos, dlens, tables, events, rows, host_lens):
        """One draft mixed step; returns last-column logits (B, V). Under
        track_energy, appends (cycle totals, {row: active-token weight}) to
        ``events`` for SlotMeter draft-bucket attribution (the caller reads
        the totals after its one wait for the card)."""
        self.caches, logits, totals = self._step(self.draft_params, self.caches, toks, dpos,
                                                 dlens, tables)
        if totals is None:
            return logits
        total = float(sum(int(host_lens[r.row]) for r in rows))
        if totals.layout.bits and total > 0:
            events.append((totals, {r.row: int(host_lens[r.row]) / total for r in rows}))
        return logits

    def mirror_prefill(self, tokens, pos, lens, tables):
        """Write one tick's prefill chunks into the draft pool (the rows and
        positions the target step processes; decode rows masked to lens 0
        by the caller). The logits are discarded: this pass exists so the
        pool covers the prompt when drafting starts. Returns the pass's
        cycle totals (``quant.capture.StepTotals``) under track_energy,
        else None."""
        self.caches, _, totals = self._step(self.draft_params, self.caches, tokens, pos, lens,
                                            tables)
        return totals

    def draft(self, rows: list[DraftRow], tables, temperature: float, seed: int):
        """Propose up to γ candidates for every row, batched across rows.

        The first step has width γ+1: it ingests each row's catch-up gap plus
        its pending last token (per-row lens, like a prefill chunk); each
        later step has width 1 and feeds the candidate just proposed (rows
        whose budget ran out, and idle rows, get token 0 at lens 0).
        Proposals are the argmax at temperature 0, else STREAM_DRAFT draws.
        Every step's inputs are built before the first launches. Returns
        (proposals (B, gmax) int32 on the device, the draft logits of each
        step (B, V) on the host at temperature > 0 (for rejection sampling),
        metering events)."""
        B, dev = self.max_batch, self.device
        gmax = max(r.g for r in rows)
        toks = np.zeros((B, self.gamma + 1), np.int32)
        dpos = np.zeros(B, np.int32)
        dlens = np.zeros(B, np.int32)
        for r in rows:
            feed = list(r.gap) + [r.last_token]
            if len(feed) > self.gamma + 1:
                raise AssertionError(
                    f"row {r.row}: draft gap {len(r.gap)} exceeds the catch-up width "
                    "(the scheduler must mark the slot stale)")
            toks[r.row, : len(feed)] = feed
            dpos[r.row] = r.draft_pos
            dlens[r.row] = len(feed)
        # the width-1 steps j = 1..gmax-1: which rows still draft, where, and
        # how many tokens (0 or 1)
        live = np.zeros((max(gmax - 1, 1), B), bool)
        p1 = np.zeros((max(gmax - 1, 1), B), np.int32)
        for r in rows:
            for j in range(1, r.g):
                live[j - 1, r.row] = True
                p1[j - 1, r.row] = r.pos + j
        l1 = live.astype(np.int32)
        live_d, p1_d, l1_d = upload(live, dev), upload(p1, dev), upload(l1, dev)

        events: list = []
        logits = self._run_step(toks, dpos, dlens, tables, events, rows, dlens)
        props: list[torch.Tensor] = []
        qlogits: list[np.ndarray] = []
        for j in range(1, gmax + 1):
            if temperature <= 0.0:
                cand = logits.argmax(dim=-1).to(torch.int32)
            else:
                # rejection sampling needs the draft's full distributions;
                # greedy acceptance never reads them (no host copy there)
                lg = logits.to(torch.float32).cpu().numpy()
                qlogits.append(lg)
                c = np.zeros(B, np.int32)
                for r in rows:
                    if r.g >= j:
                        c[r.row] = sample(lg[r.row][None], temperature, seed=seed,
                                          rids=[r.rid], positions=[r.pos + j],
                                          stream=STREAM_DRAFT)[0]
                cand = upload(c, dev)
            props.append(cand)
            if j == gmax:
                break
            t1 = torch.where(live_d[j - 1], cand, torch.zeros_like(cand))[:, None]
            logits = self._run_step(t1, p1_d[j - 1], l1_d[j - 1], tables, events,
                                    [r for r in rows if r.g > j], l1[j - 1])
        return torch.stack(props, dim=1), qlogits, events

