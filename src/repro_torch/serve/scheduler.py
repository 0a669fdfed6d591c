"""Token-budget scheduler: chunked prefill + decode packed into one mixed
step per tick over a paged KV pool (the reference's
``repro/serve/scheduler.py``).

Each tick packs decode rows first (one token each), then FIFO prompt chunks
of up to ``rc.prefill_chunk`` tokens, into one step of shape
``(max_batch, prefill_chunk)`` — width 1 when only decode rows run. The
step carries a :class:`~repro_torch.models.KVView` (per-row write
position, live width and block table); idle and padded columns write to the
trash page and their outputs are never read. Under pool pressure the
lowest-priority youngest slot is recompute-preempted: its pages are
released and it is requeued at the front of its class, its generated tokens
joining its prompt.

Robustness (DESIGN.md §10): admission flows through
``serve.admission.AdmissionController`` (priority classes, tenant budgets,
per-request tick deadlines, bounded queues), and overload walks ONE ordered
``DegradationLadder`` (shrink the prefill budget → preempt → shed expired
and batch-class work → reject admissions); every tick advances a logical
``clock``, the time of deadlines, fault plans and the ladder. A seed-keyed
``serve.faults.FaultPlan`` can induce allocation failures, preemption storms
and NaN logits against that clock; a numerical guard quarantines any row
whose step logits come back non-finite, retries it clean, and escalates to
a ``rc.fallback_policy`` (bf16) step if the fault persists. Faults change
*scheduling*, never *results*.

Observability (DESIGN.md §14): the counters live in an obs
``MetricsRegistry`` (the legacy int attributes are views over it), TTFT,
inter-token and tick latencies are histograms, an optional ``Tracer``
records request and tick-phase spans, and ``health()`` reports all of it
with this engine's kernel and path counters.

Cycle attribution (``track_energy=True``): a tick's tuGEMM cycles are split
across the rows of the main step by active-token weight
``lens[b] / sum(lens)``, and each tick's MoE capacity drops (the capture's
``moe.dropped_tokens``) are kept in ``tick_dropped_tokens``.
``moe_dropped_tokens`` counts drops on the expert-parallel mesh path only
and stays 0 on one device, as the reference's does.

Prefix caching (``rc.prefix_cache``, DESIGN.md §11): an admission forks the
longest cached block-aligned prefix of its prompt onto its block table
(``BlockManager.fork_prefix``) and starts prefill past it; committed full
blocks are indexed in the trie at every commit point and before every
release; the device page copies owed by copy-on-write are drained into
every pool before the step that writes them.

Speculative decoding (``rc.spec_gamma > 0``, ``serve/spec.py``, DESIGN.md
§9): decode rows draft up to γ tokens against a low-bit draft view and
draft pool, and one target step of width γ+1 (``all_logits``) verifies them
and runs the tick's prefill chunks; rejected candidates roll back through
``BlockManager.truncate``.

``rc.kv_layout="dense"`` keeps one ``(max_batch, capacity)`` KV row per
slot instead of the pool: no ``BlockManager``, the step's view carries no
tables (attention reads the rows contiguously) and nothing stalls for
pages; prefix caching needs the pool and is refused there. SSM and hybrid
stacks have no resumable mixer state for chunked prefill and are refused:
they serve through the legacy ``serve.Engine``. An encoder-only config
(hubert-xlarge) has no decode step and is refused with a ``ValueError``
(the reference does not check; ROADMAP C). An M-RoPE config's step takes
(3, B, W) positions with t = h = w (a text stream).

Sharded serving (``mesh="dp,tp"``, ``parallel/serve_mesh.py``, DESIGN.md
§12): the same mixed step over a (dp, tp) mesh of ``dp·tp`` ranks
(``launch/mesh.py``), this Scheduler's process being rank 0. It plans every
tick, owns the one ``BlockManager`` and every robustness and observability
layer, and each tick sends the ranks the step's inputs; each rank runs its
rows and heads on its own weight and cache shards. Logits come back from tp
rank 0 of each dp group, the stats as (dp, tp) stacks that merge into the
single-device step's (tokens and cycle totals identical), and the
collectives' bytes into ``comms_summary()`` (priced by
``interconnect_report()``); ``device_attribution()`` splits the cycle
totals over the ranks. The fallback step and the copy-on-write page copies
run on every rank too. A mesh needs ``mesh_backend`` named: ``gloo``
(every rank on ``device``: the CPU, or one shared card) or ``nccl`` (rank r
on ``cuda:r``); none is chosen for the caller. Speculative decoding on a
mesh is refused, as in the reference. ``params`` is the full tree (rank 0
cuts each rank's shard) or a ``serve_mesh.InitShards`` (each rank draws
its own).

Compiled steps (``graphs``, ``serve/graphs.py``): on a CUDA device without
a mesh the mixed, verify and draft steps run as CUDA graphs, one a step and
width (the reference's ``jax.jit`` of each), with the eager step's tokens,
cycles and kernel counts; ``graphs=False`` runs them eagerly, and
``graphs=True`` on the CPU or with a mesh raises. The fallback-policy step
and the copy-on-write page copies stay eager.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import resolve_device
from ..configs.base import ModelConfig, RunConfig
from ..core.report import slot_energy
from ..kernels import ops as _kops
from ..launch.ctx_report import sharding_report
from ..models import KVView, forward, init_caches, input_batch, lm_logits
from ..models.transformer import backend_from, check_supported, plan_groups, step_backend
from ..obs.logs import kv
from ..obs.metrics import MetricsRegistry
from ..obs.metrics import family_percentile as _family_percentile
from ..obs.profile import named_scope
from ..obs.trace import NULL_TRACER, PID_REQUESTS, PID_SCHED, TID_TICK
from ..parallel.sharding import current_ctx as sharding_ctx
from ..quant import capture as stats_capture
from ..quant.capture import scalar_totals, tree_totals_by_bits
from .admission import (
    LADDER_LEVELS,
    PRIORITY_RANK,
    AdmissionController,
    DegradationLadder,
    Rejection,
    RejectReason,
)
from .cache import BlockManager, cache_bytes, copy_pages, dense_cache_tokens, num_pages_for
from .graphs import CudaGraph, StepGraphs, resolve_graphs, upload

__all__ = ["Request", "SlotMeter", "Scheduler", "build_mixed_step", "install_sigint_drain",
           "sample", "uniform", "categorical", "STREAM_SAMPLE", "STREAM_DRAFT",
           "STREAM_ACCEPT", "STREAM_RESIDUAL"]

log = logging.getLogger("repro_torch.serve")

# Stream tags of the per-request draws: the token sampled at a position must
# draw from another stream than the speculative machinery's draws *about*
# that position (serve/spec.py), or acceptance thresholds would be
# correlated with the tokens they judge.
STREAM_SAMPLE = 0    # the canonical next-token draw at a position
STREAM_DRAFT = 1     # draft-model proposal draw
STREAM_ACCEPT = 2    # rejection-sampling acceptance uniform
STREAM_RESIDUAL = 3  # residual-distribution draw after a rejection


def _stream(seed: int, rid: int, position: int, stream: int) -> np.random.Generator:
    """The counter-based Philox stream keyed by (seed, rid) at counter
    (position, stream): its draws depend only on those four numbers."""
    return np.random.Generator(np.random.Philox(
        key=np.array([seed, rid], np.uint64),
        counter=np.array([position, stream, 0, 0], np.uint64)))


def sample(logits: np.ndarray, temperature: float = 0.0, *, seed: int = 0,
           rids=None, positions=None, stream: int = STREAM_SAMPLE) -> np.ndarray:
    """Greedy argmax at temperature <= 0. Otherwise a Gumbel-max draw per
    row from ``_stream(seed, rid, position, stream)``: a request's draws
    depend only on (seed, rid, position, stream), never on how ticks were
    packed, so temperature > 0 runs are reproducible and schedule-invariant
    (the reference keys ``jax.random.fold_in`` the same way; the bits
    themselves differ)."""
    if temperature <= 0.0:
        return np.argmax(logits, axis=-1).astype(np.int32)
    out = np.empty(logits.shape[0], np.int32)
    for b in range(logits.shape[0]):
        g = _stream(seed, rids[b], positions[b], stream).gumbel(size=logits.shape[-1])
        out[b] = np.argmax(logits[b].astype(np.float64) / temperature + g)
    return out


def uniform(*, seed: int, rid: int, position: int, stream: int = STREAM_ACCEPT) -> float:
    """One uniform draw in [0, 1) from the request's stream at ``position``."""
    return float(_stream(seed, rid, position, stream).random())


def categorical(logp: np.ndarray, *, seed: int, rid: int, position: int,
                stream: int = STREAM_RESIDUAL) -> int:
    """One draw from log-probabilities ``logp`` (V,) (``-inf`` = no mass) by
    Gumbel-max on the request's stream at ``position``."""
    g = _stream(seed, rid, position, stream).gumbel(size=logp.shape[-1])
    return int(np.argmax(logp.astype(np.float64) + g))


@dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int = 32
    out: list[int] = field(default_factory=list)
    done: bool = False
    # robustness metadata (serve/admission.py). ``priority`` is one of
    # realtime | interactive | batch; ``ttl_ticks`` is a deadline relative to
    # submission on the scheduler's logical clock (None = no deadline);
    # ``tenant`` keys per-tenant token budgets. Terminal state is exactly one
    # of ``done`` (completed) or ``rejected`` (a structured
    # admission.Rejection) — never silence.
    tenant: str = "default"
    priority: str = "interactive"
    ttl_ticks: int | None = None
    deadline: int | None = None      # absolute clock deadline (set at submit)
    submitted_tick: int = 0
    admitted: bool = False           # ever held a slot (preemption re-queues stay True)
    rejected: Rejection | None = None
    # tenant accounting: ``charged`` is the quote debited at submit
    # (len(prompt) + max_new, 0 when the tenant has no budget);
    # ``prompt_consumed`` high-water-marks how many *original* prompt tokens
    # have been committed to KV (generated tokens live in ``out``);
    # ``settled`` guards the terminal one-shot refund of the remainder.
    charged: int = 0
    prompt_consumed: int = 0
    settled: bool = False

    def consumed_tokens(self) -> int:
        """Tokens this request used against its tenant quote: prompt tokens
        committed plus every token generated. Recompute-preemption
        re-prefills are not double-counted: the quote caps service
        delivered, not engine work performed."""
        return self.prompt_consumed + len(self.out)


@dataclass
class SlotMeter:
    """Per-request tuGEMM accounting across prefill + decode, bucketed per
    bitwidth (mixed policies run int8 and int2 cycles at different clocks
    and Table-I power points). Shared-step cycles accumulate as floats (a
    step's total times this slot's active-token weight); rounding happens
    once at read, so the meters stay conservative: the sum over slots is
    the measured pool total."""

    rid: int
    prompt_tokens: int = 0
    decode_tokens: int = 0
    # prompt tokens served from the prefix cache: their KV was forked from
    # shared pages, so they never ran in a prefill chunk and are charged no
    # cycles — the one meter difference from an uncached run of a trace
    cached_prompt_tokens: int = 0
    emitted_tokens: int = 0
    # speculative decoding: proposals this request drafted, and how many the
    # target verified and kept. Rejected drafts' cycles are not subtracted
    # anywhere, so energy per accepted token includes the waste.
    drafted_tokens: int = 0
    accepted_draft_tokens: int = 0
    # bits -> {variant: cycles}. ``prefill_by_bits`` is the legacy Engine's
    # exact B=1 prefill bucket (the scheduler charges prefill chunks to the
    # shared-step bucket); draft-pass cycles stay apart from the target's,
    # at the draft policy's bitwidths.
    prefill_by_bits: dict = field(default_factory=dict)   # bits -> {variant: int}
    decode_by_bits: dict = field(default_factory=dict)    # bits -> {variant: float}
    draft_by_bits: dict = field(default_factory=dict)     # bits -> {variant: float}

    def add_prefill(self, by_bits: dict) -> None:
        """Charge a legacy-Engine B=1 prefill's cycles, exactly."""
        for b, tot in by_bits.items():
            d = self.prefill_by_bits.setdefault(b, {"serial": 0, "parallel": 0})
            d["serial"] += tot["serial_cycles"]
            d["parallel"] += tot["parallel_cycles"]

    def add_share(self, by_bits: dict, weight: float, *, bucket: str = "decode") -> None:
        """Charge ``weight`` (this slot's active-token fraction) of one
        step's pool-wide cycles; ``bucket="draft"`` routes them to the
        draft-pass bucket, the default to the target's (decode, prefill
        chunks and verify steps)."""
        dst = self.draft_by_bits if bucket == "draft" else self.decode_by_bits
        for b, tot in by_bits.items():
            d = dst.setdefault(b, {"serial": 0.0, "parallel": 0.0})
            d["serial"] += tot["serial_cycles"] * weight
            d["parallel"] += tot["parallel_cycles"] * weight

    def add_decode_share(self, by_bits: dict, active: int) -> None:
        """The legacy Engine's even split: every active row decodes one
        token, so 1/active is the active-token weight."""
        self.add_share(by_bits, 1.0 / active)

    def cycles_by_bits(self, variant: str = "serial", *,
                       bucket: str | None = None) -> dict[int, int]:
        """Total cycles per bitwidth; ``bucket`` picks one of "prefill",
        "decode" and "draft", None sums all three."""
        srcs = {"prefill": self.prefill_by_bits, "decode": self.decode_by_bits,
                "draft": self.draft_by_bits}
        out: dict[int, int] = {}
        for src in (srcs.values() if bucket is None else (srcs[bucket],)):
            for b, d in src.items():
                out[b] = out.get(b, 0) + int(round(d[variant]))
        return out

    def energy(self, variant: str = "serial") -> dict:
        """Latency/energy of this request's GEMM work on the paper's 16×16
        unit, each bitwidth at its own clock and power. Under speculative
        decoding ``energy_j`` includes the draft pass and every rejected
        candidate's verify cycles; the ``draft_*`` fields give the split."""
        by = self.cycles_by_bits(variant)
        lat = e_j = 0.0
        for b, cyc in by.items():
            l, e = slot_energy(b, variant, cyc)
            lat += l
            e_j += e
        draft_by = self.cycles_by_bits(variant, bucket="draft")
        draft_e = sum(slot_energy(b, variant, cyc)[1] for b, cyc in draft_by.items())
        out = {
            "rid": self.rid,
            "tokens": self.prompt_tokens + self.decode_tokens,
            "generated_tokens": self.emitted_tokens,
            "cycles": sum(by.values()),
            "cycles_by_bits": by,
            "latency_s": lat,
            "energy_j": e_j,
        }
        if self.drafted_tokens or draft_by:
            out.update(
                drafted_tokens=self.drafted_tokens,
                accepted_draft_tokens=self.accepted_draft_tokens,
                draft_cycles_by_bits=draft_by,
                draft_energy_j=draft_e,
                target_energy_j=e_j - draft_e,
            )
        return out


# ------------------------------------------------------------------- step fn
def build_mixed_step(cfg: ModelConfig, rc: RunConfig, *, with_stats: bool = False,
                     all_logits: bool = False, impl: str = "auto", scope: str = "serve/step"):
    """One tick: (params, caches, tokens (B,W), pos (B,), lens (B,), tables)
    -> (caches, logits[, capture]). By default row b's logits (B, V) come
    from hidden column lens[b]-1. ``all_logits=True`` keeps every column's
    next-token logits, (B, W, V): the speculative verify step judges all γ+1
    candidate positions of a row in one pass (padded columns carry garbage;
    callers mask by lens). Caches are updated in place. ``impl`` selects
    every kernel's path (``kernels/ops.py``). The step runs inside a
    ``named_scope(scope)`` profiler range, the lm head inside
    ``serve/logits``.

    An unquantized head under ``all_logits`` runs once per column on that
    column's (B, 1) rows: the very product a decode step computes, so a
    verify column's logits equal the decode step's bit for bit whatever
    kernel the matmul library picks for a taller M. A quantized head runs
    once over all columns, as the reference's does: its cycle statistics
    are those of that one GEMM."""
    head_per_column = all_logits and (
        cfg.tie_embeddings or backend_from(rc).for_gemm("lm_head").kind == "bf16")

    @torch.no_grad()
    def step(params, caches, tokens, pos, lens, tables):
        view = KVView(pos=pos, lens=lens, tables=tables, block_size=rc.block_size,
                      layout=rc.kv_layout)
        cuda = tokens.is_cuda
        with named_scope(scope, cuda=cuda):
            h, caches, _ = forward(cfg, rc, params, input_batch(cfg, tokens, pos),
                                   caches=caches, cache_pos=pos, kv_view=view, impl=impl)
            with named_scope("serve/logits", cuda=cuda):
                if head_per_column:
                    return caches, torch.cat(
                        [lm_logits(cfg, rc, params, h[:, j:j + 1].contiguous(), impl=impl)
                         for j in range(h.shape[1])], dim=1)
                if all_logits:
                    return caches, lm_logits(cfg, rc, params, h, impl=impl)
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
    # speculative decoding: tokens already written to this row of the
    # *draft* pool, and the committed tokens the draft has not ingested yet
    # (draft_pos + len(draft_gap) == pos at tick boundaries). The gap is
    # normally 0 or 1 token and bounded by γ: a slot that falls further
    # behind goes draft_stale and plain-decodes until a healthy tick
    # re-ingests its committed tokens into the draft pool.
    draft_pos: int = 0
    draft_gap: list[int] = field(default_factory=list)
    draft_stale: bool = False
    # numerical-fault quarantine: consecutive non-finite logits strikes, and
    # whether the row moved to the fallback (bf16-policy) step. Fallback is
    # sticky — a model that NaNs at low bits will NaN again.
    retries: int = 0
    fallback: bool = False
    # prefix cache: committed full blocks of this slot already indexed in
    # the trie (forked blocks count from admission, so a forked slot never
    # re-registers what it borrowed)
    reg_blocks: int = 0

    @property
    def prefilling(self) -> bool:
        return self.pos < len(self.prompt)


# The Scheduler's counters, registry-backed (the reference's families). Each
# becomes a class-level property over a ``serve_<attr>_total``
# Counter, so ``self.x += 1`` writes and Prometheus/JSONL export and
# health() read one store.
_SCHED_COUNTERS = {
    "generated_tokens": "tokens emitted (decode + prefill-riding first tokens)",
    "drafted_tokens": "speculative proposals drafted",
    "accepted_draft_tokens": "drafted tokens the target verified and kept",
    "ticks": "tick() calls that ran a device step",
    "preemptions": "slots evicted under pool pressure (recompute-on-resume)",
    "prefix_hits": "admissions that forked a cached prefix",
    "prefix_tokens_reused": "prompt tokens served from shared pages",
    "prefill_tokens_computed": "prompt tokens actually stepped",
    "deadline_misses": "completions past their deadline",
    "stalled_rows_total": "row-ticks lost to pool exhaustion",
    "stall_episodes": "distinct pool-pressure episodes",
    "engine_stalls": "unexplained no-progress ticks (must stay 0)",
    "idle_fault_ticks": "ticks idled by injected allocation exhaustion",
    "nan_events": "non-finite logit rows quarantined",
    "fallback_retries": "rows escalated to the fallback-policy step",
    "draft_stale_events": "slots entering draft staleness",
    "draft_resyncs": "stale slots recovered via draft resync",
    "moe_dropped_tokens": "router capacity drops (never silent)",
}


def _counter_property(attr: str):
    def fget(self):
        v = self._ctr[attr].value
        return int(v) if float(v).is_integer() else v

    def fset(self, v):
        self._ctr[attr].value = v

    return property(fget, fset)


class Scheduler:
    """Block-managed, continuously batched serving engine.

    One mixed step of shape ``(max_batch, prefill_chunk)`` serves prefill
    and decode alike; each tick fills rows under a token budget with decode
    rows first, then FIFO prompt chunks. ``params`` must live on ``device``
    (default ``cuda``); the paged pools are allocated there. ``admission``,
    ``faults``, ``tracer`` and ``metrics`` take the robustness and
    observability parts (defaults: unbounded classes, no faults, no
    tracing, a private registry). ``draft_params`` is the float tree the
    speculative draft view is built from when ``params`` were already
    packed for the target policy (default: ``params``). ``mesh`` ("dp,tp",
    a (dp, tp) pair or a ``MeshSpec``) shards the step over ``dp·tp`` ranks
    on ``mesh_backend`` (see the module docstring). ``graphs`` (None: on a
    CUDA device without a mesh) replays the steps as CUDA graphs.
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
        draft_params: dict | None = None,
        admission: AdmissionController | None = None,
        faults=None,
        tracer=None,
        metrics: MetricsRegistry | None = None,
        device=None,
        impl: str = "auto",
        mesh=None,
        mesh_backend: str | None = None,
        graphs: bool | None = None,
    ):
        if any(k.mixer in ("ssm", "hybrid") for g in plan_groups(cfg) for k in g.kinds):
            raise NotImplementedError(
                "chunked-prefill scheduling needs resumable mixer state; "
                "SSM/hybrid stacks serve through the legacy Engine")
        if cfg.is_encoder:
            raise ValueError(f"{cfg.name} is an encoder-only config: it has no decode step "
                             "to serve; run models.forward without caches")
        check_supported(cfg, rc)
        self.device = resolve_device(device)
        self.cfg, self.rc, self.params = cfg, rc, params
        self.capacity, self.max_batch = capacity, max_batch
        self.chunk = max(rc.prefill_chunk, 1)
        self.token_budget = rc.token_budget or max_batch * self.chunk
        self.temperature = temperature
        self.seed = seed
        self.track_energy = track_energy
        self.impl = impl
        self.graphs = resolve_graphs(graphs, self.device, mesh)

        # --- observability (DESIGN.md §14) ------------------------------
        # ``self.trace`` is NULL_TRACER when tracing is off: every call site
        # guards arg construction on ``self.trace.enabled``. The counters
        # are class-level properties over registry Counters.
        self.trace = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._init_metrics()
        for a in _SCHED_COUNTERS:     # every counter exports a sample from the start
            setattr(self, a, 0)
        if self.trace.enabled:
            self.trace.name_process(PID_SCHED, "scheduler")
            self.trace.name_thread(PID_SCHED, TID_TICK, "tick")
            self.trace.name_process(PID_REQUESTS, "requests")
        # kernel and path counters are process-wide: health() reports their
        # growth since this engine was built, never another engine's calls
        self._kernel_base = _kops.kernel_counters()
        self._t_submit: dict[int, float] = {}    # rid -> wall time at submit
        self._t_queued: dict[int, float] = {}    # rid -> tracer ts at enqueue
        self._t_emit: dict[int, float] = {}      # rid -> wall time, last emit
        self._tick_energy_j = 0.0                # modeled J this tick
        self._total_energy_j = 0.0               # modeled J since construction

        self.paged = rc.kv_layout == "paged"
        self.prefix_caching = bool(getattr(rc, "prefix_cache", False))
        if self.prefix_caching and not self.paged:
            raise ValueError(
                "rc.prefix_cache needs rc.kv_layout='paged' — prefix sharing "
                "is page aliasing; the dense layout has nothing to alias")
        pages = None
        self.mgr: BlockManager | None = None
        if self.paged:
            pages = num_pages if num_pages is not None else num_pages_for(
                capacity, rc.block_size, max_batch)
            self.mgr = BlockManager(pages, rc.block_size, max_batch, capacity,
                                    prefix_cache=self.prefix_caching)
            self.mgr.bind_registry(self.metrics)
        # sharded serving (parallel/serve_mesh.py): the planner, the
        # BlockManager and every host loop stay here; the ranks hold the
        # weight and cache shards
        self.mesh = None
        self._shard_ctx = sharding_ctx()    # for health(): dropped rules, replicated dims
        self._accounted: dict = {}          # step width -> the context it was counted in (rank pool)
        self._pool = None
        self.comms: dict = {}               # (label, bits) -> byte totals
        self._device_weight: dict = {}      # bits -> (dp, tp) int64 serial load
        # the steps a tick calls (serve/graphs.py): one graph a width on the
        # card, sharing one memory pool; eager otherwise
        self._graph_pool = (torch.cuda.graph_pool_handle() if self.graphs else None)
        self._step = None
        if mesh is not None:
            self._attach_mesh(mesh, mesh_backend, params, pages)
        else:
            self.caches = init_caches(cfg, rc, max_batch, capacity, num_pages=pages,
                                      device=self.device)
            self._step = self._runner(build_mixed_step(cfg, rc, with_stats=track_energy,
                                                       impl=impl), "main")
        # speculative decoding: a draft-policy view + draft pool
        # (serve.spec.SpecDecoder) backed by this one BlockManager, and a
        # verify step that keeps every column's logits; spec_gamma == 0
        # leaves the plain path as it is
        self.spec = None
        self._vstep = None
        if getattr(rc, "spec_gamma", 0) > 0:
            from .spec import SpecDecoder

            self.spec = SpecDecoder(cfg, rc, params, max_batch=max_batch, capacity=capacity,
                                    num_pages=pages, track_energy=track_energy,
                                    draft_params=draft_params, device=self.device, impl=impl,
                                    runner=self._runner)
            self._vstep = self._runner(build_mixed_step(
                cfg, rc, with_stats=track_energy, all_logits=True, impl=impl,
                scope="serve/verify"), "verify")
        self.slots: list[_Slot | None] = [None] * max_batch
        self.finished: list[Request] = []
        self.finished_meters: list[SlotMeter] = []
        self.final_kv_lens: dict[int, int] = {}     # rid -> live KV at finish
        self.cycles_by_bits: dict = {}              # bits -> exact int cycle totals
        self.tick_dropped_tokens: list[int] = []    # capture's MoE drops a tick (track_energy)
        self.tick_seconds: list[float] = []         # wall time of every main step, to its sync
        self._admit_counter = 0
        self._meters_by_rid: dict[int, SlotMeter] = {}
        self._rr = 0                     # rotating plan start (fairness)

        # --- robustness layer (DESIGN.md §10) ---
        self.admission = admission if admission is not None else AdmissionController()
        self.ladder = DegradationLadder(relax_after=rc.ladder_relax_ticks)
        self.faults = faults             # serve.faults.FaultPlan | None
        self.clock = 0                   # logical time: +1 per tick() call,
        #                                  even idle ones
        self.draining = False            # graceful shutdown: no new admissions
        self._in_stall = False
        self.nan_retry_limit = 1         # clean retries before bf16 fallback
        self._fault_fired = False        # injected alloc failure this tick
        self._stall_this_tick = False
        self._fb_step = None             # lazily built fallback-policy step
        self._fb_rc = None               # ... and its RunConfig
        self._fb_unavailable = False
        if self.mgr is not None and self.faults is not None:
            self.mgr.fault_hook = self._alloc_fault_hook
        # one registry for the whole engine: the controller's counters move in
        self.admission.bind_registry(self.metrics)
        self._register_gauges()

    def _runner(self, step, name: str, *, eager: bool = False) -> StepGraphs:
        """``step`` behind a :class:`~repro_torch.serve.graphs.StepGraphs`:
        graphed when this Scheduler replays graphs (and not ``eager``)."""
        graphed = self.graphs and not eager
        return StepGraphs(step, name=name, device=self.device, rows=self.max_batch,
                          table_width=None if self.mgr is None else self.mgr.tables.shape[1],
                          backend=CudaGraph if graphed else None, pool=self._graph_pool)

    def _runners(self) -> dict:
        """Every step runner this Scheduler built, by name."""
        out = {"main": self._step, "verify": self._vstep,
               "draft": self.spec._step if self.spec is not None else None,
               "fallback": self._fb_step}
        return {k: v for k, v in out.items() if v is not None}

    def step_counts(self) -> dict:
        """Eager calls and graph replays of each step a width (with each
        graph's capture ms and the pool bytes its capture reserved):
        ``{step: {width: {"eager", "replays"[, "capture_ms",
        "pool_bytes"]}}}``. The eager calls of a graphed step are its first
        call at each width; the fallback step is always eager."""
        return {name: r.counts() for name, r in self._runners().items() if r.counts()}

    def _attach_mesh(self, mesh, backend: str, params, pages) -> None:
        """Start (or reuse) the rank pool and build every rank's engine:
        rank r's weights from ``params`` (the full tree, cut here; or an
        ``InitShards`` each rank draws from), its cache shards and step."""
        from ..launch.mesh import rank_pool
        from ..parallel import serve_mesh as sm

        if getattr(self.rc, "spec_gamma", 0) > 0:
            raise NotImplementedError(
                "speculative decoding on a mesh is not supported yet: the draft "
                "pool's fork / rollback protocol is single-device")
        spec = self.mesh = sm.as_spec(mesh)
        sm.validate(self.cfg, self.rc, spec, self.max_batch)
        if isinstance(params, dict):
            sources = [sm.TreeShard(sm.shard_params(spec, params, *divmod(r, spec.tp)))
                       for r in range(spec.devices)]
        else:
            sources = [params] * spec.devices
        self._pool = rank_pool(spec, backend=backend, device=self.device)
        self._eid = self._pool.attach(
            sources, cfg=self.cfg, rc=self.rc, spec=spec, max_batch=self.max_batch,
            capacity=self.capacity, num_pages=pages, with_stats=self.track_energy,
            impl=self.impl)
        eng = self._pool.engine
        self.params, self.caches = eng.params, eng.caches
        self._mesh_step = eng.step
        # each rank's step seconds and their part inside collectives
        self._rank_seconds = np.zeros((spec.devices, 2))
        # the whole mesh's cache bytes (cache_stats), from the full shapes
        self._mesh_cache_bytes = cache_bytes(init_caches(
            self.cfg, self.rc, self.max_batch, self.capacity, num_pages=pages, device="meta"))

    # ---------------------------------------------------------- observability
    def _init_metrics(self) -> None:
        m = self.metrics
        self._ctr = {
            a: m.counter(f"serve_{a}_total", h)
            for a, h in _SCHED_COUNTERS.items()
        }
        self._h_ttft = m.histogram(
            "serve_ttft_seconds",
            "wall time from submit to first emitted token", labels=("priority",))
        self._h_itl = m.histogram(
            "serve_itl_seconds",
            "wall time between consecutive emitted tokens", labels=("priority",))
        self._h_queue_wait = m.histogram(
            "serve_queue_wait_ticks",
            "logical ticks spent queued before (re)admission",
            labels=("priority",),
            buckets=(0, 1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024))
        self._h_tick = m.histogram(
            "serve_tick_seconds", "wall duration of one tick() call")
        self._c_sched_tokens = m.counter(
            "serve_scheduled_tokens_total",
            "tokens packed into device steps, by phase", labels=("phase",))
        self._c_cycles = m.counter(
            "serve_modeled_cycles_total",
            "modeled tuGEMM cycles by bitwidth (serial variant)",
            labels=("bits", "bucket"))
        self._c_energy = m.counter(
            "serve_modeled_energy_joules",
            "modeled tuGEMM energy by bucket (Table-I pricing)",
            labels=("bucket",))

    def _register_gauges(self) -> None:
        """Callback gauges over structural state, read at snapshot time;
        registered last so every attribute they close over exists."""
        m = self.metrics
        m.gauge_fn("serve_active_slots",
                   lambda: sum(s is not None for s in self.slots),
                   help="slots currently holding a request")
        m.gauge_fn("serve_clock", lambda: self.clock,
                   help="logical scheduler clock (ticks since construction)")
        m.gauge_fn("serve_queue_depth",
                   lambda: {f"priority={c}": d
                            for c, d in self.admission.depths().items()},
                   help="queued requests by priority class")
        m.gauge_fn("serve_ladder_level", lambda: self.ladder.level,
                   help="degradation ladder level (0=healthy)")

    def _note_step_energy(self, by_bits: dict, *, bucket: str) -> None:
        """Mirror one step's tuGEMM cycle totals into the registry and the
        modeled-energy accumulators (Table-I pricing via
        core.report.slot_energy); no-op when the step carries no stats."""
        if not by_bits:
            return
        tick_j = 0.0
        for b, tot in by_bits.items():
            cyc = tot["serial_cycles"]
            self._c_cycles.labels(str(b), bucket).inc(cyc)
            tick_j += slot_energy(b, "serial", cyc)[1]
        self._c_energy.labels(bucket).inc(tick_j)
        self._tick_energy_j += tick_j
        self._total_energy_j += tick_j

    def _emit_counter_tracks(self, tick_wall_s: float) -> None:
        """Per-tick counter samples (pool occupancy, queue depth, ladder
        level, modeled power); only called when tracing is on."""
        tr = self.trace
        ts = tr.ts()
        if self.mgr is not None:
            tr.counter("pool_pages", {
                "in_use": self.mgr.pages_in_use,
                "live": self.mgr.live_pages,
            }, ts=ts)
        tr.counter("queue_depth", self.admission.depths(), ts=ts)
        tr.counter("ladder_level", {"level": self.ladder.level}, ts=ts)
        if self.track_energy:
            mw = (self._tick_energy_j / tick_wall_s * 1e3
                  if tick_wall_s > 0 else 0.0)
            tr.counter("modeled_power_mw", {"mw": round(mw, 3)}, ts=ts)
            tr.counter("modeled_energy_mj",
                       {"mj": round(self._total_energy_j * 1e3, 6)}, ts=ts)

    # ---------------------------------------------------------------- admin
    @property
    def queue(self) -> list[Request]:
        """Pop-order view of the admission queues (read-only — mutate
        through ``submit`` / the AdmissionController)."""
        return self.admission.pending_list()

    def submit(self, req: Request) -> Rejection | None:
        """Admit through the AdmissionController. Returns None when queued,
        else the structured :class:`~repro_torch.serve.admission.Rejection`
        (also stored on ``req.rejected``). Oversized prompts still raise —
        that is a caller bug, not load."""
        if len(req.prompt) > self.capacity - 1:
            raise ValueError(
                f"request {req.rid}: prompt of {len(req.prompt)} tokens "
                f"exceeds capacity {self.capacity} - 1")
        rej = self.admission.submit(req, self.clock)
        if rej is None:
            self._t_submit[req.rid] = time.perf_counter()
        if self.trace.enabled:
            tr = self.trace
            tr.name_thread(PID_REQUESTS, req.rid, f"req {req.rid}")
            if rej is None:
                self._t_queued[req.rid] = tr.ts()
                tr.instant("submit", PID_REQUESTS, req.rid, args={
                    "rid": req.rid, "tenant": req.tenant,
                    "priority": req.priority,
                    "prompt_tokens": len(req.prompt),
                })
            else:
                tr.instant("reject", PID_REQUESTS, req.rid,
                           args={"rid": req.rid, "reason": rej.reason})
        return rej

    def begin_drain(self) -> None:
        """Graceful shutdown: stop admitting new work (structured
        SHUTTING_DOWN rejections), let active slots — and preempted work
        that already ran — finish, then ``run()`` flushes whatever is still
        queued. SlotMeters survive the drain."""
        self.draining = True
        self.admission.draining = True

    def _admit(self) -> None:
        for i, sl in enumerate(self.slots):
            if sl is not None:
                continue
            req = self.admission.pop(self.clock, readmit_only=self.draining)
            if req is None:
                break
            meter = None
            if self.track_energy:
                # a preempted request resumes its meter: charged cycles stay
                meter = self._meters_by_rid.get(req.rid)
                if meter is None:
                    meter = SlotMeter(rid=req.rid, prompt_tokens=len(req.prompt))
                    self._meters_by_rid[req.rid] = meter
            sl = _Slot(req=req, prompt=list(req.prompt) + list(req.out),
                       admit_seq=self._admit_counter, meter=meter)
            self.slots[i] = sl
            self._admit_counter += 1
            self._h_queue_wait.labels(req.priority).observe(
                max(self.clock - req.submitted_tick, 0))
            if self.trace.enabled:
                tr = self.trace
                now = tr.ts()
                t0 = self._t_queued.pop(req.rid, now)
                tr.complete("queued", PID_REQUESTS, req.rid, t0, now - t0,
                            args={"rid": req.rid, "priority": req.priority})
                tr.instant("admit", PID_REQUESTS, req.rid, args={
                    "rid": req.rid, "slot": i,
                    "wait_ticks": self.clock - req.submitted_tick,
                    "readmit": req.admitted,
                }, ts=now)
            if self.prefix_caching:
                # fork the longest cached block-aligned prefix of the
                # effective prompt (refcount++, no allocation) and start
                # prefill past it: the matched tokens are never stepped and
                # charge no cycles; at least one suffix token remains to
                # seed the first sample
                nodes, matched = self.mgr.lookup_prefix(sl.prompt, now=self.clock)
                if matched:
                    self.mgr.fork_prefix(i, nodes, now=self.clock)
                    sl.pos = matched
                    sl.reg_blocks = len(nodes)
                    self.prefix_hits += 1
                    self.prefix_tokens_reused += matched
                    if sl.meter is not None:
                        sl.meter.cached_prompt_tokens += matched
                    if self.spec is not None:
                        # the shared pages back the draft pool too (one
                        # BlockManager, the same tables): whatever draft KV
                        # their writer mirrored there is reused as it is.
                        # Worse draft content only lowers acceptance; the
                        # verify step keeps the output exact.
                        sl.draft_pos = matched

    def _note_consumed(self, sl: _Slot) -> None:
        """High-water-mark the original prompt tokens committed to KV —
        read by admission.settle at every terminal/requeue transition."""
        sl.req.prompt_consumed = max(
            sl.req.prompt_consumed, min(sl.pos, len(sl.req.prompt)))

    def _release_slot(self, i: int) -> _Slot:
        """Free slot ``i`` of a request that reached a terminal state: keep
        its meter, return its pages, forget its latency clocks."""
        sl = self.slots[i]
        if sl.meter is not None:
            self.finished_meters.append(sl.meter)
            self._meters_by_rid.pop(sl.req.rid, None)
        if self.mgr is not None:
            self.mgr.release(i)
        self.slots[i] = None
        self._t_submit.pop(sl.req.rid, None)
        self._t_emit.pop(sl.req.rid, None)
        return sl

    def _finish(self, i: int) -> None:
        sl = self.slots[i]
        sl.req.done = True
        if sl.req.deadline is not None and self.clock > sl.req.deadline:
            self.deadline_misses += 1
        self.finished.append(sl.req)
        self.final_kv_lens[sl.req.rid] = sl.pos
        # index the finished sequence's full blocks before releasing: its
        # pages outlive the slot as cached prefixes (refcount 0, evictable)
        self._register_prefix(i)
        self._note_consumed(sl)
        # refund the unused remainder of the quote (an early stop's max_new)
        self.admission.settle(sl.req)
        self._release_slot(i)
        if self.trace.enabled:
            self.trace.instant("finish", PID_REQUESTS, sl.req.rid, args={
                "rid": sl.req.rid, "generated": len(sl.req.out),
                "deadline_missed": bool(
                    sl.req.deadline is not None
                    and self.clock > sl.req.deadline),
            })

    def _shed_slot(self, i: int, reason: str, detail: str = "") -> None:
        """Terminate an *active* slot with a structured rejection (a
        numerical fault with no fallback path). Pages are released; the
        request is terminal — rejected, never silently dropped."""
        sl = self.slots[i]
        r = Rejection(rid=sl.req.rid, reason=reason, detail=detail,
                      tick=self.clock)
        sl.req.rejected = r
        self.admission.rejections.append(r)
        self.admission.sheds += 1
        # settle net of what actually ran
        self._note_consumed(sl)
        self.admission.settle(sl.req)
        self._release_slot(i)
        if self.trace.enabled:
            self.trace.instant("shed", PID_REQUESTS, sl.req.rid, args={
                "rid": sl.req.rid, "reason": reason})

    def _preempt_one(self) -> bool:
        """Recompute-preemption under pool pressure (ladder level 3):
        release the lowest-priority youngest slot's pages and requeue it at
        the front of its class; its effective prompt (original + generated)
        is re-prefilled on readmission. Never preempts the last active slot
        (it must be able to drain)."""
        cand = [i for i, s in enumerate(self.slots) if s is not None]
        if len(cand) <= 1:
            return False
        i = max(cand, key=lambda j: (PRIORITY_RANK[self.slots[j].req.priority],
                                     self.slots[j].admit_seq))
        sl = self.slots[i]
        # consumption must be current before the victim re-enters the queue:
        # if it expires there, the shed settles against these numbers
        self._note_consumed(sl)
        # its committed blocks are still good KV: index them, so that the
        # readmission (and any request sharing the prompt) forks them
        self._register_prefix(i)
        if self.mgr is not None:
            self.mgr.release(i)
        self.admission.requeue_front(sl.req)
        self.slots[i] = None
        self.preemptions += 1
        self.ladder.escalate_to(self.clock, 3, "preemption")
        if self.trace.enabled:
            self.trace.instant("preempt", PID_REQUESTS, sl.req.rid, args={
                "rid": sl.req.rid, "slot": i, "pos": sl.pos})
            self._t_queued[sl.req.rid] = self.trace.ts()
        return True

    # ---------------------------------------------------------- fault hooks
    def _alloc_fault_hook(self, slot: int, new_len: int) -> bool:
        """BlockManager hook: injected page-allocation failure for the
        (clock, slot) pairs the fault plan names."""
        if self.faults.fires(self.clock, "alloc_fail", slot):
            self._fault_fired = True
            return True
        return False

    def _apply_tick_faults(self) -> None:
        """Tick-start faults: forced preemption storms and draft staleness.
        (``alloc_fail`` fires inside BlockManager.extend, ``nan_logits``
        after the step; ``draft_stale`` is inert without speculative
        decoding.)"""
        for ev in self.faults.at(self.clock, "preempt_storm"):
            for _ in range(ev.arg):
                if not self._preempt_one():
                    break
        for ev in self.faults.at(self.clock, "draft_stale"):
            sl = self.slots[ev.arg % self.max_batch]
            if sl is not None and self.spec is not None and not sl.draft_stale:
                sl.draft_stale = True
                sl.draft_gap = []
                self.draft_stale_events += 1

    def _note_stall(self, stalled: int) -> None:
        """Rows whose page allocation failed this tick: count them, escalate
        the ladder (allocation stalls stop at ``preempt``) and log once per
        pressure episode."""
        self.stalled_rows_total += stalled
        self._stall_this_tick = True
        self.ladder.note_pressure(self.clock, "alloc_stall", ceil=3)
        if not self._in_stall:
            self.stall_episodes += 1
            self._in_stall = True
            log.warning(kv(
                "stall", tick=self.clock, rows=stalled,
                pool=(f"{self.mgr.pages_in_use}/{self.mgr.num_pages}"
                      if self.mgr is not None else "dense"),
                ladder=self.ladder.snapshot()["name"],
                episode=self.stall_episodes,
            ))
            if self.trace.enabled:
                self.trace.instant("stall", PID_SCHED, TID_TICK, args={
                    "tick": self.clock, "rows": stalled})

    # ---------------------------------------------------------- prefix cache
    def _register_prefix(self, i: int) -> None:
        """Index slot ``i``'s newly committed full blocks in the prefix trie.
        Called after every commit point and before every release, so a
        concurrent request sharing the prompt can fork a block the moment it
        fills. O(1) when no block completed."""
        if not self.prefix_caching:
            return
        sl = self.slots[i]
        if sl is None:
            return
        bs = self.rc.block_size
        if sl.pos // bs <= sl.reg_blocks:
            return
        seq = list(sl.req.prompt) + list(sl.req.out)
        self.mgr.register_prefix(i, seq[: sl.pos], now=self.clock)
        sl.reg_blocks = sl.pos // bs

    def _pools(self) -> list[torch.Tensor]:
        """Every tensor leaf of the target pools and of the draft pool, int8
        scales included: each is (layers, num_pages + 1, block_size, ...),
        indexed by the same page ids."""
        out: list[torch.Tensor] = []

        def walk(t):
            if isinstance(t, dict):
                for v in t.values():
                    walk(v)
            elif isinstance(t, (tuple, list)):
                for v in t:
                    walk(v)
            elif isinstance(t, torch.Tensor):
                out.append(t)

        walk(self.caches)
        if self.spec is not None:
            walk(self.spec.caches)
        return out

    def _drain_cow(self) -> None:
        """Perform the page copies owed by copy-on-write resolutions queued
        since the last step, ``leaf[:, dst] = leaf[:, src]`` on every leaf of
        the target pools AND the draft pool (both are indexed by the same
        block tables, so a retabled page must exist in both). When no page
        is both a source and a destination of this drain, one
        ``index_select`` / ``index_copy_`` per leaf does them all; otherwise
        the pairs go one by one in queue order. The copies run on the
        pools' device, queued on its stream like the step after them. Must
        run before the step that writes into a copied destination page."""
        if self.mgr is None:
            return
        copies = self.mgr.drain_cow_copies()
        if not copies:
            return
        if self.mesh is not None:
            self._pool.call(("cow", self._eid, copies))     # every rank's pool shard
            return
        copy_pages(self._pools(), copies, self.device)

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
                if self.mgr is not None and not self.mgr.extend(i, sl.pos + 1):
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
            if self.mgr is not None and not self.mgr.extend(i, sl.pos + n):
                stalled += 1
                continue
            tokens[i, :n] = sl.prompt[sl.pos : sl.pos + n]
            lens[i] = n
            pbudget -= n
            prefill_rows.append(i)
        return tokens, pos, lens, decode_rows, prefill_rows, stalled

    def _tables(self) -> np.ndarray | None:
        """The host block tables (None on the dense layout): each step's
        staging copies them in with its other inputs; on a mesh every rank
        uploads them itself."""
        return None if self.mgr is None else self.mgr.tables

    def _emit(self, i: int, token: int) -> None:
        """Append a sampled token. A request's first token rides its prefill;
        any later one — the sample after a preemption's re-prefill too —
        counts as a decode token. TTFT and inter-token latencies are keyed
        by rid, so they survive preemption."""
        sl = self.slots[i]
        continuing = bool(sl.req.out)
        sl.req.out.append(token)
        sl.last_token = token
        self.generated_tokens += 1
        if sl.meter is not None:
            sl.meter.emitted_tokens += 1
            if continuing:
                sl.meter.decode_tokens += 1
        now = time.perf_counter()
        rid = sl.req.rid
        prev = self._t_emit.get(rid)
        if prev is not None:
            self._h_itl.labels(sl.req.priority).observe(now - prev)
        elif rid in self._t_submit:
            self._h_ttft.labels(sl.req.priority).observe(now - self._t_submit[rid])
        self._t_emit[rid] = now

    def _end_tick(self, ran: bool) -> bool:
        """Per-tick ladder/admission bookkeeping: relax toward healthy on a
        clean tick (the ladder ignores it if pressure was noted at this
        clock), close stall episodes, and (un)pause admissions at level 5."""
        if not self._stall_this_tick:
            self._in_stall = False
        self.ladder.note_clean(self.clock)
        self.admission.paused = self.ladder.level >= len(LADDER_LEVELS) - 1
        self.ladder.tick()
        return ran

    def tick(self) -> bool:
        """Plan + run one mixed step. Returns False when nothing ran.

        Advances the logical ``clock`` unconditionally. With a tracer, one
        ``tick`` span holds the phase spans of ``_tick_inner`` and the
        counter tracks follow it; the tick's wall time always goes to the
        ``serve_tick_seconds`` histogram."""
        t0 = time.perf_counter()
        tr = self.trace
        if tr.enabled:
            self._tick_energy_j = 0.0
            with tr.span("tick", args={"clock": self.clock + 1}):
                ran = self._tick_inner()
            wall = time.perf_counter() - t0
            self._emit_counter_tracks(wall)
        else:
            ran = self._tick_inner()
            wall = time.perf_counter() - t0
        self._h_tick.observe(wall)
        return ran

    def _tick_inner(self) -> bool:
        self.clock += 1
        self._fault_fired = False
        self._stall_this_tick = False
        tr = self.trace
        _pt = tr.ts()
        if self.faults is not None:
            self._apply_tick_faults()
        if self.admission.queue_pressure():
            # a bounded queue at its limit is the signal that can push the
            # ladder past preempt into shed/reject
            self.ladder.note_pressure(self.clock, "queue_full")
        if self.ladder.level >= 4:
            # level 4: shed queued work that cannot or should not run
            self.admission.shed_expired(self.clock)
            self.admission.shed_class("batch", self.clock)
        self._admit()
        if tr.enabled:
            now = tr.ts()
            tr.complete("admit", PID_SCHED, TID_TICK, _pt, now - _pt)
            _pt = now
        tokens, pos, lens, decode_rows, prefill_rows, stalled = self._plan()
        if stalled:
            self._note_stall(stalled)
        # pool pressure: nothing schedulable while slots are active means
        # every row's page allocation failed — preempt until one can proceed
        while not (decode_rows or prefill_rows) and self._preempt_one():
            tokens, pos, lens, decode_rows, prefill_rows, stalled = self._plan()
            if stalled:
                self._note_stall(stalled)
        scheduled = decode_rows + prefill_rows
        if tr.enabled:
            tr.complete("plan", PID_SCHED, TID_TICK, _pt, tr.ts() - _pt,
                        args={"decode_rows": len(decode_rows),
                              "prefill_rows": len(prefill_rows),
                              "stalled": stalled})
        if not scheduled:
            if any(s is not None for s in self.slots):
                if self._fault_fired:
                    # injected exhaustion on every schedulable row: idle the
                    # tick — the fault is keyed to this clock and passes
                    self.idle_fault_ticks += 1
                    return self._end_tick(True)
                self.engine_stalls += 1
                raise RuntimeError(
                    f"page pool cannot back a single active sequence "
                    f"({self.mgr.num_pages if self.mgr else 0} pages of "
                    f"{self.rc.block_size} tokens)")
            return self._end_tick(False)
        if self.spec is not None:
            return self._end_tick(
                self._spec_tick(tokens, pos, lens, decode_rows, prefill_rows))
        with tr.span("cow_drain"):
            self._drain_cow()
        tables = self._tables()
        # decode-only ticks run at width 1 instead of the full chunk width
        width = self.chunk if prefill_rows else 1

        # quarantined rows run through the fallback-policy step instead of
        # the (suspect) main step; everything else is unchanged
        fbset = {i for i in scheduled if self.slots[i].fallback}
        fb_np = None
        if fbset:
            with tr.span("fallback_step"):
                fb_np = self._run_fallback(tokens, pos, lens, tables, sorted(fbset), width)
            if fb_np is None:
                for i in sorted(fbset):
                    self._shed_slot(i, RejectReason.NUMERICAL_FAULT,
                                    "non-finite logits and no fallback step")
                decode_rows = [i for i in decode_rows if i not in fbset]
                prefill_rows = [i for i in prefill_rows if i not in fbset]
                scheduled = decode_rows + prefill_rows
                fbset = set()
                if not scheduled:
                    return self._end_tick(True)
        main_rows = [i for i in scheduled if i not in fbset]
        step_by_bits: dict = {}
        # writable host copy: fault injection + row merging mutate it
        logits_np = None if fb_np is None else fb_np.copy()
        _st = tr.ts()
        if main_rows:
            lens_main = lens.copy()
            for i in fbset:
                lens_main[i] = 0
            t0 = time.perf_counter()
            if self.mesh is not None:
                main_np, step_by_bits = self._mesh_main(tokens, pos, lens_main, width, tables)
            else:
                self.caches, logits, totals = self._step(
                    self.params, self.caches, tokens[:, :width], pos, lens_main, tables)
                if totals is not None:
                    step_by_bits, scalars = totals.host()
                    if totals.layout.names:
                        self.tick_dropped_tokens.append(scalars.get("moe.dropped_tokens", 0))
                # the host copy is the tick's one sync with the device
                main_np = logits.to(torch.float32).cpu().numpy()
            for b, d in step_by_bits.items():
                acc = self.cycles_by_bits.setdefault(
                    b, {"serial_cycles": 0, "parallel_cycles": 0})
                for k2, v2 in d.items():
                    acc[k2] += int(v2)
            self.tick_seconds.append(time.perf_counter() - t0)
            if logits_np is None:
                logits_np = main_np
            else:
                for i in main_rows:
                    logits_np[i] = main_np[i]
        self.ticks += 1
        n_prefill = sum(int(lens[i]) for i in prefill_rows)
        self.prefill_tokens_computed += n_prefill
        if n_prefill:
            self._c_sched_tokens.labels("prefill").inc(n_prefill)
        if decode_rows:
            self._c_sched_tokens.labels("decode").inc(len(decode_rows))
        if self.track_energy:
            self._note_step_energy(step_by_bits, bucket="target")
        if tr.enabled:
            # device_step ends at the host logits copy (the sync)
            _sdur = tr.ts() - _st
            tr.complete("device_step", PID_SCHED, TID_TICK, _st, _sdur, args={
                "rows": len(main_rows), "width": width,
                "tokens": int(sum(int(lens[i]) for i in scheduled))})
            for i in scheduled:
                sl = self.slots[i]
                tr.complete(
                    "prefill" if i in prefill_rows else "decode",
                    PID_REQUESTS, sl.req.rid, _st, _sdur,
                    args={"rid": sl.req.rid, "pos": int(pos[i]),
                          "tokens": int(lens[i]),
                          **({"path": "fallback"} if i in fbset else {})})
        _ct = tr.ts()

        # induced numerical faults corrupt main-step rows only (the fallback
        # step models the numerically safe path)
        if self.faults is not None:
            for ev in self.faults.at(self.clock, "nan_logits"):
                r = ev.arg % self.max_batch
                if r in main_rows:
                    logits_np[r] = np.nan
        bad = [i for i in scheduled if not np.isfinite(logits_np[i]).all()]
        for i in bad:
            if self.slots[i].fallback:
                # the numerically safe path itself is non-finite: terminal
                self._shed_slot(i, RejectReason.NUMERICAL_FAULT,
                                "non-finite logits at the fallback policy")
            else:
                self._quarantine(i)
        badset = set(bad)

        rids = [sl.req.rid if (sl := self.slots[i]) is not None else 0
                for i in range(self.max_batch)]
        toks = sample(logits_np, self.temperature, seed=self.seed, rids=rids,
                      positions=[int(pos[i]) + int(lens[i]) for i in range(self.max_batch)])

        total = float(sum(int(lens[i]) for i in main_rows)) or 1.0
        for i in scheduled:
            sl = self.slots[i]
            if sl is None:
                continue  # shed this tick (terminal numerical fault)
            if self.track_energy and sl.meter is not None and i not in fbset:
                # quarantined rows stay charged: wasted compute is real
                sl.meter.add_share(step_by_bits, int(lens[i]) / total)
            if i in badset:
                continue  # quarantined: the same position retries next tick
            was_decoding = not sl.prefilling
            sl.pos += int(lens[i])
            sl.retries = 0
            if was_decoding or not sl.prefilling:
                # decode rows and just-completed prefills both sampled a token
                self._emit(i, int(toks[i]))
                if len(sl.req.out) >= sl.req.max_new or sl.pos >= self.capacity - 1:
                    self._finish(i)
                    continue
            self._register_prefix(i)
        self._rr = (self._rr + 1) % self.max_batch
        if tr.enabled:
            tr.complete("commit", PID_SCHED, TID_TICK, _ct, tr.ts() - _ct)
        return self._end_tick(True)

    # ------------------------------------------------------ numerical guard
    def _quarantine(self, i: int) -> None:
        """Non-finite logits on row ``i``: roll the row back to its pre-tick
        state (pages freed via truncate, position unchanged, nothing
        emitted) and retry next tick. The first ``nan_retry_limit`` retries
        re-run the same policy — a transient fault clears bit-exactly (the
        sample at a position is keyed by (seed, rid, position)); a
        persistent one escalates to the ``rc.fallback_policy`` step
        (sticky). Overflow at int2/int4 is the fault this guard exists
        for."""
        sl = self.slots[i]
        self.nan_events += 1
        if self.mgr is not None:
            self.mgr.truncate(i, sl.pos)
        if self.spec is not None:
            # speculative state past the committed prefix is suspect too
            sl.draft_pos = min(sl.draft_pos, sl.pos)
            sl.draft_gap = []
            if not sl.draft_stale:
                sl.draft_stale = True
                self.draft_stale_events += 1
        sl.retries += 1
        if sl.retries > self.nan_retry_limit and not sl.fallback:
            sl.fallback = True
            self.fallback_retries += 1
        log.warning(kv(
            "nan_logits", rid=sl.req.rid, tick=self.clock, row=i,
            retries=sl.retries,
            action="fallback" if sl.fallback else "retry",
        ))
        if self.trace.enabled:
            self.trace.instant("nan_quarantine", PID_REQUESTS, sl.req.rid,
                               args={"rid": sl.req.rid, "row": i})

    def _fallback_rc(self) -> RunConfig:
        """The fallback step's RunConfig: ``rc.fallback_policy`` (default
        ``*=bf16``) with the legacy single-backend knobs cleared."""
        return dataclasses.replace(
            self.rc,
            quant_policy=self.rc.fallback_policy or "*=bf16",
            gemm_backend="bf16", gemm_mode="dynamic", quant_layers=(),
            spec_gamma=0, draft_policy=None,
        )

    def _run_fallback(self, tokens, pos, lens, tables, fb_rows, width):
        """One mixed step at ``rc.fallback_policy`` for the quarantined rows
        only (other rows masked to length 0), with the main step's
        ``impl``: attention on its kernel, each GEMM as the policy resolves
        it (``*=bf16``: ``torch.matmul``; a packed prequant leaf keeps its
        packed kernel). Returns last-column logits (B, V), or None when the
        policy does not resolve on these params (callers then shed with a
        structured NUMERICAL_FAULT). Only that resolution is guarded: an
        error from the step itself — a kernel launch or build failure —
        propagates."""
        if self._fb_unavailable:
            return None
        if self._fb_rc is None:
            rc_fb = self._fallback_rc()
            try:
                step_backend(self.cfg, rc_fb, self.params)
            except (ValueError, NotImplementedError) as e:
                log.error(kv("fallback_unavailable", tick=self.clock,
                             policy=self.rc.fallback_policy or "*=bf16",
                             error=repr(e)))
                self._fb_unavailable = True
                return None
            self._fb_rc = rc_fb
            if self.mesh is None:
                self._fb_step = self._runner(build_mixed_step(
                    self.cfg, rc_fb, impl=self.impl, scope="serve/fallback"), "fallback",
                    eager=True)
        lens_fb = np.zeros_like(lens)
        for i in fb_rows:
            lens_fb[i] = lens[i]
        if self.mesh is not None:
            # the ranks build their sharded fallback step on first use
            return self._mesh_logits(self._pool.call((
                "step", self._eid, "fallback", tokens[:, :width], pos, lens_fb, tables,
                self._fb_rc)))
        self.caches, logits, _ = self._fb_step(self.params, self.caches, tokens[:, :width],
                                               pos, lens_fb, tables)
        return logits.to(torch.float32).cpu().numpy()

    # ------------------------------------------------------------ spec tick
    def _spec_tick(self, tokens, pos, lens, decode_rows, prefill_rows) -> bool:
        """One speculative tick (DESIGN.md §9).

        Decode rows draft up to γ candidates against the low-bit draft view
        and draft pool (``serve.spec``), then ONE target step of width
        max(γ+1, chunk) verifies all γ+1 positions of every decode row while
        also running the tick's prefill chunks; rejected candidates roll
        back through ``BlockManager.truncate`` so they never leak KV.
        Prefill chunks are mirrored into the draft pool so a slot can draft
        as soon as it finishes prefilling.

        Every input of the draft steps and the verify step's tokens are
        built on the host and queued before the first of them launches (the
        other inputs of a step with the step), and the tick waits for the
        card once: the host copy after the mirror step. At
        temperature 0 that copy holds the verify step's per-column argmax,
        its per-column finiteness and the proposals, never the logits; the
        draft's and verify's logits come to the host only at temperature >
        0, where rejection sampling reads them."""
        from .spec import DraftRow, greedy_accept, rejection_accept

        spec, rows, dev = self.spec, self.max_batch, self.device
        tr = self.trace
        W = tokens.shape[1]

        # ---- stale-draft resync (one slot a tick, healthy ladder only):
        # re-ingest the committed tokens the draft pool is missing, one
        # chunk a tick, so a stale slot recovers drafting. Under pressure
        # it waits: a stale draft costs speed, not correctness.
        if self.ladder.level == 0:
            for i, sl in enumerate(self.slots):
                if sl is None or sl.prefilling or sl.fallback or not sl.draft_stale:
                    continue
                behind = sl.pos - sl.draft_pos
                if behind > 0:
                    seq = list(sl.req.prompt) + list(sl.req.out)
                    n = min(self.chunk, behind)
                    rt = np.zeros((rows, self.chunk), np.int32)
                    rp = np.zeros(rows, np.int32)
                    rl = np.zeros(rows, np.int32)
                    rt[i, :n] = seq[sl.draft_pos: sl.draft_pos + n]
                    rp[i] = sl.draft_pos
                    rl[i] = n
                    totals = spec.mirror_prefill(rt, rp, rl, self._tables())
                    by_bits = totals.host()[0] if totals is not None else {}
                    if by_bits and sl.meter is not None:
                        sl.meter.add_share(by_bits, 1.0, bucket="draft")
                    sl.draft_pos += n
                if sl.draft_pos >= sl.pos:
                    sl.draft_stale = False
                    sl.draft_gap = []
                    self.draft_resyncs += 1
                break

        # per-row candidate budget: never past max_new or capacity, γ capped
        # by the ladder (degrading γ is its rung 1), and γ degraded (not the
        # row stalled) when the pool cannot back the γ+1 verify writes
        gcap = self.ladder.gamma_cap(spec.gamma)
        g: dict[int, int] = {}
        draft_rows: list[DraftRow] = []
        for i in decode_rows:
            sl = self.slots[i]
            remaining = sl.req.max_new - len(sl.req.out)
            gi = max(0, min(gcap, remaining - 1, self.capacity - 2 - sl.pos))
            if sl.draft_stale or sl.fallback:
                gi = 0
            while gi > 0 and self.mgr is not None and not self.mgr.extend(i, sl.pos + gi + 1):
                gi -= 1
            g[i] = gi
            if gi > 0:
                draft_rows.append(DraftRow(
                    row=i, rid=sl.req.rid, pos=sl.pos, draft_pos=sl.draft_pos,
                    gap=list(sl.draft_gap), last_token=sl.last_token, g=gi))
        # resolve copy-on-write before anything (draft or verify) writes into
        # this tick's pages: covers _plan's extends and the γ extends above
        with tr.span("cow_drain"):
            self._drain_cow()
        tables = self._tables()

        # quarantined rows run the fallback-policy step instead (masked out
        # of the draft and verify steps); an unavailable fallback sheds them
        fbset = {i for i in decode_rows + prefill_rows if self.slots[i].fallback}
        fb_np = None
        if fbset:
            fbw = W if any(i in fbset for i in prefill_rows) else 1
            with tr.span("fallback_step"):
                fb_np = self._run_fallback(tokens, pos, lens, tables, sorted(fbset), fbw)
            if fb_np is None:
                for i in sorted(fbset):
                    self._shed_slot(i, RejectReason.NUMERICAL_FAULT,
                                    "non-finite logits and no fallback step")
                decode_rows = [i for i in decode_rows if i not in fbset]
                prefill_rows = [i for i in prefill_rows if i not in fbset]
                fbset = set()
                if not (decode_rows or prefill_rows):
                    return True

        # ---- the verify and mirror steps' inputs, queued before any launch
        Wv = max(spec.gamma + 1, W if prefill_rows else 0)
        vt = np.zeros((rows, Wv), np.int32)
        vlens = np.zeros(rows, np.int32)
        vmask = np.zeros((rows, spec.gamma), bool)     # columns 1.. that take a proposal
        for i in prefill_rows:
            if i in fbset:
                continue          # runs through the fallback step instead
            vt[i, : int(lens[i])] = tokens[i, : int(lens[i])]
            vlens[i] = lens[i]
        for i in decode_rows:
            if i in fbset:
                continue
            vt[i, 0] = self.slots[i].last_token
            vlens[i] = g[i] + 1
            vmask[i, : g[i]] = True
        vt_d = upload(vt, dev)
        main_prefill = [i for i in prefill_rows if i not in fbset]
        if main_prefill:
            mlens = lens.copy()
            for i in decode_rows:
                mlens[i] = 0
            for i in fbset:
                mlens[i] = 0      # fallback rows' drafts are stale anyway
            mirror_args = (tokens[:, :W], pos, mlens)

        # ---- draft phase: γ sequential low-bit steps over the draft rows
        _st = tr.ts()
        t0 = time.perf_counter()
        props_d, qlogits, draft_events = None, [], []
        if draft_rows:
            props_d, qlogits, draft_events = spec.draft(
                draft_rows, tables, self.temperature, self.seed)
            gmax = props_d.shape[1]
            vmask_d = upload(vmask[:, :gmax], dev)
            vt_d[:, 1: 1 + gmax] = torch.where(vmask_d, props_d, vt_d[:, 1: 1 + gmax])
            if tr.enabled:
                _ddur = tr.ts() - _st
                n_drafted = sum(r.g for r in draft_rows)
                tr.complete("draft", PID_SCHED, TID_TICK, _st, _ddur, args={
                    "rows": len(draft_rows), "drafted": n_drafted})
                for r in draft_rows:
                    tr.complete("draft", PID_REQUESTS, r.rid, _st, _ddur,
                                args={"rid": r.rid, "pos": r.pos, "gamma": r.g})

        # ---- verify + prefill: one target step, every column's logits kept
        _st = tr.ts()
        self.caches, logits, vtot = self._vstep(self.params, self.caches, vt_d, pos, vlens,
                                                tables)
        # what the tick reads of the verify step's logits, taken before the
        # mirror step replays: a graph captured before the verify step's
        # may keep its temporaries where the verify graph keeps its logits
        # (one memory pool, serve/graphs.py)
        if self.temperature <= 0.0:
            parts = [logits.argmax(dim=-1).to(torch.int32),
                     torch.isfinite(logits).all(dim=-1).to(torch.int32)]
            if props_d is not None:
                parts.append(props_d)
            reads = torch.cat(parts, dim=1)
        else:
            reads = logits.to(torch.float32, copy=True)                   # (B, Wv, V)
        # ---- mirror prefill chunks into the draft pool
        m_tot = None
        if main_prefill:
            with tr.span("mirror"):
                m_tot = spec.mirror_prefill(*mirror_args, tables)
        # the tick's one wait for the card
        if self.temperature <= 0.0:
            host = reads.cpu().numpy()
            argmax, finite = host[:, :Wv], host[:, Wv: 2 * Wv].astype(bool)
            props_np = host[:, 2 * Wv:]
            logits_np = None
        else:
            logits_np = reads.cpu().numpy()
            finite = np.isfinite(logits_np).all(axis=-1)
            props_np = props_d.cpu().numpy() if props_d is not None else None
        self.tick_seconds.append(time.perf_counter() - t0)
        proposals = {r.row: [int(t) for t in props_np[r.row, : r.g]] for r in draft_rows}

        # ---- accounting, in the reference's order: draft, verify, mirror
        for ev_tot, weights in draft_events:
            by_bits = ev_tot.host()[0]
            if not by_bits:
                continue
            for i, w in weights.items():
                sl = self.slots[i]
                if sl is not None and sl.meter is not None:
                    sl.meter.add_share(by_bits, w, bucket="draft")
            self._note_step_energy(by_bits, bucket="draft")
        n_drafted = 0
        for r in draft_rows:
            sl = self.slots[r.row]
            # the draft ingested [gap..., last, d_1..d_{g-1}]: its pool now
            # covers sequence positions < pos + g
            sl.draft_pos = r.pos + r.g
            sl.draft_gap = []
            self.drafted_tokens += r.g
            n_drafted += r.g
            if sl.meter is not None:
                sl.meter.drafted_tokens += r.g
        if draft_rows:
            self._c_sched_tokens.labels("draft").inc(n_drafted)
        step_by_bits: dict = {}
        if vtot is not None:
            step_by_bits, scalars = vtot.host()
            if vtot.layout.names:
                self.tick_dropped_tokens.append(scalars.get("moe.dropped_tokens", 0))
            self._note_step_energy(step_by_bits, bucket="target")
        self.ticks += 1
        n_prefill = sum(int(lens[i]) for i in prefill_rows)
        self.prefill_tokens_computed += n_prefill
        if n_prefill:
            self._c_sched_tokens.labels("prefill").inc(n_prefill)
        if decode_rows:
            self._c_sched_tokens.labels("decode").inc(len(decode_rows))
        scheduled = decode_rows + prefill_rows
        total = float(sum(int(vlens[i]) for i in scheduled)) or 1.0
        if self.track_energy:
            for i in scheduled:
                sl = self.slots[i]
                if sl.meter is not None and i not in fbset:
                    sl.meter.add_share(step_by_bits, int(vlens[i]) / total)
        if main_prefill:
            m_by_bits = m_tot.host()[0] if m_tot is not None else {}
            if m_by_bits and self.track_energy:
                self._note_step_energy(m_by_bits, bucket="draft")
            m_total = float(sum(int(lens[i]) for i in main_prefill)) or 1.0
            for i in main_prefill:
                sl = self.slots[i]
                if m_by_bits and sl.meter is not None:
                    sl.meter.add_share(m_by_bits, int(lens[i]) / m_total, bucket="draft")
                sl.draft_pos = int(pos[i]) + int(lens[i])
        if tr.enabled:
            # device_step ends at the host copy (the sync); it includes the
            # mirror step, queued behind the verify step
            _sdur = tr.ts() - _st
            tr.complete("device_step", PID_SCHED, TID_TICK, _st, _sdur, args={
                "rows": len(scheduled), "width": int(Wv), "kind": "verify"})
            for i in scheduled:
                sl = self.slots[i]
                if sl is None:
                    continue
                tr.complete(
                    "prefill" if i in prefill_rows else "verify",
                    PID_REQUESTS, sl.req.rid, _st, _sdur,
                    args={"rid": sl.req.rid, "pos": int(pos[i]),
                          "tokens": int(vlens[i]),
                          **({"path": "fallback"} if i in fbset else {})})
        _ct = tr.ts()

        # ---- numerical-fault guard (injection, then detection)
        if self.faults is not None:
            for ev in self.faults.at(self.clock, "nan_logits"):
                r = ev.arg % rows
                if r in scheduled and r not in fbset:
                    finite[r] = False
                    if logits_np is not None:
                        logits_np[r] = np.nan
        bad = []
        for i in scheduled:
            ok = (np.isfinite(fb_np[i]).all() if i in fbset
                  else finite[i, : max(int(vlens[i]), 1)].all())
            if not ok:
                bad.append(i)
        for i in bad:
            if i in fbset:
                # the numerically safe path itself is non-finite: terminal
                self._shed_slot(i, RejectReason.NUMERICAL_FAULT,
                                "non-finite logits at the fallback policy")
            else:
                self._quarantine(i)
        badset = set(bad)
        decode_rows = [i for i in decode_rows if i not in badset]
        prefill_rows = [i for i in prefill_rows if i not in badset]
        fbset -= badset

        # ---- acceptance + emission
        for i in decode_rows:
            if i in fbset:
                continue          # emitted from the fallback logits below
            sl = self.slots[i]
            if self.temperature <= 0.0:
                n_acc, emitted = greedy_accept(proposals.get(i, []), argmax[i])
            else:
                q_rows = (np.stack([qlogits[j][i] for j in range(g[i])]) if g[i]
                          else np.zeros((0, logits_np.shape[-1]), np.float32))
                n_acc, emitted = rejection_accept(
                    self.seed, sl.req.rid, sl.pos, proposals.get(i, []),
                    logits_np[i, : g[i] + 1], q_rows, self.temperature)
            self.accepted_draft_tokens += n_acc
            if sl.meter is not None:
                sl.meter.accepted_draft_tokens += n_acc
            # rollback: keep only the accepted prefix's KV in both pools
            new_len = sl.pos + n_acc + 1
            if self.mgr is not None:
                self.mgr.truncate(i, new_len)
            sl.pos = new_len
            sl.retries = 0
            if g[i] == 0:
                # a plain-decode tick for this row: the draft never saw the
                # old last token — queue it for the next catch-up step
                if not sl.draft_stale:
                    sl.draft_gap.append(sl.last_token)
                    if len(sl.draft_gap) > spec.gamma:
                        sl.draft_stale = True
                        sl.draft_gap = []
            elif sl.draft_pos >= new_len:
                # a candidate was rejected: the draft KV past the accepted
                # prefix is dead too (position new_len-1, whose input is the
                # last accepted token, stays valid)
                sl.draft_pos = new_len
            else:
                # all γ accepted: the draft never ingested d_γ — carry it as
                # catch-up for the next tick's first draft step
                sl.draft_gap = [int(emitted[-2])]
            for t in emitted:
                self._emit(i, int(t))
            if len(sl.req.out) >= sl.req.max_new or sl.pos >= self.capacity - 1:
                self._finish(i)
            else:
                self._register_prefix(i)

        def draw(i: int, row_logits) -> int:
            """Row ``i``'s completion sample from ``row_logits`` (None: the
            verify step's argmax at column lens-1): argmax at temperature 0,
            else the STREAM_SAMPLE draw at the row's next position."""
            if row_logits is None:
                return int(argmax[i, int(lens[i]) - 1])
            if self.temperature <= 0.0:
                return int(np.argmax(row_logits))
            return int(sample(row_logits[None], self.temperature, seed=self.seed,
                              rids=[self.slots[i].req.rid],
                              positions=[int(pos[i]) + int(lens[i])])[0])

        # prefill rows: plain chunk bookkeeping + completion sampling from the
        # verify step's per-position logits (column lens-1)
        for i in prefill_rows:
            if i in fbset:
                continue          # emitted from the fallback logits below
            sl = self.slots[i]
            sl.pos += int(lens[i])
            sl.retries = 0
            if not sl.prefilling:
                self._emit(i, draw(i, None if logits_np is None
                                   else logits_np[i, int(lens[i]) - 1]))
                if len(sl.req.out) >= sl.req.max_new or sl.pos >= self.capacity - 1:
                    self._finish(i)
                    continue
            self._register_prefix(i)
        # quarantined rows: a plain (γ=0) commit from the fallback step's
        # last-column logits — decode rows advance one token, prefill rows
        # their chunk
        for i in sorted(fbset):
            sl = self.slots[i]
            was_decoding = not sl.prefilling
            sl.pos += int(lens[i])
            sl.retries = 0
            if was_decoding or not sl.prefilling:
                self._emit(i, draw(i, fb_np[i]))
                if len(sl.req.out) >= sl.req.max_new or sl.pos >= self.capacity - 1:
                    self._finish(i)
                    continue
            self._register_prefix(i)
        self._rr = (self._rr + 1) % self.max_batch
        if tr.enabled:
            tr.complete("commit", PID_SCHED, TID_TICK, _ct, tr.ts() - _ct)
        return True

    def run(self, max_ticks: int = 100_000) -> list[Request]:
        """Drain the queue and all active slots; returns finished requests.

        Under :meth:`begin_drain` only active (and previously admitted,
        preempted) work runs; everything still queued afterwards is rejected
        with SHUTTING_DOWN — no request ends without a terminal state."""
        ticks = 0
        while ticks < max_ticks:
            pending = self.admission.pending(admitted_only=self.draining)
            if not pending and not any(s is not None for s in self.slots):
                break
            if not self.tick() and not pending:
                break
            ticks += 1
        if self.draining:
            n = self.admission.flush_pending(RejectReason.SHUTTING_DOWN, self.clock)
            if n:
                log.info(kv("drain_flush", tick=self.clock, flushed=n))
        return self.finished

    # -------------------------------------------------------------- health
    def health(self) -> dict:
        """Robustness snapshot (DESIGN.md §10): ladder state and
        transitions, per-class queue depths, pool occupancy, and every
        shed / preempt / stall / fault counter, with the reference's keys.

        ``kernels`` holds the kernel wrappers' launch and plain-call counts
        and the per-call-site path counts (``kernels/ops.py``) accumulated
        since this engine was built. ``latency`` summarizes the wall-clock
        histograms (seconds): TTFT, inter-token and tick percentiles over
        every priority class. ``sharding`` reads the mesh context that was
        active when this engine was built (its dropped rules and the dims
        its model body's ``constrain`` sites replicated; on the rank pool
        those of the controller's meta steps, :meth:`_account_sharding`), or
        the reference's empty block without one."""
        mgr = self.mgr

        def _pct(h):
            return {"count": sum(c.count for c in h.children.values()),
                    **{f"p{p}": round(_family_percentile(h, p), 6)
                       for p in (50, 95, 99)}}

        return {
            "kernels": _kops.kernel_counters_since(self._kernel_base),
            "latency": {"ttft_s": _pct(self._h_ttft),
                        "itl_s": _pct(self._h_itl),
                        "tick_s": _pct(self._h_tick)},
            "clock": self.clock,
            "ticks": self.ticks,
            "draining": self.draining,
            "ladder": self.ladder.snapshot(),
            "active_slots": sum(1 for s in self.slots if s is not None),
            "max_batch": self.max_batch,
            "queue_depths": self.admission.depths(),
            "queued": self.admission.pending(),
            "submitted": self.admission.submitted,
            "admitted": self.admission.admitted,
            "completed": len(self.finished),
            "rejections": self.admission.rejections_by_reason(),
            "sheds": self.admission.sheds,
            "preemptions": self.preemptions,
            "deadline_misses": self.deadline_misses,
            "pool": ({
                "pages": mgr.num_pages,
                "in_use": mgr.pages_in_use,
                "high_water": mgr.high_water,
                "live_pages": mgr.live_pages,
                "live_high_water": mgr.live_high_water,
                "occupancy": mgr.pages_in_use / max(mgr.num_pages, 1),
                "injected_alloc_failures": mgr.injected_failures,
            } if mgr is not None else {"layout": "dense"}),
            "prefix_cache": ({
                "enabled": True,
                "hits": self.prefix_hits,
                "tokens_reused": self.prefix_tokens_reused,
                "prefill_tokens_computed": self.prefill_tokens_computed,
                "cached_pages": mgr.cached_pages,
                "indexed_pages": len(mgr.prefix),
                "evictions": mgr.prefix.evictions,
                "cow_events": mgr.cow_events,
            } if mgr is not None and mgr.prefix is not None
                else {"enabled": False,
                      "prefill_tokens_computed": self.prefill_tokens_computed}),
            "sharding": sharding_report(self._shard_ctx),
            "mesh": ({
                "dp": self.mesh.dp,
                "tp": self.mesh.tp,
                "devices": self.mesh.devices,
                "backend": self._pool.backend,
                "moe_dropped_tokens": self.moe_dropped_tokens,
                "comms": self.comms_summary(),
                "rank_step_s": self._rank_seconds[:, 0].tolist(),
                "rank_collective_s": self._rank_seconds[:, 1].tolist(),
            } if self.mesh is not None else {"enabled": False}),
            "stalled_rows_total": self.stalled_rows_total,
            "stall_episodes": self.stall_episodes,
            "engine_stalls": self.engine_stalls,
            "idle_fault_ticks": self.idle_fault_ticks,
            "nan_events": self.nan_events,
            "fallback_retries": self.fallback_retries,
            "draft_stale_events": self.draft_stale_events,
            "draft_resyncs": self.draft_resyncs,
        }

    # ---------------------------------------------------------------- mesh
    def _mesh_logits(self, res: list) -> np.ndarray:
        """The step's (B, V) logits from tp rank 0 of each dp group (and
        each rank's seconds into ``_rank_seconds``)."""
        self._rank_seconds += np.array([r["seconds"] for r in res])
        tp = self.mesh.tp
        return np.concatenate([res[d * tp]["logits"] for d in range(self.mesh.dp)])

    def _account_sharding(self, width: int) -> None:
        """The ``constrain`` accounting of a step of ``width`` on the rank
        pool. A rank holds slices of each activation, so its ``constrain``
        sites count nothing (``parallel.sharding.constrain``); under an
        active context that splits, the controller runs the single-device
        mixed step once a width on ``meta`` tensors, whose sites count what
        one process's steps of that width count. The fallback step's sites
        and shapes are the main step's, and add nothing."""
        ctx = sharding_ctx()
        if ctx is None or not ctx.splits or self._accounted.get(width) is ctx:
            return
        self._accounted[width] = ctx
        from ..models.model import abstract_params
        from ..quant import apply_surgery

        cfg, rc, B = self.cfg, self.rc, self.max_batch
        params = apply_surgery(cfg, rc, abstract_params(cfg, rc))
        caches = init_caches(cfg, rc, B, self.capacity,
                             num_pages=None if self.mgr is None else self.mgr.num_pages,
                             device="meta")
        rows = torch.empty((B,), dtype=torch.int32, device="meta")
        tables = None if self.mgr is None else torch.empty(
            self.mgr.tables.shape, dtype=torch.int32, device="meta")
        with _kops.quiet_records():
            build_mixed_step(cfg, rc, impl=self.impl)(
                params, caches, torch.empty((B, width), dtype=torch.int32, device="meta"),
                rows, rows, tables)

    def _mesh_main(self, tokens, pos, lens, width, tables):
        """One main step on every rank: (logits (B, V), the merged cycle
        totals by bits). The MoE drops count every tick, energy tracking or
        not; the collectives' bytes go to ``comms``."""
        self._account_sharding(width)
        res = self._pool.call(("step", self._eid, "main", tokens[:, :width], pos, lens, tables,
                               None))
        self.caches = self._pool.engine.caches
        step = self._mesh_step
        raw = step.stack_raw(self._pool.engine.capture, [r["stats"] for r in res])
        self.moe_dropped_tokens += step.moe_drops(raw)
        self._accum_comms(res[0]["meter"])
        by_bits: dict = {}
        if self.track_energy:
            merged = step.merge_stats(raw)
            by_bits = tree_totals_by_bits(merged)
            self._accum_device_load(step.device_serial_by_bits(raw))
            if merged.scalars:
                self.tick_dropped_tokens.append(
                    scalar_totals(merged).get("moe.dropped_tokens", 0))
        return self._mesh_logits(res), by_bits

    def _accum_comms(self, snap: dict) -> None:
        """Fold one step's collective meter into the running totals."""
        for key, r in snap.items():
            acc = self.comms.setdefault(key, {k: 0 for k in r})
            for k, v in r.items():
                acc[k] += v

    def _accum_device_load(self, dev: dict) -> None:
        for bits, m in dev.items():
            acc = self._device_weight.get(bits)
            self._device_weight[bits] = m if acc is None else acc + m

    def comms_summary(self) -> dict:
        """Interconnect rollup: {bits: {calls, elems, payload_bytes,
        scale_bytes, bf16_bytes}} over every collective so far, plus the
        grand totals ``core.report`` prices as interconnect energy."""
        by_bits: dict = {}
        for (_, bits), r in self.comms.items():
            acc = by_bits.setdefault(int(bits), {"calls": 0, "elems": 0, "payload_bytes": 0,
                                                 "scale_bytes": 0, "bf16_bytes": 0})
            for k, v in r.items():
                acc[k] += v
        total = sum(r["payload_bytes"] + r["scale_bytes"] for r in by_bits.values())
        bf16 = sum(r["bf16_bytes"] for r in by_bits.values())
        return {"by_bits": by_bits, "bytes_moved": total, "bf16_bytes": bf16}

    def interconnect_report(self) -> dict:
        """``core.report``'s interconnect column over ``comms_summary()``:
        {"by_bits": {bits: {bytes_moved, bf16_bytes, energy_j}},
        "energy_j": total}."""
        from ..core.report import energy_report

        rep = energy_report([], comms=self.comms_summary())
        return {"by_bits": rep.interconnect, "energy_j": rep.interconnect_energy_j}

    def device_attribution(self) -> dict:
        """Each rank's share of the cycle totals: {bits: (dp, tp) int64},
        split in proportion to each rank's own executed serial cycles and
        summing exactly to ``cycles_by_bits``. Needs a mesh and
        ``track_energy``."""
        if self.mesh is None:
            raise ValueError("device_attribution() needs a mesh scheduler")
        from ..parallel.serve_mesh import ShardedStep

        out = {}
        for bits, acc in self.cycles_by_bits.items():
            w = self._device_weight.get(bits)
            if w is None:
                w = np.ones((self.mesh.dp, self.mesh.tp), np.int64)
            shares = ShardedStep.split_exact(acc["serial_cycles"], w.reshape(-1))
            out[bits] = shares.reshape(self.mesh.dp, self.mesh.tp)
        return out

    def rank_kernel_counts(self) -> list:
        """``ops.kernel_counts()`` of every rank of the mesh, by rank."""
        return self._pool.counts()

    def reset_rank_counts(self) -> None:
        """Zero the kernel counters of every rank of the mesh."""
        self._pool.reset_counts()

    def close(self) -> None:
        """Free the ranks' shards of this mesh Scheduler (the rank pool
        stays up for the next one). A no-op on one device."""
        if self._pool is not None and not self._pool.closed and self._pool.me.eid == self._eid:
            self._pool.call(("detach", self._eid))

    # -------------------------------------------------------------- energy
    def energy_summary(self, variant: str = "serial") -> list[dict]:
        """Per-request {rid, tokens, cycles, cycles_by_bits, latency_s,
        energy_j} — finished requests first, then in-flight slots.
        Requires ``track_energy=True``."""
        active = [s.meter for s in self.slots if s is not None and s.meter is not None]
        return [m.energy(variant) for m in self.finished_meters + active]

    def spec_summary(self, variant: str = "serial") -> dict:
        """Speculative-decoding rollup: acceptance rate, the draft-vs-verify
        energy split and energy per accepted token (``core.report``). The
        energy fields need ``track_energy=True``; the token counters are
        always live."""
        from ..core.report import spec_energy_summary

        out = spec_energy_summary(self.energy_summary(variant))
        out.update(
            spec_gamma=self.spec.gamma if self.spec is not None else 0,
            draft_policy=self.spec.describe_draft() if self.spec is not None else None,
            ticks=self.ticks,
            drafted_tokens=self.drafted_tokens,
            accepted_draft_tokens=self.accepted_draft_tokens,
            acceptance_rate=(self.accepted_draft_tokens / self.drafted_tokens
                             if self.drafted_tokens else 0.0),
        )
        return out

    # --------------------------------------------------------------- stats
    def cache_stats(self) -> dict:
        """Live-vs-reserved cache accounting (the draft pool included: one
        BlockManager, so one page high-water, backs both pools). The dense
        layout reserves ``max_batch * capacity`` tokens whatever the load."""
        total = self._mesh_cache_bytes if self.mesh is not None else cache_bytes(self.caches)
        if self.spec is not None:
            total += cache_bytes(self.spec.caches)
        if self.mgr is None:
            return {"layout": "dense",
                    "reserved_tokens": dense_cache_tokens(self.max_batch, self.capacity),
                    "cache_bytes_reserved": total, "cache_bytes_high_water": total}
        frac = self.mgr.high_water / max(self.mgr.num_pages, 1)
        out = {
            "layout": "paged",
            "pool_pages": self.mgr.num_pages,
            "high_water_pages": self.mgr.high_water,
            "live_high_water_pages": self.mgr.live_high_water,
            "cache_bytes_reserved": total,
            "cache_bytes_high_water": int(total * frac),
        }
        if self.mgr.prefix is not None:
            out.update(
                prefix_hits=self.prefix_hits,
                prefix_tokens_reused=self.prefix_tokens_reused,
                prefill_tokens_computed=self.prefill_tokens_computed,
                prefix_cached_pages=self.mgr.cached_pages,
                prefix_evictions=self.mgr.prefix.evictions,
                cow_events=self.mgr.cow_events,
            )
        return out


# Registry-backed views over the counter attributes (see _SCHED_COUNTERS),
# installed on the class so ``self.ticks += 1`` routes through the setter.
for _a in _SCHED_COUNTERS:
    setattr(Scheduler, _a, _counter_property(_a))
del _a


def install_sigint_drain(sched: Scheduler):
    """Graceful shutdown: the first SIGINT begins a drain — active slots
    finish, queued work is rejected with structured SHUTTING_DOWN, SlotMeter
    energy summaries survive for the final flush; a second SIGINT restores
    the previous handler and raises KeyboardInterrupt (hard abort). Returns
    a zero-arg callable that restores the previous handler."""
    import signal

    prev = signal.getsignal(signal.SIGINT)

    def _handler(signum, frame):
        if sched.draining:
            signal.signal(signal.SIGINT, prev)
            raise KeyboardInterrupt
        log.warning(kv(
            "sigint_drain", tick=sched.clock,
            active=sum(1 for s in sched.slots if s is not None),
            queued=sched.admission.pending(),
            hint="^C again to abort",
        ))
        sched.begin_drain()

    signal.signal(signal.SIGINT, _handler)

    def restore():
        signal.signal(signal.SIGINT, prev)

    return restore
