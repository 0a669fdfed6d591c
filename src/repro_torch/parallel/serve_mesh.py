"""Sharded serving: the Scheduler's one mixed step over a (dp, tp) process
mesh (the reference's ``repro/parallel/serve_mesh.py`` on
``torch.distributed``).

The reference ``shard_map``s the step over a device mesh in one process.
The port runs one process a rank (``launch/mesh.py``); each rank holds its
shard of the weights and caches and runs :class:`ShardedStep`, the same
mixed step on its rows and heads, with the collectives of
``parallel.collectives`` inside the unmodified model body. Layout:

- **dp** shards the batch: rank (d, t) runs rows ``[d·B/dp, (d+1)·B/dp)``.
  The step's inputs arrive whole and each rank slices its rows.
- **tp** shards attention by head group (GQA: Q and KV heads together;
  MLA: the absorbed-Q heads, the latent has no head axis and replicates),
  the dense FFN's columns, and the MoE experts (expert parallelism). The
  paged pool is head-sharded over tp and replicated over dp: pages are
  shared by rows, so every rank writes every row's tokens, the dp row
  gather shipping the *already quantized* int8 planes.
- The **gathered** GEMMs' weights (o-proj, down-proj) stay replicated:
  their inputs are tp-sharded features, re-assembled by the
  quantize-before-all-gather collectives.

Bit-exactness (the gate): every scale is the mesh-global amax (a MAX
``all_reduce`` of local amaxes), gathered integer planes equal the
single-device quantization of the full row, the expert combine gathers at
full precision, the attention kernel takes the single-device launch's split
plan, and the tuGEMM statistics merge by max (non-expert: ``max_a ·
max(max_b, 1)`` factorizes over the device grid) or dp-max + tp-concat
(expert-parallel GEMMs), with serial / parallel totals recomputed from the
merged step cycles. Greedy tokens and cycle totals are the single-device
run's.

The allocator (``BlockManager``) stays in one place: rank 0's Scheduler
plans every tick and sends each rank the step's inputs
(``launch/mesh.py``); no replica can diverge on a clock, a TTL or a fault
plan.

The partition rules are the reference's ``_param_pspec`` / ``_cache_pspec``;
here they slice a full tree to rank (d, t)'s part (``shard_params``,
``shard_caches``) or keep each leaf's part as ``models.init`` draws it
(``InitShards``: a rank never holds the whole tree).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..configs.base import ModelConfig, RunConfig
from ..core.tugemm import TuGemmStats
from ..quant import capture as stats_capture
from . import collectives as dist

__all__ = [
    "MeshSpec",
    "as_spec",
    "validate",
    "local_config",
    "param_pspecs",
    "cache_pspecs",
    "shard_params",
    "shard_caches",
    "TreeShard",
    "InitShards",
    "RankCoords",
    "ShardedStep",
    "build_sharded_step",
    "RankEngine",
    "GATHER_GEMMS",
    "EXPERT_GEMMS",
    "COL_OUT_GEMMS",
]

# GEMMs whose input features are tp-sharded (the upstream GEMM was
# column-parallel): these run quantize-before-all-gather
GATHER_GEMMS = frozenset({"attn.o", "mla.o", "mlp.down"})
# expert-parallel GEMMs: stats merge by dp-max + tp-concat over experts
EXPERT_GEMMS = frozenset({"moe.gate", "moe.up", "moe.down"})
# column-parallel GEMMs: their N in the merged record is N_local · tp
COL_OUT_GEMMS = frozenset({"attn.q", "attn.k", "attn.v", "mla.q", "mlp.gate", "mlp.up"})


@dataclass(frozen=True)
class MeshSpec:
    """A (dp, tp) serving mesh request."""

    dp: int = 1
    tp: int = 1
    dp_axis: str = "data"
    tp_axis: str = "model"

    @property
    def devices(self) -> int:
        return self.dp * self.tp


def as_spec(mesh) -> MeshSpec:
    """Coerce a MeshSpec | (dp, tp) | "dp,tp" into a MeshSpec."""
    if isinstance(mesh, MeshSpec):
        return mesh
    if isinstance(mesh, str):
        parts = [int(v) for v in mesh.split(",")]
        if len(parts) != 2:
            raise ValueError(f"--mesh wants 'dp,tp', got {mesh!r}")
        return MeshSpec(parts[0], parts[1])
    if isinstance(mesh, (tuple, list)) and len(mesh) == 2:
        return MeshSpec(int(mesh[0]), int(mesh[1]))
    raise TypeError(f"cannot interpret mesh spec {mesh!r}")


def validate(cfg: ModelConfig, rc: RunConfig, spec: MeshSpec, max_batch: int,
             world: int | None = None) -> None:
    """Fail loudly on any divisibility the sharded layout relies on: a
    gather over features that were never sharded would be wrong, not slow.
    ``world`` is the number of ranks the caller can start (default: as
    many as the mesh wants)."""
    n = spec.devices if world is None else world
    if spec.devices > n:
        raise ValueError(f"mesh {spec.dp}x{spec.tp} wants {spec.devices} devices, "
                         f"only {n} available (start dp*tp ranks, e.g. --devices "
                         f"{spec.devices} on the CPU)")
    if max_batch % spec.dp != 0:
        raise ValueError(f"max_batch {max_batch} not divisible by dp={spec.dp}")
    if spec.tp > 1:
        if cfg.attn_type == "gqa":
            if cfg.num_heads % spec.tp or cfg.num_kv_heads % spec.tp:
                raise ValueError(
                    f"tp={spec.tp} must divide num_heads={cfg.num_heads} and "
                    f"num_kv_heads={cfg.num_kv_heads} (head-group KV sharding)")
        elif cfg.attn_type == "mla":
            if cfg.num_heads % spec.tp:
                raise ValueError(f"tp={spec.tp} must divide num_heads={cfg.num_heads}")
        has_dense_ffn = any(not cfg.is_moe_layer(i) for i in range(cfg.num_layers))
        if has_dense_ffn and cfg.d_ff % spec.tp:
            raise ValueError(f"tp={spec.tp} must divide d_ff={cfg.d_ff}")
        if cfg.num_experts and cfg.num_experts % spec.tp:
            raise ValueError(f"tp={spec.tp} must divide num_experts={cfg.num_experts}")


def local_config(cfg: ModelConfig, spec: MeshSpec) -> ModelConfig:
    """One rank's model view: head counts divided by tp, ``head_dim``
    pinned to the global value. The expert count stays global: the router
    and dispatch see every expert; only the expert stacks are sharded."""
    if spec.tp == 1:
        return cfg
    if cfg.attn_type == "gqa":
        return cfg.replace(num_heads=cfg.num_heads // spec.tp,
                           num_kv_heads=cfg.num_kv_heads // spec.tp,
                           head_dim=cfg.resolved_head_dim)
    if cfg.attn_type == "mla":
        return cfg.replace(num_heads=cfg.num_heads // spec.tp)
    return cfg


# ------------------------------------------------------------ partition rules
def _param_axis(spec: MeshSpec, keys: tuple, shape: tuple) -> int | None:
    """The axis of one param leaf sharded over tp (None: replicated), by
    its path in the model tree:

    - column-parallel first GEMMs (wq/wk/wv, MLA wq, MLP gate/up): the
      output (last) axis, of kernel, qkernel, qscale and bias alike;
    - MLA's absorbed w_uk / w_uv (L, lora, heads, hd'): the heads axis;
    - MoE expert stacks (L, E, ...): the experts axis;
    - everything else (norms, embeddings, router, shared experts, the
      gathered GEMMs' weights, the head) replicates."""
    if spec.tp == 1 or not shape:
        return None
    name = keys[-1]
    parent = keys[-2] if len(keys) >= 2 else ""
    if "experts" in keys and "shared" not in keys:
        return 1 if len(shape) >= 2 and shape[1] % spec.tp == 0 else None
    if ("shared" not in keys and parent in {"wq", "wk", "wv", "w_gate", "w_up"}
            and name in ("kernel", "qkernel", "qscale", "bias")):
        ax = len(shape) - 1
        return ax if shape[ax] % spec.tp == 0 else None
    if parent in ("w_uk", "w_uv") and name == "kernel":
        if len(shape) >= 3 and shape[2] % spec.tp == 0:
            return 2
    return None


def _cache_axes(spec: MeshSpec, rc: RunConfig, shape: tuple) -> dict:
    """{axis: mesh axis} of one cache leaf: a paged pool replicates over dp
    (pages are shared by every row) and shards the head axis over tp where
    it has one (GQA k/v (L, P+1, bs, kv, hd)); MLA latents and the
    per-token scale planes have no head axis and replicate. The dense
    layout shards the batch (axis 1) over dp, plus heads over tp."""
    assign: dict = {}
    if rc.kv_layout != "paged" and len(shape) >= 2 and spec.dp > 1 and shape[1] % spec.dp == 0:
        assign[1] = spec.dp_axis
    if len(shape) == 5 and spec.tp > 1 and shape[3] % spec.tp == 0:
        assign[3] = spec.tp_axis
    return assign


def _spec_tuple(rank: int, assign: dict) -> tuple:
    """The reference's PartitionSpec as a tuple: () when replicated, else
    one entry a dim (None or the mesh axis)."""
    return tuple(assign.get(i) for i in range(rank)) if assign else ()


def _map_keys(fn, tree, keys: tuple = ()):
    """``fn(keys, leaf)`` over a tree of dicts, tuples and lists; ``keys``
    is the leaf's path as strings (the reference's ``_path_keys``)."""
    if isinstance(tree, dict):
        return {k: _map_keys(fn, v, keys + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_keys(fn, v, keys + (str(i),)) for i, v in enumerate(tree))
    return fn(keys, tree)


def _flat_specs(fn, tree) -> dict:
    """{path: fn(keys, leaf)} over the tensor leaves (a packed leaf's
    ``QBits`` marker is static in the reference's trees, not a leaf)."""
    out: dict = {}
    _map_keys(lambda keys, leaf: out.__setitem__("/".join(keys), fn(keys, leaf))
              if isinstance(leaf, torch.Tensor) else None, tree)
    return out


def param_pspecs(spec: MeshSpec, params) -> dict:
    """{leaf path ("groups/0/k0/attn/wq/kernel"): partition spec} of every
    param leaf, each spec as :func:`_spec_tuple`."""
    def one(keys, leaf):
        shape = tuple(leaf.shape)
        ax = _param_axis(spec, keys, shape)
        return _spec_tuple(len(shape), {} if ax is None else {ax: spec.tp_axis})

    return _flat_specs(one, params)


def cache_pspecs(spec: MeshSpec, rc: RunConfig, caches) -> dict:
    """{leaf path: partition spec} of every cache leaf."""
    return _flat_specs(lambda _, leaf: _spec_tuple(
        len(leaf.shape), _cache_axes(spec, rc, tuple(leaf.shape))), caches)


def _slice(x: torch.Tensor, axis: int, index: int, count: int) -> torch.Tensor:
    """Part ``index`` of ``count`` equal parts of ``x`` along ``axis``, as a
    contiguous copy (never a view holding the whole storage)."""
    n = x.shape[axis] // count
    return x.narrow(axis, index * n, n).clone(memory_format=torch.contiguous_format)


def param_keep(spec: MeshSpec, t: int):
    """``keep(keys, leaf)`` -> rank column t's part of one param leaf (the
    leaf itself where it replicates)."""
    def keep(keys, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        ax = _param_axis(spec, tuple(keys), tuple(leaf.shape))
        return leaf if ax is None else _slice(leaf, ax, t, spec.tp)

    return keep


def shard_params(spec: MeshSpec, params, d: int, t: int):
    """Rank (d, t)'s part of a full param tree (params replicate over dp)."""
    return _map_keys(param_keep(spec, t), params)


def shard_caches(spec: MeshSpec, rc: RunConfig, caches, d: int, t: int):
    """Rank (d, t)'s part of a full cache tree."""
    def one(_, leaf):
        for ax, mesh_ax in _cache_axes(spec, rc, tuple(leaf.shape)).items():
            leaf = _slice(leaf, ax, *((d, spec.dp) if mesh_ax == spec.dp_axis else (t, spec.tp)))
        return leaf

    return _map_keys(one, caches)


# -------------------------------------------------------------- weight sources
class TreeShard:
    """One rank's weights, cut from a full tree by the caller (host copies
    travel to the rank, which places them on its device)."""

    def __init__(self, shard):
        self.shard = _map_keys(
            lambda _, x: x.detach().cpu() if isinstance(x, torch.Tensor) else x, shard)

    def params(self, spec: MeshSpec, d: int, t: int, device):
        return _map_keys(lambda _, x: x.to(device) if isinstance(x, torch.Tensor) else x,
                         self.shard)


@dataclass(frozen=True)
class InitShards:
    """Every rank draws ``models.init(cfg, rc, Generator(generator).manual_seed(seed))``
    leaf by leaf and keeps only its part of each leaf: the same weights as
    the single-device ``init`` with that generator, and no rank ever holds
    the whole tree. ``generator`` is the generator's device: ``cpu``, or
    ``cuda`` (then each rank's own card)."""

    cfg: ModelConfig
    rc: RunConfig
    seed: int = 0
    generator: str = "cpu"

    def params(self, spec: MeshSpec, d: int, t: int, device):
        from ..models import init

        gdev = torch.device(device) if self.generator == "cuda" else torch.device("cpu")
        gen = torch.Generator(device=gdev).manual_seed(self.seed)
        return init(self.cfg, self.rc, gen, device=device, keep=param_keep(spec, t))


# ------------------------------------------------------------- sharded step
@dataclass
class RankCoords:
    """Where one rank sits: (d, t), its dp group (same t), tp group (same
    d) and the world group, and whether its collectives copy through host
    memory."""

    d: int = 0
    t: int = 0
    dp_group: object = None
    tp_group: object = None
    world_group: object = None
    host_staged: bool = False


class ShardedStep:
    """One rank's mixed step plus the host-side merge and attribution
    helpers.

    Called on every rank with the whole step's inputs (device tensors:
    tokens (B, W), pos, lens, tables), it runs this rank's rows and heads
    and returns ``(caches, logits (B/dp, V), capture, meter)``: the capture
    holds this rank's stats (or only its MoE drop scalars when
    ``with_stats`` is off), the meter its collectives' bytes. Rank 0 stacks
    the ranks' captures into a raw tree with leading (dp, tp) axes
    (:meth:`stack_raw`) for :meth:`merge_stats`,
    :meth:`device_serial_by_bits` and :meth:`moe_drops`."""

    def __init__(self, cfg: ModelConfig, rc: RunConfig, spec: MeshSpec,
                 coords: RankCoords | None = None, *, with_stats: bool = False,
                 impl: str = "auto", scope: str = "serve/step"):
        self.cfg, self.rc, self.spec = cfg, rc, spec
        self.coords = coords if coords is not None else RankCoords()
        self.cfg_local = local_config(cfg, spec)
        self.with_stats, self.impl, self.scope = with_stats, impl, scope
        self.ep = spec.tp > 1 and cfg.num_experts > 0
        self.kv_sync = (frozenset({"k", "v"}) if cfg.attn_type == "gqa" and spec.tp > 1
                        else frozenset())
        self._meters: dict[int, dict] = {}      # step width -> last meter snapshot
        self.last_comm_s = 0.0                  # the last call's seconds in collectives

    @torch.no_grad()
    def __call__(self, params, caches, tokens, pos, lens, tables):
        from ..models import KVView, forward, input_batch, lm_logits
        from ..obs.profile import named_scope

        spec, c, rc = self.spec, self.coords, self.rc
        B, W = tokens.shape
        bl = B // spec.dp
        rows = slice(c.d * bl, (c.d + 1) * bl)
        tok_l, pos_l, lens_l = tokens[rows], pos[rows], lens[rows]
        tab_l = tables[rows] if tables is not None else None
        view = KVView(pos=pos_l, lens=lens_l, tables=tab_l, block_size=rc.block_size,
                      layout=rc.kv_layout)
        write_view = None
        if rc.kv_layout == "paged" and tables is not None:
            # full-batch addressing of the dp-replicated pool: every rank
            # writes every row's pages (values gathered over dp)
            write_view = KVView(pos=pos, lens=lens, tables=tables, block_size=rc.block_size,
                                layout=rc.kv_layout)
        prog = dist.MeshProgram(
            dp=spec.dp, tp=spec.tp, d=c.d, t=c.t, dp_group=c.dp_group, tp_group=c.tp_group,
            world_group=c.world_group, host_staged=c.host_staged, gather_gemms=GATHER_GEMMS,
            kv_sync_names=self.kv_sync, write_view=write_view)
        cuda = tokens.is_cuda
        with dist.activate(prog), stats_capture.capture_stats(
                scalars_only=not self.with_stats) as cap, named_scope(self.scope, cuda=cuda):
            h, caches, _ = forward(self.cfg_local, rc, params,
                                   input_batch(self.cfg_local, tok_l, pos_l),
                                   caches=caches, cache_pos=pos_l, kv_view=view, impl=self.impl)
            with named_scope("serve/logits", cuda=cuda):
                idx = torch.clamp(lens_l.long() - 1, 0, W - 1)
                h_last = h[torch.arange(h.shape[0], device=h.device), idx][:, None]
                logits = lm_logits(self.cfg_local, rc, params, h_last, impl=self.impl)[:, 0, :]
        meter = prog.meter_snapshot()
        self._meters[W] = meter
        self.last_comm_s = prog.comm_s
        return caches, logits, cap, meter

    # ----------------------------------------------------------- comms meter
    def comms_for(self, width: int) -> dict:
        """The collectives' bytes of this rank's last step of ``width``
        tokens: {(label, bits): {calls, elems, payload_bytes, scale_bytes,
        bf16_bytes}} (static per width: every step of that width moves the
        same bytes)."""
        return self._meters.get(width, {})

    # ------------------------------------------------------------ raw stats
    @staticmethod
    def raw_payload(cap: stats_capture.Capture) -> list:
        """One rank's capture as int64 host arrays, in capture order: each
        GEMM's (step cycles, max_abs, act_max), then each scalar; one copy
        from the device for all of them."""
        parts = [t for e in cap.entries
                 for t in (e.stats.step_cycles, e.stats.max_abs, e.stats.act_max)]
        parts += [s.value for s in cap.scalars]
        live = [t for t in parts if t is not None]
        if not live:
            return []
        flat = torch.cat([t.reshape(-1).to(torch.int64) for t in live]).cpu().numpy()
        arrs, c = [], 0
        for t in parts:
            if t is None:
                arrs.append(None)
                continue
            arrs.append(flat[c:c + t.numel()].reshape(tuple(t.shape)))
            c += t.numel()
        n = 3 * len(cap.entries)
        return [tuple(arrs[i:i + 3]) for i in range(0, n, 3)] + arrs[n:]

    def stack_raw(self, cap: stats_capture.Capture, payloads: list) -> stats_capture.Capture:
        """The raw tree: ``cap`` (rank 0's capture, for names and shapes)
        with every stats field and scalar stacked over the ranks' payloads
        (in rank order d·tp + t) into leading (dp, tp) axes."""
        dp, tp = self.spec.dp, self.spec.tp

        def grid(arrs):
            return np.stack(arrs).reshape((dp, tp) + arrs[0].shape)

        raw = stats_capture.Capture()
        for i, e in enumerate(cap.entries):
            step = grid([p[i][0] for p in payloads])
            am = None if payloads[0][i][2] is None else grid([p[i][2] for p in payloads])
            stats = TuGemmStats(step, step.sum(axis=-1), step.max(axis=-1, initial=0),
                                grid([p[i][1] for p in payloads]), am)
            raw.entries.append(stats_capture.CapturedGemm(e.name, e.M, e.K, e.N, stats, e.bits))
        n = len(cap.entries)
        for j, s in enumerate(cap.scalars):
            raw.scalars.append(stats_capture.CapturedScalar(
                s.name, grid([p[n + j] for p in payloads])))
        return raw

    # ----------------------------------------------------------- stats merge
    def _merge_gemm(self, e: stats_capture.CapturedGemm) -> stats_capture.CapturedGemm:
        st = e.stats
        step, ma, am = st.step_cycles, st.max_abs, st.act_max     # (dp, tp, *lead, ...)
        if e.name in EXPERT_GEMMS and self.ep:
            # rank t holds experts [t·E_l, (t+1)·E_l) on its dp rows: max
            # over dp, concatenate over tp along the experts axis
            step = np.concatenate(list(step.max(axis=0)), axis=-2)
            ma = np.concatenate(list(ma.max(axis=0)), axis=-1)
            if am is not None:
                am = np.concatenate(list(am.max(axis=0)), axis=-1)
            N = e.N
        else:
            # a row / column partition of one GEMM: step[k] = max_a[k] ·
            # max(max_b[k], 1), both factors nonnegative, so the max over
            # the device grid is the global product
            step = step.max(axis=(0, 1))
            ma = ma.max(axis=(0, 1))
            if am is not None:
                am = am.max(axis=(0, 1))
            N = e.N * self.spec.tp if e.name in COL_OUT_GEMMS else e.N

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a))

        stats = TuGemmStats(t(step), t(step.sum(axis=-1)), t(step.max(axis=-1, initial=0)),
                            t(ma), None if am is None else t(am))
        return stats_capture.CapturedGemm(e.name, e.M * self.spec.dp, e.K, N, stats, e.bits)

    def merge_stats(self, raw: stats_capture.Capture) -> stats_capture.Capture:
        """The raw (dp, tp) tree -> the capture the single-device step would
        have made (its cycle totals bit for bit)."""
        out = stats_capture.Capture([self._merge_gemm(e) for e in raw.entries])
        for s in raw.scalars:
            out.scalars.append(stats_capture.CapturedScalar(
                s.name, torch.from_numpy(np.asarray(s.value[:, 0].sum(axis=0)))))
        return out

    def device_serial_by_bits(self, raw: stats_capture.Capture) -> dict[int, np.ndarray]:
        """Each rank's own executed serial cycles (its row and column
        shards): {bits: (dp, tp) int64}, the balance signal."""
        out: dict[int, np.ndarray] = {}
        for e in raw.entries:
            s = np.asarray(e.stats.serial_cycles, dtype=np.int64)
            s = s.reshape(s.shape[0], s.shape[1], -1).sum(axis=-1)
            acc = out.setdefault(int(e.bits), np.zeros((self.spec.dp, self.spec.tp), np.int64))
            acc += s
        return out

    def moe_drops(self, raw: stats_capture.Capture) -> int:
        """Router capacity drops this step, counted once per dp group (the
        tp ranks of a group compute identical dispatches)."""
        return sum(int(np.asarray(s.value)[:, 0].sum()) for s in raw.scalars
                   if s.name.endswith("moe.dropped_tokens"))

    @staticmethod
    def split_exact(total: int, weights) -> np.ndarray:
        """Split integer ``total`` proportionally to ``weights`` into
        integer shares that sum to exactly ``total`` (cumulative floor
        differences: no rounding drift)."""
        w = np.asarray(weights, np.float64).reshape(-1)
        if w.sum() <= 0:
            w = np.ones_like(w)
        cum = np.floor(int(total) * np.cumsum(w) / w.sum()).astype(np.int64)
        cum[-1] = int(total)
        return np.diff(np.concatenate([np.zeros(1, np.int64), cum]))


def build_sharded_step(cfg: ModelConfig, rc: RunConfig, spec: MeshSpec,
                       coords: RankCoords | None = None, *, with_stats: bool = False,
                       impl: str = "auto", scope: str = "serve/step") -> ShardedStep:
    """One rank's sharded mixed step (see :class:`ShardedStep`)."""
    return ShardedStep(cfg, rc, spec, coords, with_stats=with_stats, impl=impl, scope=scope)


# -------------------------------------------------------------- rank engine
class RankEngine:
    """What one rank holds for one mesh Scheduler: its weight and cache
    shards and its sharded main step (the fallback step is built on first
    use). Rank 0's engine backs the Scheduler; every other rank's runs the
    same calls on the ops rank 0 sends (``launch/mesh.py``)."""

    def __init__(self, cfg: ModelConfig, rc: RunConfig, spec: MeshSpec, coords: RankCoords,
                 source, *, max_batch: int, capacity: int, num_pages: int | None,
                 with_stats: bool, impl: str, device):
        from ..models import init_caches

        self.cfg, self.rc, self.spec, self.coords = cfg, rc, spec, coords
        self.impl, self.device = impl, torch.device(device)
        self.params = source.params(spec, coords.d, coords.t, self.device)
        rows = max_batch if rc.kv_layout == "paged" else max_batch // spec.dp
        self.caches = init_caches(local_config(cfg, spec), rc, rows, capacity,
                                  num_pages=num_pages, device=self.device)
        self.step = build_sharded_step(cfg, rc, spec, coords, with_stats=with_stats, impl=impl)
        self._fb = None
        self.capture = None          # the last main step's capture (names and shapes)

    def _upload(self, a):
        return None if a is None else torch.from_numpy(np.array(a)).to(self.device)

    def run(self, kind: str, tokens, pos, lens, tables, rc_fb: RunConfig | None = None) -> dict:
        """One step of ``kind`` (``main``, or ``fallback`` at ``rc_fb``):
        {"logits": (B/dp, V) f32 host array on tp rank 0 of each dp group,
        "stats": the raw payload (main step), "meter": the collectives'
        bytes, "seconds": (the step's wall time, to its logits on the host
        where it has them; its part inside the collectives)}."""
        t0 = time.perf_counter()
        if kind == "main":
            step = self.step
        else:
            if self._fb is None:
                self._fb = build_sharded_step(self.cfg, rc_fb, self.spec, self.coords,
                                              impl=self.impl, scope="serve/fallback")
            step = self._fb
        self.caches, logits, cap, meter = step(
            self.params, self.caches, self._upload(tokens), self._upload(pos),
            self._upload(lens), self._upload(tables))
        out = {"meter": meter}
        if self.coords.t == 0:
            out["logits"] = logits.to(torch.float32).cpu().numpy()
        out["seconds"] = (time.perf_counter() - t0, step.last_comm_s)
        if kind == "main":
            self.capture = cap
            out["stats"] = ShardedStep.raw_payload(cap)
        return out

    def copy_pages(self, copies) -> None:
        """The copy-on-write page copies on this rank's pools."""
        from ..serve.cache import copy_pages

        copy_pages(self.caches, copies, self.device)
