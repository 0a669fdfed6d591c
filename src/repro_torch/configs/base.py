"""Model/run configuration system.

One :class:`ModelConfig` dataclass covers every assigned architecture family
(dense / MoE / SSM / hybrid / audio-encoder / VLM); one ``<arch>.py`` per
assigned architecture instantiates it with the exact published numbers, plus
a ``*_smoke`` reduced variant for CPU tests. :class:`ShapeConfig` enumerates
the assigned input shapes; :class:`RunConfig` carries runtime knobs (dtype,
GEMM backend, remat, mesh overrides) that are orthogonal to the architecture.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

__all__ = ["ModelConfig", "ShapeConfig", "RunConfig", "SHAPES", "register", "get_config", "list_configs"]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads

    # attention
    attn_type: str = "gqa"          # gqa | mla | none
    qk_norm: bool = False
    rope_theta: float = 1e6
    mrope_sections: tuple[int, ...] | None = None   # qwen2-vl M-RoPE
    sliding_window: int | None = None               # hymba SWA
    global_attn_layers: tuple[int, ...] = ()        # hymba full-attn layers
    causal: bool = True                              # False for encoders
    attn_logit_softcap: float | None = None

    # MLA (deepseek-v2)
    kv_lora_rank: int = 0
    qk_rope_head_dim: int = 0
    qk_nope_head_dim: int = 0
    v_head_dim: int = 0

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    moe_layer_period: int = 1       # every k-th layer is MoE ...
    moe_layer_offset: int = 0       # ... starting at this layer index
    capacity_factor: float = 1.25

    # SSM (mamba1)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0            # 0 -> ceil(d_model / 16)

    # misc
    mlp_type: str = "swiglu"        # swiglu | gelu (non-gated; hubert)
    is_encoder: bool = False
    tie_embeddings: bool = False
    rms_eps: float = 1e-6
    frontend: str | None = None     # "audio" | "vision" input-embedding stub

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or -(-self.d_model // 16)

    def is_moe_layer(self, i: int) -> bool:
        if self.num_experts == 0:
            return False
        return i >= self.moe_layer_offset and (i - self.moe_layer_offset) % self.moe_layer_period == 0

    def uses_attention(self, i: int) -> bool:
        return self.attn_type != "none"

    def is_global_attn(self, i: int) -> bool:
        if self.sliding_window is None:
            return True
        return i in self.global_attn_layers

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


# assigned shape set (one per arch; skips handled in launch/dryrun.py)
SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class RunConfig:
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    # canonical quantization knob: a quant.policy.QuantPolicy, its grammar
    # string ("attn.*=int8,mlp.*=int2,*=bf16"), or its to_json() dict —
    # declarative per-layer mixed precision, resolved once per GEMM name at
    # trace/surgery time (quant.policy.effective_policy).
    quant_policy: object = None
    # DEPRECATED single-backend knobs: when quant_policy is None these lower
    # to a one-rule policy (with a DeprecationWarning if non-default).
    gemm_backend: str = "bf16"       # bf16 | int8 | int4 | int2 (quant.qlinear)
    gemm_mode: str = "dynamic"       # dynamic | prequant
    collect_gemm_stats: bool = False
    # DEPRECATED per-layer opt-in (use quant_policy rules): fnmatch patterns
    # over GEMM names ("attn.*", "mlp.down", "lm_head", ...). Empty tuple =
    # every GEMM routes through the quant backend (previous behavior).
    quant_layers: tuple = ()
    remat: str = "block"             # none | block | full
    scan_layers: bool = True
    attn_chunk: int = 1024           # blockwise-attention KV chunk
    # optimizer
    lr: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    moments_dtype: str = "float32"   # float32 | int8 (block-quantized Adam)
    master_dtype: str = "float32"    # float32 | bfloat16
    grad_compression: str = "none"   # none | int8_ef (error-feedback int8 DP sync)
    microbatches: int = 1
    # serving
    kv_cache_dtype: str = "bfloat16" # bfloat16 | int8
    # KV cache layout: "dense" = per-slot (batch, capacity) buffers (legacy,
    # bit-exact A/B baseline); "paged" = fixed pool of block_size-token pages
    # indexed through per-slot block tables (serve/cache.py manager).
    kv_layout: str = "dense"         # dense | paged
    block_size: int = 16             # tokens per KV page (paged layout)
    # prefix caching (serve/cache.py, DESIGN.md §11): requests whose prompts
    # share a block-aligned token prefix fork the same ref-counted pages
    # (copy-on-write on divergence) and skip the matched prefill entirely.
    # Requires kv_layout="paged". Off by default: page sharing changes pool
    # occupancy and scheduling, so A/B baselines opt in explicitly.
    prefix_cache: bool = False
    # chunked-prefill scheduler (serve/scheduler.py): prompts are split into
    # prefill_chunk-token chunks and packed with decode rows into one jitted
    # mixed step of static width max(prefill_chunk, 1) per tick.
    prefill_chunk: int = 16
    token_budget: int = 0            # per-tick scheduled-token cap (0 -> rows*chunk)
    # speculative decoding (serve/spec.py): each decode slot drafts
    # spec_gamma candidate tokens per tick under draft_policy (a second,
    # low-bit QuantPolicy over the same weights + a draft KV pool); the
    # target verifies all gamma+1 positions in one chunked-prefill-shaped
    # mixed step, rolling rejected candidates back via BlockManager.truncate.
    # 0 = off (the scheduler's plain path, bit-identical to pre-spec builds).
    spec_gamma: int = 0
    draft_policy: object = None      # QuantPolicy | grammar str (None -> "*=int2")
    # robustness (serve/admission.py, DESIGN.md §10): policy used by the
    # numerical-fault quarantine's fallback step, and how many consecutive
    # clean ticks relax the degradation ladder one level.
    fallback_policy: object = "*=bf16"   # QuantPolicy | grammar str
    ladder_relax_ticks: int = 4
    # sharding rule overrides: logical axis -> mesh axis name(s) or None
    sharding_overrides: dict = field(default_factory=dict)


_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        # import arch modules lazily so `--arch foo` just works
        from . import archs  # noqa: F401

        if name not in _REGISTRY:
            raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    from . import archs  # noqa: F401

    return sorted(_REGISTRY)
