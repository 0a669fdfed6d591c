"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8)
d_ff=8192, vocab=202048, MoE 128e top-1 + 1 shared expert, MoE every 2nd
layer (period 2 gives ~400B total / ~17B active). Early-fusion multimodal in
the original; we build the text backbone (the assigned dims).
[hf:meta-llama/Llama-4-Maverick-17B-128E; unverified]"""

from .base import ModelConfig, register

LLAMA4_MAVERICK = register(
    ModelConfig(
        name="llama4-maverick-400b-a17b",
        family="moe",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        d_ff=8192,
        vocab_size=202048,
        head_dim=128,
        attn_type="gqa",
        rope_theta=5e5,
        num_experts=128,
        num_experts_per_tok=1,
        num_shared_experts=1,
        moe_d_ff=8192,
        moe_layer_period=2,
        moe_layer_offset=1,
    )
)

SMOKE = register(
    LLAMA4_MAVERICK.replace(
        name="llama4-maverick-400b-a17b_smoke", num_layers=4, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
        num_experts=4, moe_d_ff=128,
    )
)
