"""deepseek-v2-lite-16b [moe] — 27L d_model=2048 16H d_ff=10944 (dense first
layer), vocab=102400. MLA kv_lora_rank=512, rope/nope split heads (64/128),
v_head 128. MoE: 64 routed experts top-6 + 2 shared, moe_d_ff=1408, first
layer dense. [arXiv:2405.04434 Table 2; hf:deepseek-ai/DeepSeek-V2-Lite]"""

from .base import ModelConfig, register

DEEPSEEK_V2_LITE = register(
    ModelConfig(
        name="deepseek-v2-lite-16b",
        family="moe",
        num_layers=27,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=10944,           # dense first layer's FFN (V2-Lite)
        vocab_size=102400,
        attn_type="mla",
        rope_theta=1e4,
        kv_lora_rank=512,
        qk_rope_head_dim=64,
        qk_nope_head_dim=128,
        v_head_dim=128,
        num_experts=64,
        num_experts_per_tok=6,
        num_shared_experts=2,
        moe_d_ff=1408,
        moe_layer_period=1,
        moe_layer_offset=1,   # first layer dense
    )
)

SMOKE = register(
    DEEPSEEK_V2_LITE.replace(
        name="deepseek-v2-lite-16b_smoke", num_layers=3, d_model=64,
        num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=256,
        kv_lora_rank=32, qk_rope_head_dim=8, qk_nope_head_dim=16,
        v_head_dim=16, num_experts=4, num_experts_per_tok=2, moe_d_ff=64,
    )
)
