"""qwen3-14b [dense] — 40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936, qk_norm, head_dim 128. [hf:Qwen/Qwen3-14B; hf]"""

from .base import ModelConfig, register

QWEN3_14B = register(
    ModelConfig(
        name="qwen3-14b",
        family="dense",
        num_layers=40,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        d_ff=17408,
        vocab_size=151936,
        head_dim=128,
        attn_type="gqa",
        qk_norm=True,
        rope_theta=1e6,
    )
)

SMOKE = register(
    QWEN3_14B.replace(
        name="qwen3-14b_smoke", num_layers=2, d_model=80, num_heads=5,
        num_kv_heads=1, d_ff=160, vocab_size=256, head_dim=16,
    )
)
