"""qwen3-0.6b [dense] — 28L d_model=1024 16H (GQA kv=8) d_ff=3072
vocab=151936, qk_norm, head_dim 128. [hf:Qwen/Qwen3-0.6B; hf]"""

from .base import ModelConfig, register

QWEN3_0_6B = register(
    ModelConfig(
        name="qwen3-0.6b",
        family="dense",
        num_layers=28,
        d_model=1024,
        num_heads=16,
        num_kv_heads=8,
        d_ff=3072,
        vocab_size=151936,
        head_dim=128,
        attn_type="gqa",
        qk_norm=True,
        rope_theta=1e6,
        tie_embeddings=True,
    )
)

SMOKE = register(
    QWEN3_0_6B.replace(
        name="qwen3-0.6b_smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
    )
)
