"""smollm-360m [dense] — 32L d_model=960 15H (GQA kv=5) d_ff=2560
vocab=49152, llama-arch small, head_dim 64. [hf:HuggingFaceTB/SmolLM-360M; hf]"""

from .base import ModelConfig, register

SMOLLM_360M = register(
    ModelConfig(
        name="smollm-360m",
        family="dense",
        num_layers=32,
        d_model=960,
        num_heads=15,
        num_kv_heads=5,
        d_ff=2560,
        vocab_size=49152,
        head_dim=64,
        attn_type="gqa",
        rope_theta=1e4,
        tie_embeddings=True,
    )
)

SMOKE = register(
    SMOLLM_360M.replace(
        name="smollm-360m_smoke", num_layers=2, d_model=60, num_heads=3,
        num_kv_heads=1, d_ff=96, vocab_size=256, head_dim=20,
    )
)
