"""hymba-1.5b [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504,
vocab=32001, ssm_state=16. Parallel attention + mamba heads per block
(outputs fused by per-branch RMS norm + mean). Full (global) attention on
the first, middle and last layers; SWA (window 1024) elsewhere — so
long_500k is sub-quadratic and runs. Meta-tokens from the paper are a
prompt-side technique and orthogonal to the backbone; not modeled.
[arXiv:2411.13676; hf]"""

from .base import ModelConfig, register

HYMBA_1_5B = register(
    ModelConfig(
        name="hymba-1.5b",
        family="hybrid",
        num_layers=32,
        d_model=1600,
        num_heads=25,
        num_kv_heads=5,
        d_ff=5504,
        vocab_size=32001,
        head_dim=64,
        attn_type="gqa",
        rope_theta=1e4,
        sliding_window=1024,
        global_attn_layers=(0, 15, 31),
        ssm_state=16,
        ssm_conv=4,
        ssm_expand=2,
        tie_embeddings=True,
    )
)

SMOKE = register(
    HYMBA_1_5B.replace(
        name="hymba-1.5b_smoke", num_layers=4, d_model=64, num_heads=4,
        num_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
        global_attn_layers=(0, 3), sliding_window=8, ssm_state=4, ssm_dt_rank=8,
    )
)
