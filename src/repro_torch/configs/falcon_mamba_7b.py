"""falcon-mamba-7b [ssm] — 64L d_model=4096 attn-free, vocab=65024,
mamba1 blocks: d_state=16, conv4, expand 2 (d_inner 8192), dt_rank 256.
Runs all four shapes including long_500k (O(L) scan, O(1) decode state).
[arXiv:2410.05355; unverified]"""

from .base import ModelConfig, register

FALCON_MAMBA_7B = register(
    ModelConfig(
        name="falcon-mamba-7b",
        family="ssm",
        num_layers=64,
        d_model=4096,
        num_heads=1,          # unused (attn-free)
        num_kv_heads=1,
        d_ff=0,
        vocab_size=65024,
        head_dim=64,
        attn_type="none",
        ssm_state=16,
        ssm_conv=4,
        ssm_expand=2,
    )
)

SMOKE = register(
    FALCON_MAMBA_7B.replace(
        name="falcon-mamba-7b_smoke", num_layers=2, d_model=64,
        vocab_size=256, ssm_state=4, ssm_dt_rank=8,
    )
)
