"""hubert-xlarge [audio] — 48L d_model=1280 16H (kv=16) d_ff=5120,
vocab=504 (codebook targets), encoder-only, non-gated GELU MLP, learned conv
frontend STUBBED: input_specs provide precomputed 512-d frame embeddings
(the w2v2/HuBERT conv stack output dim), projected to d_model.
No decode step (encoder) — decode/long shapes are skipped.
[arXiv:2106.07447; unverified]"""

from .base import ModelConfig, register

HUBERT_XLARGE = register(
    ModelConfig(
        name="hubert-xlarge",
        family="audio",
        num_layers=48,
        d_model=1280,
        num_heads=16,
        num_kv_heads=16,
        d_ff=5120,
        vocab_size=504,
        attn_type="gqa",
        causal=False,
        is_encoder=True,
        mlp_type="gelu",
        frontend="audio",
    )
)

SMOKE = register(
    HUBERT_XLARGE.replace(
        name="hubert-xlarge_smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, d_ff=128, vocab_size=32,
    )
)
