"""qwen2-vl-7b [vlm] — 28L d_model=3584 28H (GQA kv=4) d_ff=18944,
vocab=152064, M-RoPE sections (t,h,w)=(16,24,24) over head_dim 128.
The vision tower (dynamic-resolution ViT) is STUBBED per the assignment:
the backbone consumes token ids + precomputed 3-D M-RoPE position ids
(input_specs provides the (3, B, S) position tensor).
[arXiv:2409.12191; hf]"""

from .base import ModelConfig, register

QWEN2_VL_7B = register(
    ModelConfig(
        name="qwen2-vl-7b",
        family="vlm",
        num_layers=28,
        d_model=3584,
        num_heads=28,
        num_kv_heads=4,
        d_ff=18944,
        vocab_size=152064,
        head_dim=128,
        attn_type="gqa",
        rope_theta=1e6,
        mrope_sections=(16, 24, 24),
        frontend="vision",
    )
)

SMOKE = register(
    QWEN2_VL_7B.replace(
        name="qwen2-vl-7b_smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
        mrope_sections=(2, 3, 3),
    )
)
