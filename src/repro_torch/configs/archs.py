"""Import-all aggregator: registers every assigned architecture (and its
smoke variant) in the config registry, in the reference's order."""

from . import (  # noqa: F401
    deepseek_v2_lite,
    falcon_mamba_7b,
    hubert_xlarge,
    hymba_1_5b,
    llama4_maverick_400b,
    qwen2_vl_7b,
    qwen3_0_6b,
    qwen3_8b,
    qwen3_14b,
    smollm_360m,
)

ASSIGNED = [
    "qwen3-0.6b",
    "qwen3-8b",
    "qwen3-14b",
    "smollm-360m",
    "llama4-maverick-400b-a17b",
    "deepseek-v2-lite-16b",
    "falcon-mamba-7b",
    "hubert-xlarge",
    "hymba-1.5b",
    "qwen2-vl-7b",
]
