"""Import-all aggregator: registers every architecture the port serves (and
its smoke variant) in the config registry. Later slices add their arch
modules here as their model paths land."""

from . import (  # noqa: F401
    deepseek_v2_lite,
    falcon_mamba_7b,
    hubert_xlarge,
    hymba_1_5b,
    llama4_maverick_400b,
    qwen2_vl_7b,
    qwen3_0_6b,
)

ASSIGNED = ["qwen3-0.6b", "deepseek-v2-lite-16b", "falcon-mamba-7b", "hymba-1.5b",
            "hubert-xlarge", "qwen2-vl-7b", "llama4-maverick-400b-a17b"]
