"""Import-all aggregator: registers every architecture the port serves (and
its smoke variant) in the config registry. Later slices add their arch
modules here as their model paths land."""

from . import deepseek_v2_lite, falcon_mamba_7b, hymba_1_5b, qwen3_0_6b  # noqa: F401

ASSIGNED = ["qwen3-0.6b", "deepseek-v2-lite-16b", "falcon-mamba-7b", "hymba-1.5b"]
