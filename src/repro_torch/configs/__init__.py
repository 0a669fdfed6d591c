"""Config system: ModelConfig/ShapeConfig/RunConfig + the arch registry
(copies of ``repro.configs``; the port keeps its own)."""

from .base import SHAPES, ModelConfig, RunConfig, ShapeConfig, get_config, list_configs, register

__all__ = [
    "SHAPES",
    "ModelConfig",
    "RunConfig",
    "ShapeConfig",
    "get_config",
    "list_configs",
    "register",
]
