"""Optimizer substrate: AdamW (+8-bit moments), schedules, grad compression."""

from .adamw import (
    AdamWState,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    init_opt_state,
    lr_schedule,
)
from .compress import compressed_psum, ef_compress, init_ef_state

__all__ = [
    "AdamWState",
    "adamw_update",
    "clip_by_global_norm",
    "global_norm",
    "init_opt_state",
    "lr_schedule",
    "compressed_psum",
    "ef_compress",
    "init_ef_state",
]
