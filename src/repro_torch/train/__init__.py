"""Training substrate: step builder, checkpointing, fault-tolerant loop."""

from .checkpoint import AsyncCheckpointer, latest_step, restore, save
from .train_step import build_train_step, init_train_state
from .trainer import InjectedFailure, StepClock, Trainer

__all__ = [
    "AsyncCheckpointer",
    "latest_step",
    "restore",
    "save",
    "build_train_step",
    "init_train_state",
    "InjectedFailure",
    "StepClock",
    "Trainer",
]
