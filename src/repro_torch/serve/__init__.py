"""Serving: the paged KV cache manager and the chunked-prefill scheduler."""

from .cache import BlockManager
from .scheduler import Request, Scheduler, SlotMeter, build_mixed_step, sample

__all__ = ["BlockManager", "Request", "Scheduler", "SlotMeter", "build_mixed_step", "sample"]
