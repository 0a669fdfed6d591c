"""Serving substrate (the port of the reference's ``repro/serve``).

- serve.cache: paged KV pool block manager (free-list pages, block tables,
  rollback via truncate, an allocation fault hook, registry gauges)
- serve.scheduler: chunked-prefill + decode mixed-step Scheduler with the
  numerical guard (quarantine, retry, fallback-policy step)
- serve.admission: admission control (priority classes, tenant budgets,
  TTLs) + the overload degradation ladder (DESIGN.md §10)
- serve.faults: deterministic seed-keyed fault injection for chaos testing
"""

from .admission import AdmissionController, DegradationLadder, Rejection, RejectReason
from .cache import BlockManager, num_pages_for
from .faults import FaultEvent, FaultPlan
from .scheduler import (
    Request,
    Scheduler,
    SlotMeter,
    build_mixed_step,
    install_sigint_drain,
    sample,
)

__all__ = [
    "AdmissionController",
    "BlockManager",
    "DegradationLadder",
    "FaultEvent",
    "FaultPlan",
    "Rejection",
    "RejectReason",
    "Request",
    "Scheduler",
    "SlotMeter",
    "build_mixed_step",
    "install_sigint_drain",
    "num_pages_for",
    "sample",
]
