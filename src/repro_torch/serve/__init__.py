"""Serving substrate (the port of the reference's ``repro/serve``).

- serve.cache: paged KV pool block manager (free-list pages, block tables,
  speculative rollback via truncate; ref-counted copy-on-write prefix
  sharing + radix-trie prefix index under rc.prefix_cache; an allocation
  fault hook, registry gauges)
- serve.engine: the legacy dense-slot Engine (one-shot B=1 prefill,
  lock-step decode): the serving path of SSM and hybrid stacks
- serve.scheduler: chunked-prefill + decode mixed-step Scheduler with the
  numerical guard (quarantine, retry, fallback-policy step); speculative
  ticks when rc.spec_gamma > 0; paged pool or dense per-slot rows
- serve.spec: int-low self-drafting + batched-verify speculative decoding
  (draft QuantPolicy weight view, draft KV pool, acceptance rules)
- serve.admission: admission control (priority classes, tenant budgets,
  TTLs) + the overload degradation ladder (DESIGN.md §10)
- serve.faults: deterministic seed-keyed fault injection for chaos testing
"""

from .admission import AdmissionController, DegradationLadder, Rejection, RejectReason
from .cache import BlockManager, PrefixCache, PrefixNode, num_pages_for
from .engine import Engine, build_decode, build_prefill
from .faults import FaultEvent, FaultPlan
from .scheduler import (
    Request,
    Scheduler,
    SlotMeter,
    build_mixed_step,
    install_sigint_drain,
    sample,
)
from .spec import SpecDecoder, greedy_accept, rejection_accept

__all__ = [
    "AdmissionController",
    "BlockManager",
    "DegradationLadder",
    "Engine",
    "FaultEvent",
    "FaultPlan",
    "PrefixCache",
    "PrefixNode",
    "Rejection",
    "RejectReason",
    "Request",
    "Scheduler",
    "SlotMeter",
    "SpecDecoder",
    "build_decode",
    "build_mixed_step",
    "build_prefill",
    "greedy_accept",
    "install_sigint_drain",
    "num_pages_for",
    "rejection_accept",
    "sample",
]
