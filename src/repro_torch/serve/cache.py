"""Paged KV cache manager: a fixed pool of block_size-token pages with
per-slot block tables and a free-list allocator (the reference's
``serve/cache.py`` without prefix sharing, copy-on-write or the mesh's
table shards, which this port does not have yet).

The device side is built by ``models.init_caches(..., num_pages=...)``:
every attention layer's k/v leaf is a pool of ``num_pages + 1`` pages of
``block_size`` tokens — one *page id* addresses the same row in every
layer's pool, so a single block table serves the whole stack, and the
trailing trash page (id ``num_pages``) swallows the masked writes of padded
step columns. int8 pools keep per-(page, offset) scales.

This module owns the *host* side: :class:`BlockManager` hands out pages on
admit/extend, reclaims them on finish or rollback, and tracks the pool's
high-water marks. A fault hook (``serve/faults.py``) can make an allocating
``extend`` fail, and ``bind_registry`` exposes the pool as callback gauges
on an obs ``MetricsRegistry``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["BlockManager", "cache_bytes", "num_pages_for"]


def num_pages_for(capacity: int, block_size: int, slots: int) -> int:
    """Pages needed to back ``slots`` sequences of up to ``capacity`` tokens
    (the dense-equivalent worst case; real pools are usually sized smaller)."""
    return slots * (-(-capacity // block_size))


def cache_bytes(caches) -> int:
    """Total bytes of the tensor leaves of a cache tree (the paged pools)."""
    if isinstance(caches, dict):
        return sum(cache_bytes(v) for v in caches.values())
    if isinstance(caches, (tuple, list)):
        return sum(cache_bytes(v) for v in caches)
    if isinstance(caches, torch.Tensor):
        return caches.numel() * caches.element_size()
    return 0


class BlockManager:
    """Free-list page allocator + per-slot block tables.

    Slots are step-batch rows (the scheduler's fixed pool). Each slot's
    table maps block index -> page id; unallocated entries hold the trash
    page id (``num_pages``), which the device-side reads never see because
    every read is masked at the slot's live length.
    """

    def __init__(self, num_pages: int, block_size: int, max_batch: int, capacity: int):
        if capacity % block_size:
            raise ValueError(
                f"capacity {capacity} must be a multiple of block_size {block_size} "
                "(the paged view must span exactly the dense capacity for A/B)"
            )
        # fault-injection hook (serve/faults.py): ``hook(slot, new_len) ->
        # True`` forces an *allocating* extend to report failure without
        # mutating any state — exactly the contract a real failed allocation
        # has. It is consulted only when the call must take pages off the
        # free list; a decode tick inside an allocated block cannot fail.
        self.fault_hook = None
        self.injected_failures = 0
        self.num_pages = num_pages
        self.block_size = block_size
        self.max_blocks = capacity // block_size
        self.trash = num_pages
        # LIFO free list: finished requests' pages are reused first (warm)
        self.free: list[int] = list(range(num_pages - 1, -1, -1))
        self.tables = np.full((max_batch, self.max_blocks), self.trash, np.int32)
        self.lens = np.zeros(max_batch, np.int32)      # live tokens per slot
        self.blocks_used = np.zeros(max_batch, np.int32)  # allocated blocks/slot
        self.high_water = 0            # max pages ever off the free list
        self.live_high_water = 0       # max pages ever referenced by a table
        # bumped on every table mutation — consumers key device-side copies
        # on it so steady-state decode ticks skip the host->device upload
        self.version = 0

    # -------------------------------------------------------- observability
    def bind_registry(self, registry) -> None:
        """Expose pool state as callback gauges on an obs MetricsRegistry,
        read lazily at snapshot time (the reference's families; without
        prefix sharing no page is cached and no copy-on-write happens)."""
        registry.gauge_fn(
            "cache_pages",
            lambda: {"state=in_use": self.pages_in_use,
                     "state=live": self.live_pages,
                     "state=cached": 0,
                     "state=free": len(self.free)},
            help="pool pages by state")
        registry.gauge_fn(
            "cache_high_water_pages",
            lambda: {"kind=total": self.high_water,
                     "kind=live": self.live_high_water},
            help="page-pool high-water marks")
        registry.gauge_fn("cache_cow_events", lambda: 0,
                          help="copy-on-write resolutions so far")
        registry.gauge_fn("cache_table_version", lambda: self.version,
                          help="block-table mutation counter")
        registry.gauge_fn("cache_injected_alloc_failures",
                          lambda: self.injected_failures,
                          help="fault-plan induced allocation failures")

    # ------------------------------------------------------------- queries
    @property
    def pages_in_use(self) -> int:
        return self.num_pages - len(self.free)

    @property
    def live_pages(self) -> int:
        """Pages referenced by a slot's table (every page off the free list:
        without prefix sharing none is kept as a cached prefix)."""
        return self.pages_in_use

    def blocks_of(self, slot: int) -> list[int]:
        return [int(p) for p in self.tables[slot, : int(self.blocks_used[slot])]]

    # ----------------------------------------------------------- mutation
    def extend(self, slot: int, new_len: int) -> bool:
        """Grow ``slot`` to cover ``new_len`` tokens, allocating any missing
        pages. Returns False (state unchanged) if the pool cannot cover the
        allocation or the fault hook fails it. The per-decode-tick call
        allocates none at all ``block_size - 1`` times out of
        ``block_size``."""
        if new_len > self.max_blocks * self.block_size:
            raise ValueError(f"slot {slot}: {new_len} tokens > table capacity")
        have = int(self.blocks_used[slot])
        need = -(-new_len // self.block_size)
        if need > have:
            if self.fault_hook is not None and self.fault_hook(slot, new_len):
                self.injected_failures += 1
                return False
            if need - have > len(self.free):
                return False
            self.version += 1
            for b in range(have, need):
                self.tables[slot, b] = self.free.pop()
            self.blocks_used[slot] = need
        self.lens[slot] = new_len
        self.high_water = max(self.high_water, self.pages_in_use)
        self.live_high_water = max(self.live_high_water, self.live_pages)
        return True

    def truncate(self, slot: int, new_len: int) -> None:
        """Roll ``slot`` back to ``new_len`` live tokens, returning every page
        past the new high block to the free list. Stale tokens inside the
        retained final page are harmless — every device read is masked at
        the live length. Never fails (shrink-only)."""
        if new_len > int(self.lens[slot]):
            raise ValueError(
                f"slot {slot}: truncate to {new_len} > live length "
                f"{int(self.lens[slot])} (rollback cannot grow; use extend)"
            )
        have = int(self.blocks_used[slot])
        need = -(-new_len // self.block_size)
        if need < have:
            self.version += 1
            # reverse order keeps the LIFO free list warm: the next extend
            # gets this slot's just-released tail pages back first
            for b in range(have - 1, need - 1, -1):
                self.free.append(int(self.tables[slot, b]))
                self.tables[slot, b] = self.trash
            self.blocks_used[slot] = need
        self.lens[slot] = new_len

    def release(self, slot: int) -> None:
        """Return every page of ``slot`` to the free list."""
        used = int(self.blocks_used[slot])
        for b in range(used):
            self.free.append(int(self.tables[slot, b]))
            self.tables[slot, b] = self.trash
        self.lens[slot] = 0
        self.blocks_used[slot] = 0
        if used:
            self.version += 1

    # --------------------------------------------------------- validation
    def check_invariants(self) -> None:
        """Every page is either referenced by exactly one table entry or on
        the free list, and every slot is backed up to its live length.
        Scans the full tables (not blocks_used) so it also catches a
        bookkeeping drift between the two."""
        refs: dict[int, int] = {}
        for row in self.tables:
            for p in row:
                if p != self.trash:
                    refs[int(p)] = refs.get(int(p), 0) + 1
        assert sum(int(b) for b in self.blocks_used) == sum(refs.values()), (
            "blocks_used out of sync with tables"
        )
        assert all(c == 1 for c in refs.values()), "page referenced twice"
        live = set(refs)
        free = set(self.free)
        assert len(self.free) == len(free), "free-list duplicate"
        assert not (live & free), "referenced page on free list"
        assert len(live) + len(free) == self.num_pages, "orphaned pages"
        for s in range(self.tables.shape[0]):
            need = -(-int(self.lens[s]) // self.block_size)
            assert len(self.blocks_of(s)) >= need, f"slot {s} under-backed"
