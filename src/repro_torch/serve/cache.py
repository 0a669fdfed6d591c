"""Paged KV cache manager: a fixed pool of block_size-token pages with
per-slot block tables, a free-list allocator, and — under
``rc.prefix_cache`` — ref-counted copy-on-write page sharing indexed by a
block-aligned radix trie (the reference's ``serve/cache.py``; DESIGN.md §11).

The device side is built by ``models.init_caches(..., num_pages=...)``:
every attention layer's k/v leaf is a pool of ``num_pages + 1`` pages of
``block_size`` tokens — one *page id* addresses the same row in every
layer's pool, so a single block table serves the whole stack, and the
trailing trash page (id ``num_pages``) swallows the masked writes of padded
step columns. int8 pools keep per-(page, offset) scales, so a page's
contents are a pure function of its token prefix: two requests whose
prompts agree on a full block can map their block-table entries to the
*same* physical page.

This module owns the *host* side:

- :class:`BlockManager` hands out pages on admit/extend, reclaims them on
  finish or rollback, and tracks the pool's high-water marks. Every page
  carries a refcount: ``fork_prefix`` maps a fresh slot's leading table
  entries onto an already-written prefix (refcount++ per page, no
  allocation, no prefill compute), ``release``/``truncate`` decrement
  instead of free, and a write into a page someone else still references
  triggers copy-on-write — the writer gets a fresh page and the manager
  records a ``(src, dst)`` device copy for the scheduler to perform. A page
  whose refcount reaches 0 while the trie indexes it stays allocated as a
  *cached* prefix, evicted LRU only under pool pressure (inside ``extend``,
  before it could report failure). A fault hook (``serve/faults.py``) can
  make an allocating ``extend`` fail, and ``bind_registry`` exposes the
  pool as callback gauges on an obs ``MetricsRegistry``.
- :class:`PrefixCache` is the radix trie: block-aligned token chunks ->
  :class:`PrefixNode` (one physical page each). Matching is exact and
  block-aligned — a lookup returns the longest chain of full
  ``block_size``-token chunks present in the trie, never a partial block.

``BlockManager.table_shard`` is a tp-way mesh's per-group ownership view of
the tables (page ``p`` belongs to group ``p % tp``): an accounting
partition, not a data layout; the KV data itself is head-sharded, every
rank holding a head slice of every page. ``copy_pages`` performs the
copy-on-write page copies on a pool's leaves (every mesh rank applies them
to its own shard).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "BlockManager",
    "PrefixCache",
    "PrefixNode",
    "cache_bytes",
    "copy_pages",
    "dense_cache_tokens",
    "num_pages_for",
]


def num_pages_for(capacity: int, block_size: int, slots: int) -> int:
    """Pages needed to back ``slots`` sequences of up to ``capacity`` tokens
    (the dense-equivalent worst case; real pools are usually sized smaller)."""
    return slots * (-(-capacity // block_size))


def dense_cache_tokens(max_batch: int, capacity: int) -> int:
    """Token slots a dense pool reserves regardless of occupancy."""
    return max_batch * capacity


class PrefixNode:
    """One full block of a cached token prefix: the exact ``block_size``
    token chunk it covers, the physical page holding its KV, and the trie
    links. ``cached`` mirrors refcount == 0: the page is allocated but owned
    only by the trie (evictable LRU)."""

    __slots__ = ("page", "key", "parent", "children", "last_used", "cached")

    def __init__(self, page: int, key: tuple, parent: "PrefixNode | None"):
        self.page = page
        self.key = key
        self.parent = parent
        self.children: dict[tuple, PrefixNode] = {}
        self.last_used = 0
        self.cached = False

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"PrefixNode(page={self.page}, depth={len(self.chain())}, "
                f"cached={self.cached}, children={len(self.children)})")

    def chain(self) -> list["PrefixNode"]:
        out, n = [], self
        while n is not None:
            out.append(n)
            n = n.parent
        return out[::-1]


class PrefixCache:
    """Block-aligned radix trie over token prefixes.

    A path root -> node spells a token prefix in ``block_size`` chunks; each
    node owns exactly one physical page. The trie only *indexes* pages — the
    BlockManager owns refcounts and the free list — and matching is exact:
    two prompts share a node iff their tokens agree on every position of
    every chunk along the path, which (with per-(page, offset) int8 scales)
    is precisely the condition under which the pages' contents are
    bit-identical."""

    def __init__(self, block_size: int):
        self.block_size = block_size
        self.root: dict[tuple, PrefixNode] = {}
        self.node_of_page: dict[int, PrefixNode] = {}
        self.cached_pages = 0          # refcount-0 pages retained by the trie
        self.hits = 0                  # lookups that matched >= 1 block
        self.evictions = 0             # cached pages evicted under pressure

    def __len__(self) -> int:
        return len(self.node_of_page)

    # ------------------------------------------------------------- walking
    def walk(self, tokens, max_blocks: int, *, now: int = 0) -> list[PrefixNode]:
        """Longest chain of cached full blocks matching ``tokens``, capped at
        ``max_blocks`` chunks. Touches LRU stamps along the match."""
        bs = self.block_size
        out: list[PrefixNode] = []
        children = self.root
        for b in range(max_blocks):
            node = children.get(tuple(tokens[b * bs: (b + 1) * bs]))
            if node is None:
                break
            node.last_used = now
            out.append(node)
            children = node.children
        if out:
            self.hits += 1
        return out

    def register(self, tokens, nblocks: int, pages: list[int], *,
                 now: int = 0) -> int:
        """Index ``nblocks`` full blocks of ``tokens`` backed by ``pages``.
        Chunks already present keep their existing node (and page — the two
        physical copies are bit-identical, so either serves); new chunks get
        nodes pointing at this caller's pages. Returns nodes added."""
        bs = self.block_size
        children, parent, added = self.root, None, 0
        for b in range(nblocks):
            key = tuple(tokens[b * bs: (b + 1) * bs])
            node = children.get(key)
            if node is None:
                page = pages[b]
                if page in self.node_of_page:
                    # this page already spells a different prefix elsewhere
                    # in the trie (only reachable through exotic rollback
                    # interleavings) — stop rather than alias it
                    break
                node = PrefixNode(page, key, parent)
                children[key] = node
                self.node_of_page[page] = node
                added += 1
            node.last_used = now
            parent, children = node, node.children
        return added

    # ----------------------------------------------------- cached-page state
    def cache_node(self, node: PrefixNode) -> None:
        """Refcount hit 0: the trie keeps the page alive as a cached prefix."""
        assert not node.cached
        node.cached = True
        self.cached_pages += 1

    def uncache_node(self, node: PrefixNode) -> None:
        """A fork revived a cached page (refcount 0 -> 1)."""
        assert node.cached
        node.cached = False
        self.cached_pages -= 1

    # ------------------------------------------------------------- removal
    def _unlink(self, node: PrefixNode) -> None:
        siblings = self.root if node.parent is None else node.parent.children
        if siblings.get(node.key) is node:
            del siblings[node.key]
        del self.node_of_page[node.page]
        if node.cached:
            node.cached = False
            self.cached_pages -= 1

    def pop_subtree(self, node: PrefixNode) -> list[PrefixNode]:
        """Remove ``node`` and every descendant from the index (divergence:
        the subtree's contents are about to stop matching its token path).
        Returns the removed nodes; the caller frees whichever pages are no
        longer referenced."""
        stack, removed = [node], []
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            self._unlink(n)
            removed.append(n)
        return removed

    def lru_cached_leaf(self) -> PrefixNode | None:
        """Least-recently-used evictable node: cached (refcount 0) and
        childless — deeper prefixes evict before the chains they extend, so
        the trie never dangles. Deterministic tie-break on page id."""
        best = None
        for node in self.node_of_page.values():
            if not node.cached or node.children:
                continue
            if best is None or (node.last_used, node.page) < (best.last_used,
                                                              best.page):
                best = node
        return best


class BlockManager:
    """Free-list page allocator + per-slot block tables + page refcounts.

    Slots are step-batch rows (the scheduler's fixed pool). Each slot's
    table maps block index -> page id; unallocated entries hold the trash
    page id (``num_pages``), which the device-side reads never see because
    every read is masked at the slot's live length. With ``prefix_cache``
    enabled, several slots' tables may reference the same page
    (``refcounts`` counts the table references); a write into a shared page
    is resolved copy-on-write before the table mutates.
    """

    def __init__(self, num_pages: int, block_size: int, max_batch: int,
                 capacity: int, *, prefix_cache: bool = False):
        if capacity % block_size:
            raise ValueError(
                f"capacity {capacity} must be a multiple of block_size {block_size} "
                "(the paged view must span exactly the dense capacity for A/B)"
            )
        # fault-injection hook (serve/faults.py): ``hook(slot, new_len) ->
        # True`` forces an *allocating* extend to report failure without
        # mutating any state — exactly the contract a real failed allocation
        # has, so chaos tests can induce pool exhaustion deterministically.
        # The hook is consulted only when the call must actually take pages
        # off the free list (allocation or COW); a decode tick that lands
        # inside an already-allocated block cannot fail and is never asked.
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
        self.refcounts = np.zeros(num_pages, np.int32)  # table refs per page
        self.high_water = 0            # max pages ever off the free list
        self.live_high_water = 0       # max pages ever referenced by a table
        # bumped on every table mutation — consumers key device-side copies
        # on it so steady-state decode ticks skip the host->device upload
        self.version = 0
        # prefix sharing (DESIGN.md §11)
        self.prefix = PrefixCache(block_size) if prefix_cache else None
        # (src, dst) device page copies owed by pending COW resolutions; the
        # scheduler drains this before running the step that writes dst
        self.cow_copies: list[tuple[int, int]] = []
        self.cow_events = 0

    # -------------------------------------------------------- observability
    def bind_registry(self, registry) -> None:
        """Expose pool/prefix state as callback gauges on an obs
        MetricsRegistry (DESIGN.md §14): read lazily at snapshot time, so
        the allocator's hot paths stay untouched — no per-mutation pushes,
        no behavior change."""
        registry.gauge_fn(
            "cache_pages",
            lambda: {"state=in_use": self.pages_in_use,
                     "state=live": self.live_pages,
                     "state=cached": self.cached_pages,
                     "state=free": len(self.free)},
            help="pool pages by state")
        registry.gauge_fn(
            "cache_high_water_pages",
            lambda: {"kind=total": self.high_water,
                     "kind=live": self.live_high_water},
            help="page-pool high-water marks")
        registry.gauge_fn("cache_cow_events", lambda: self.cow_events,
                          help="copy-on-write resolutions so far")
        registry.gauge_fn("cache_table_version", lambda: self.version,
                          help="block-table mutation counter")
        registry.gauge_fn("cache_injected_alloc_failures",
                          lambda: self.injected_failures,
                          help="fault-plan induced allocation failures")
        if self.prefix is not None:
            registry.gauge_fn(
                "cache_prefix",
                lambda: {"kind=hits": self.prefix.hits,
                         "kind=evictions": self.prefix.evictions,
                         "kind=indexed_pages": len(self.prefix)},
                help="prefix-trie hit/eviction/index counters")

    # ------------------------------------------------------------- queries
    @property
    def pages_in_use(self) -> int:
        return self.num_pages - len(self.free)

    @property
    def cached_pages(self) -> int:
        return self.prefix.cached_pages if self.prefix is not None else 0

    @property
    def live_pages(self) -> int:
        """Pages referenced by at least one slot's table (excludes cached
        refcount-0 prefixes the trie is keeping warm)."""
        return self.pages_in_use - self.cached_pages

    def blocks_of(self, slot: int) -> list[int]:
        return [int(p) for p in self.tables[slot, : int(self.blocks_used[slot])]]

    # ----------------------------------------------------------- internals
    def _bump_water(self) -> None:
        self.high_water = max(self.high_water, self.pages_in_use)
        self.live_high_water = max(self.live_high_water, self.live_pages)

    def _alloc_page(self) -> int:
        page = self.free.pop()
        self.refcounts[page] = 1
        return page

    def _dec_ref(self, page: int) -> None:
        """Drop one table reference. At refcount 0 the page returns to the
        free list — unless the prefix trie indexes it, in which case it
        stays allocated as a cached prefix (evictable under pressure)."""
        self.refcounts[page] -= 1
        assert self.refcounts[page] >= 0, f"page {page} refcount underflow"
        if self.refcounts[page] == 0:
            node = self.prefix.node_of_page.get(page) if self.prefix else None
            if node is not None:
                self.prefix.cache_node(node)
            else:
                self.free.append(page)

    def _evict_cached(self, need: int) -> int:
        """Free up to ``need`` cached refcount-0 prefix pages, LRU first.
        This runs inside ``extend`` before it ever reports failure, so
        cache eviction is ordered strictly before the scheduler's
        stall -> ladder -> preempt escalation."""
        freed = 0
        while freed < need and self.prefix is not None:
            victim = self.prefix.lru_cached_leaf()
            if victim is None:
                break
            self.prefix._unlink(victim)
            self.free.append(victim.page)
            self.prefix.evictions += 1
            freed += 1
        return freed

    def _drop_diverging(self, page: int) -> None:
        """An exclusively-owned page is about to be overwritten: its contents
        will stop matching the token path the trie filed it under, so the
        node (and any descendants — their prefixes extend the dying one)
        leave the index. Descendant pages nobody references are freed."""
        node = self.prefix.node_of_page.get(page) if self.prefix else None
        if node is None:
            return
        for n in self.prefix.pop_subtree(node):
            if n.page != page and self.refcounts[n.page] == 0:
                self.free.append(n.page)

    # ----------------------------------------------------------- mutation
    def extend(self, slot: int, new_len: int) -> bool:
        """Grow ``slot`` to cover ``new_len`` tokens. Allocates any missing
        pages and resolves copy-on-write for every *shared* page the write
        range [current len, new_len) touches — the writer gets a fresh page
        and the owed device copy is queued on ``cow_copies``. Returns False
        (state unchanged) if the pool cannot cover the allocation even
        after evicting cached prefixes. O(pages touched) — the per-decode-
        tick call allocates none at all ``block_size - 1`` times out of
        ``block_size``."""
        if new_len > self.max_blocks * self.block_size:
            raise ValueError(f"slot {slot}: {new_len} tokens > table capacity")
        bs = self.block_size
        have = int(self.blocks_used[slot])
        need = -(-new_len // bs)
        start = int(self.lens[slot])
        # already-allocated blocks the write range touches that someone else
        # also references -> copy-on-write
        cow: list[int] = []
        if new_len > start:
            for b in range(start // bs, min(need, have)):
                if self.refcounts[int(self.tables[slot, b])] > 1:
                    cow.append(b)
        shortfall = (need - have) + len(cow)
        if shortfall > 0:
            # injected allocation failures fire only here — on calls that
            # actually take pages — never on a within-block decode tick (a
            # real allocator cannot fail when it has nothing to allocate)
            if self.fault_hook is not None and self.fault_hook(slot, new_len):
                self.injected_failures += 1
                return False
            if shortfall > len(self.free):
                self._evict_cached(shortfall - len(self.free))
            if shortfall > len(self.free):
                return False
        if cow or need > have:
            self.version += 1
        for b in cow:
            old = int(self.tables[slot, b])
            new = self._alloc_page()
            self.cow_copies.append((old, new))
            self.cow_events += 1
            self.tables[slot, b] = new
            self._dec_ref(old)
        if self.prefix is not None and new_len > start:
            # exclusively-owned pages being rewritten diverge from the index
            for b in range(start // bs, min(need, have)):
                self._drop_diverging(int(self.tables[slot, b]))
        for b in range(have, need):
            self.tables[slot, b] = self._alloc_page()
        if need > have:
            self.blocks_used[slot] = need
        self.lens[slot] = new_len
        self._bump_water()
        return True

    def truncate(self, slot: int, new_len: int) -> None:
        """Roll ``slot`` back to ``new_len`` live tokens, dropping every
        table reference past the new high block — the speculative-decoding
        rollback primitive (serve/spec.py): a verify step writes all γ+1
        candidate positions optimistically, then truncates to the accepted
        prefix so rejected drafts never leak KV. Dropped references
        decrement refcounts; a page only returns to the free list when its
        last reference is gone (and it is not a cached prefix). Stale tokens
        inside the retained final page are harmless — every device read is
        masked at the live length. O(pages dropped); never fails
        (shrink-only)."""
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
                self._dec_ref(int(self.tables[slot, b]))
                self.tables[slot, b] = self.trash
            self.blocks_used[slot] = need
        self.lens[slot] = new_len

    def release(self, slot: int) -> None:
        """Drop every table reference of ``slot``. Exclusive pages go back
        to the free list; shared pages survive for their other readers;
        trie-indexed pages whose last reference this was become cached
        prefixes."""
        used = int(self.blocks_used[slot])
        for b in range(used):
            self._dec_ref(int(self.tables[slot, b]))
            self.tables[slot, b] = self.trash
        self.lens[slot] = 0
        self.blocks_used[slot] = 0
        if used:
            self.version += 1

    # ------------------------------------------------------ prefix sharing
    def lookup_prefix(self, tokens, *, now: int = 0
                      ) -> tuple[list[PrefixNode], int]:
        """Longest cached block-aligned prefix of ``tokens``, capped at
        ``len(tokens) - 1`` so at least one prompt token is always computed
        (its logits seed the request's first sample). Returns (nodes,
        matched token count)."""
        if self.prefix is None:
            return [], 0
        cap = (len(tokens) - 1) // self.block_size
        nodes = self.prefix.walk(tokens, min(cap, self.max_blocks), now=now)
        return nodes, len(nodes) * self.block_size

    def fork_prefix(self, slot: int, nodes: list[PrefixNode], *,
                    now: int = 0) -> int:
        """Map an *empty* slot's leading block-table entries onto the pages
        of a matched prefix chain: refcount++ per page, zero allocation,
        zero prefill compute owed for the covered tokens. Cached
        (refcount-0) pages come back to life. Returns tokens covered."""
        if int(self.blocks_used[slot]) or int(self.lens[slot]):
            raise ValueError(f"slot {slot}: fork_prefix needs an empty slot")
        if not nodes:
            return 0
        for b, node in enumerate(nodes):
            if self.refcounts[node.page] == 0:
                self.prefix.uncache_node(node)
            self.refcounts[node.page] += 1
            self.tables[slot, b] = node.page
            node.last_used = now
        self.blocks_used[slot] = len(nodes)
        self.lens[slot] = len(nodes) * self.block_size
        self.version += 1
        self._bump_water()
        return len(nodes) * self.block_size

    def register_prefix(self, slot: int, seq, *, now: int = 0) -> int:
        """Index ``slot``'s committed full blocks under the token sequence
        ``seq`` (``seq[:lens[slot]]`` must be exactly the tokens whose KV
        the slot's pages hold). Later requests sharing the prefix fork these
        pages instead of recomputing them. Returns nodes added."""
        if self.prefix is None:
            return 0
        nblocks = min(int(self.lens[slot]) // self.block_size,
                      len(seq) // self.block_size,
                      int(self.blocks_used[slot]))
        if nblocks <= 0:
            return 0
        pages = [int(self.tables[slot, b]) for b in range(nblocks)]
        return self.prefix.register(seq, nblocks, pages, now=now)

    def table_shard(self, rank: int, tp: int) -> np.ndarray:
        """Group ``rank``'s view of the block tables on a tp-way mesh: the
        group owns page ``p`` iff ``p % tp == rank`` (the trash page belongs
        to everyone), and entries it does not own are masked to trash, so
        the ``tp`` shards partition the global table: every live entry
        appears in exactly one shard. An ownership partition for
        attribution; the KV data is head-sharded (every rank holds a head
        slice of every page)."""
        if not (0 <= rank < tp):
            raise ValueError(f"rank {rank} out of range for tp={tp}")
        t = self.tables.copy()
        t[(t != self.trash) & (t % tp != rank)] = self.trash
        return t

    def drain_cow_copies(self) -> list[tuple[int, int]]:
        """Hand the pending (src, dst) page copies to the caller (the
        scheduler performs them on every device pool sharing these tables
        before the next step writes dst)."""
        out, self.cow_copies = self.cow_copies, []
        return out

    # --------------------------------------------------------- validation
    def check_invariants(self) -> None:
        """Refcounts == table references, live ⊎ cached ⊎ free partitions
        the pool, trie state consistent. Scans the full tables (not
        blocks_used) so it also catches a bookkeeping drift between the
        two."""
        refs: dict[int, int] = {}
        for row in self.tables:
            for p in row:
                if p != self.trash:
                    refs[int(p)] = refs.get(int(p), 0) + 1
        assert sum(int(b) for b in self.blocks_used) == sum(refs.values()), (
            "blocks_used out of sync with tables"
        )
        for p in range(self.num_pages):
            assert int(self.refcounts[p]) == refs.get(p, 0), (
                f"page {p}: refcount {int(self.refcounts[p])} != "
                f"{refs.get(p, 0)} table references"
            )
        live = set(refs)
        free = set(self.free)
        assert len(self.free) == len(free), "free-list duplicate"
        assert not (live & free), "referenced page on free list"
        cached: set[int] = set()
        if self.prefix is not None:
            for p, node in self.prefix.node_of_page.items():
                assert node.page == p
                assert node.cached == (refs.get(p, 0) == 0), (
                    f"page {p}: cached flag out of sync with refcount"
                )
                if node.cached:
                    cached.add(p)
                if node.parent is not None:
                    assert node.parent.children.get(node.key) is node
            assert len(cached) == self.prefix.cached_pages
            assert not (cached & free), "cached page on free list"
        assert len(live) + len(cached) + len(free) == self.num_pages, (
            "orphaned pages"
        )
        assert self.pages_in_use <= self.num_pages
        for s in range(self.tables.shape[0]):
            need = -(-int(self.lens[s]) // self.block_size)
            assert len(self.blocks_of(s)) >= need, f"slot {s} under-backed"



def cache_bytes(caches) -> int:
    """Total bytes of the tensor leaves of a cache tree (the paged pools)."""
    if isinstance(caches, dict):
        return sum(cache_bytes(v) for v in caches.values())
    if isinstance(caches, (tuple, list)):
        return sum(cache_bytes(v) for v in caches)
    if isinstance(caches, torch.Tensor):
        return caches.numel() * caches.element_size()
    return 0


def _tensors(tree) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def copy_pages(pools, copies: list[tuple[int, int]], device) -> None:
    """Perform copy-on-write page copies ``leaf[:, dst] = leaf[:, src]`` on
    every tensor leaf of ``pools`` (cache trees whose leaves are (layers,
    num_pages + 1, block_size, ...), int8 scales included). When no page is
    both a source and a destination, one ``index_select`` / ``index_copy_``
    a leaf does them all; otherwise the pairs go one by one in queue order.
    The copies run on the pools' device, queued on its stream."""
    if not copies:
        return
    leaves = _tensors(pools)
    src = [s_ for s_, _ in copies]
    dst = [d for _, d in copies]
    if set(src).isdisjoint(dst):
        si = torch.tensor(src, dtype=torch.int64).to(device)
        di = torch.tensor(dst, dtype=torch.int64).to(device)
        for leaf in leaves:
            leaf.index_copy_(1, di, leaf.index_select(1, si))
        return
    for s_, d in copies:
        for leaf in leaves:
            leaf[:, d] = leaf[:, s_]
