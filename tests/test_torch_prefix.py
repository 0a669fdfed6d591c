"""Port parity for prefix caching (the reference's ``tests/test_paged.py``
prefix-cache cases): the port's refcounted ``BlockManager`` (trie, cached
prefixes, LRU eviction, copy-on-write) and its ``Scheduler`` under
``rc.prefix_cache``, plain PyTorch versions on the CPU.

The allocator units run the reference's assertions on both packages'
managers; the randomized invariant test drives both managers with the same
op sequences and requires identical tables, refcounts, free lists, queued
copies and trie contents after every op. The scheduler tests serve the same
requests through both schedulers (the reference's weights carried across by
``repro_torch.interop``): greedy tokens, per-request ``cycles_by_bits``,
prefix hits, reused and computed prompt tokens, ``health()`` and
``cache_stats()`` must be identical. The copy-on-write drain is checked on
every leaf of the target and the draft pools, CPU tensors, exactly."""

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs.base import RunConfig, get_config
from repro.models import init as j_init
from repro.serve import Request as JRequest
from repro.serve import Scheduler as JScheduler
from repro.serve.cache import BlockManager as JBlockManager
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import get_config as t_get_config
from repro_torch.interop import params_from_reference
from repro_torch.serve import Request, Scheduler
from repro_torch.serve.cache import BlockManager

torch.set_float32_matmul_precision("highest")
ARCH = "qwen3-0.6b_smoke"
RC_KW = dict(dtype="float32", param_dtype="float32", remat="none", prefill_chunk=5,
             kv_cache_dtype="int8", kv_layout="paged", block_size=4)
MANAGERS = {"ref": JBlockManager, "port": BlockManager}


@pytest.fixture(scope="module")
def model():
    """(reference params, port params) of qwen3-0.6b_smoke."""
    params = j_init(get_config(ARCH), RunConfig(**RC_KW), jax.random.PRNGKey(0))
    return params, params_from_reference(jax.tree.map(np.asarray, params), device="cpu")


# ------------------------------------------------------------ allocator units
@pytest.mark.parametrize("pkg", sorted(MANAGERS))
def test_block_manager_cow_unit(pkg):
    """A write into a page another slot still references retables the
    writer onto a fresh page, queues exactly one (src, dst) copy and moves
    one refcount; rewriting an exclusively owned registered page drops its
    trie subtree."""
    mgr = MANAGERS[pkg](8, 4, 2, 16, prefix_cache=True)
    assert mgr.extend(0, 9)
    seq = list(range(9))
    mgr.register_prefix(0, seq, now=0)
    nodes, matched = mgr.lookup_prefix(seq, now=1)
    assert matched == 8                        # (9-1)//4 = 2 full blocks
    assert mgr.fork_prefix(1, nodes, now=1) == 8
    shared = mgr.blocks_of(0)[:2]
    assert mgr.blocks_of(1) == shared
    assert all(int(mgr.refcounts[p]) == 2 for p in shared)
    mgr.check_invariants()

    mgr.truncate(1, 7)                         # roll the fork back INTO the shared region
    assert mgr.blocks_of(1) == shared          # truncate drops refs, not these
    assert mgr.extend(1, 8)
    assert mgr.cow_events == 1
    copies = mgr.drain_cow_copies()
    assert len(copies) == 1 and copies[0][0] == shared[1]
    assert mgr.blocks_of(1)[1] == copies[0][1] != shared[1]
    assert int(mgr.refcounts[shared[1]]) == 1
    mgr.check_invariants()

    before = len(mgr.prefix)
    mgr.truncate(0, 7)
    assert mgr.extend(0, 8)
    assert mgr.cow_events == 1                 # refcount was 1: no copy
    assert len(mgr.prefix) < before
    mgr.check_invariants()


@pytest.mark.parametrize("pkg", sorted(MANAGERS))
def test_block_manager_cached_prefix_retention_and_eviction(pkg):
    """Releasing the last reference keeps trie-indexed pages as refcount-0
    cached prefixes; a fork revives them; pool pressure evicts them inside
    ``extend`` before it could fail."""
    mgr = MANAGERS[pkg](4, 4, 2, 16, prefix_cache=True)
    assert mgr.extend(0, 8)
    mgr.register_prefix(0, list(range(8)), now=0)
    mgr.release(0)
    assert mgr.pages_in_use == 2 and mgr.cached_pages == 2
    assert mgr.live_pages == 0
    mgr.check_invariants()
    nodes, matched = mgr.lookup_prefix(list(range(8)) + [9], now=1)
    assert matched == 8
    mgr.fork_prefix(1, nodes, now=1)
    assert mgr.cached_pages == 0 and mgr.live_pages == 2
    mgr.release(1)
    assert mgr.cached_pages == 2
    assert mgr.extend(1, 16)
    assert mgr.prefix.evictions == 2 and len(mgr.prefix) == 0
    mgr.check_invariants()


@pytest.mark.parametrize("pkg", sorted(MANAGERS))
def test_block_manager_lru_evicts_leaves_before_parents(pkg):
    mgr = MANAGERS[pkg](3, 4, 2, 16, prefix_cache=True)
    assert mgr.extend(0, 12)
    mgr.register_prefix(0, list(range(12)), now=5)
    mgr.release(0)
    chain = [n.page for n in mgr.prefix.walk(list(range(12)), 3, now=5)]
    assert len(chain) == 3
    assert mgr.extend(1, 4)                    # evicts one page: the deepest
    assert mgr.prefix.evictions == 1
    assert chain[2] not in mgr.prefix.node_of_page
    assert chain[0] in mgr.prefix.node_of_page
    mgr.check_invariants()


def _state(mgr):
    """Everything the allocator decided, comparable across packages."""
    trie = sorted((p, n.key, None if n.parent is None else n.parent.page, n.cached,
                   n.last_used) for p, n in mgr.prefix.node_of_page.items())
    return (mgr.tables.tolist(), mgr.lens.tolist(), mgr.blocks_used.tolist(),
            mgr.refcounts.tolist(), list(mgr.free), list(mgr.cow_copies), mgr.cow_events,
            mgr.high_water, mgr.live_high_water, mgr.version, mgr.prefix.cached_pages,
            mgr.prefix.hits, mgr.prefix.evictions, trie)


def _drive_both(seed, ops):
    """The reference's randomized refcount test on both managers at once:
    the same op sequence, the reference's assertions on the port's manager,
    and identical state after every op."""
    bs, slots = 4, 3
    rng = np.random.default_rng(seed)
    mgrs = [JBlockManager(10, bs, slots, bs * 5, prefix_cache=True),
            BlockManager(10, bs, slots, bs * 5, prefix_cache=True)]
    mgr = mgrs[1]
    lens = [0] * slots
    seqs = [[] for _ in range(slots)]
    for slot, op, amount in ops:
        slot %= slots
        if op == 0:      # extend + commit `amount` tokens
            new_len = min(lens[slot] + amount, mgr.max_blocks * bs)
            start_blk = lens[slot] // bs
            snap = (mgr.pages_in_use, mgr.blocks_of(slot), mgr.refcounts.copy().tolist())
            ok = [m.extend(slot, new_len) for m in mgrs]
            assert ok[0] == ok[1]
            if ok[1]:
                while len(seqs[slot]) < new_len:
                    seqs[slot].append(int(rng.integers(0, 3)))
                lens[slot] = new_len
                for b in range(start_blk, -(-new_len // bs)):
                    assert int(mgr.refcounts[int(mgr.tables[slot, b])]) == 1, (
                        "write range page shared after extend")
            else:
                assert (mgr.pages_in_use, mgr.blocks_of(slot),
                        mgr.refcounts.copy().tolist()) == snap
        elif op == 1:
            for m in mgrs:
                m.release(slot)
            lens[slot], seqs[slot] = 0, []
        elif op == 2:    # speculative rollback
            new_len = max(lens[slot] - amount, 0)
            for m in mgrs:
                m.truncate(slot, new_len)
            lens[slot] = new_len
            seqs[slot] = seqs[slot][:new_len]
        elif op == 3:    # index committed full blocks
            added = [m.register_prefix(slot, seqs[slot][: lens[slot]], now=amount)
                     for m in mgrs]
            assert added[0] == added[1]
        else:            # lookup + fork onto an empty slot
            probe = seqs[slot][: lens[slot]] + [int(rng.integers(0, 3))]
            found = [m.lookup_prefix(probe, now=amount) for m in mgrs]
            assert [n.page for n in found[0][0]] == [n.page for n in found[1][0]]
            nodes, matched = found[1]
            dst = (slot + 1) % slots
            if nodes and lens[dst] == 0 and int(mgr.blocks_used[dst]) == 0:
                for m, (nd, _) in zip(mgrs, found):
                    assert m.fork_prefix(dst, nd, now=amount) == matched
                lens[dst] = matched
                seqs[dst] = probe[:matched]
        for m in mgrs:
            m.check_invariants()
        assert _state(mgrs[1]) == _state(mgrs[0])
        for s in range(slots):
            assert len(mgr.blocks_of(s)) * bs >= lens[s]


_OPS = st.lists(st.tuples(st.integers(0, 3), st.integers(0, 4), st.integers(1, 9)),
                min_size=1, max_size=50)


@settings(deadline=None, max_examples=60)
@given(st.integers(0, 2 ** 31 - 1), _OPS)
def test_block_manager_refcount_invariants_match_reference(seed, ops):
    """Random interleavings of extend, release, rollback, register and
    lookup+fork keep the partition (live ⊎ cached ⊎ free == pool, Σ table
    references == refcounts), keep every page of a write range exclusive
    after extend, and leave both managers in the same state."""
    _drive_both(seed, ops)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_block_manager_refcount_fixed_seeds(seed):
    """The same property on fixed long op sequences (runs without
    hypothesis's search)."""
    rng = np.random.default_rng(100 + seed)
    ops = [(int(rng.integers(0, 4)), int(rng.integers(0, 5)), int(rng.integers(1, 10)))
           for _ in range(200)]
    _drive_both(seed, ops)


# ----------------------------------------------------------- scheduler parity
def _both(model, prompts, *, rc_kw, max_new=4, max_batch=3, sequential=False, warm=None,
          arch=ARCH, **kw):
    """The same requests through the reference's and the port's Scheduler
    (capacity 32, ``arch``). ``sequential`` runs each request to the end before
    submitting the next; ``warm`` is a prompt served alone first."""
    params, tparams = model
    out = []
    for pkg in ("ref", "port"):
        rc = (RunConfig if pkg == "ref" else TRunConfig)(**dict(RC_KW, **rc_kw))
        cfg = (get_config if pkg == "ref" else t_get_config)(arch)
        extra = {} if pkg == "ref" else {"device": "cpu"}
        s = (JScheduler if pkg == "ref" else Scheduler)(
            cfg, rc, params if pkg == "ref" else tparams, capacity=32, max_batch=max_batch,
            **kw, **extra)
        req = JRequest if pkg == "ref" else Request
        rid0 = 0
        if warm is not None:
            s.submit(req(rid=0, prompt=list(warm), max_new=max_new))
            s.run()
            rid0 = 1
        for rid, p in enumerate(prompts, start=rid0):
            s.submit(req(rid=rid, prompt=list(p), max_new=max_new))
            if sequential:
                s.run()
        s.run()
        out.append((s, {r.rid: list(r.out) for r in s.finished}))
    return out


def _agree(ref, port):
    """Everything the two schedulers decided and metered."""
    (js, jo), (ts, to) = ref, port
    assert to == jo
    assert ts.final_kv_lens == js.final_kv_lens
    for k in ("prefix_hits", "prefix_tokens_reused", "prefill_tokens_computed",
              "drafted_tokens", "accepted_draft_tokens", "ticks"):
        assert getattr(ts, k) == getattr(js, k), k
    h = lambda s: {k: v for k, v in s.health().items() if k not in ("kernels", "latency")}
    assert h(ts) == h(js)
    assert ts.cache_stats() == js.cache_stats()
    if ts.track_energy:
        e = lambda s: {x["rid"]: (x["cycles_by_bits"], x.get("draft_cycles_by_bits"))
                       for x in s.energy_summary()}
        assert e(ts) == e(js)
        assert ({m.rid: m.cached_prompt_tokens for m in ts.finished_meters}
                == {m.rid: m.cached_prompt_tokens for m in js.finished_meters})
    ts.mgr.check_invariants()


def test_prefix_cache_bitexact_and_zero_cycle_reuse(model):
    """Sequential trace: with the cache on, the second request sharing the
    first's prefix emits the uncached tokens, the first request's cycles
    are identical to the uncached run's, the second's drop at every width
    (its 3 forked blocks charge nothing), and both packages agree on all
    of it."""
    rng = np.random.default_rng(7)
    shared = rng.integers(0, 256, 13).tolist()
    prompts = [shared + rng.integers(0, 256, 3 + i).tolist() for i in range(2)]
    kw = dict(max_batch=1, sequential=True, track_energy=True)
    off = _both(model, prompts, rc_kw=dict(quant_policy="attn.*=int8,*=int2"), **kw)
    on = _both(model, prompts, rc_kw=dict(quant_policy="attn.*=int8,*=int2",
                                          prefix_cache=True), **kw)
    _agree(*off)
    _agree(*on)
    (s_off, out_off), (s_on, out_on) = off[1], on[1]
    assert out_on == out_off
    cyc_off = {e["rid"]: e["cycles_by_bits"] for e in s_off.energy_summary()}
    cyc_on = {e["rid"]: e["cycles_by_bits"] for e in s_on.energy_summary()}
    assert cyc_off[0] == cyc_on[0]
    assert all(cyc_on[1][b] < cyc_off[1][b] for b in cyc_off[1])
    meters = {m.rid: m for m in s_on.finished_meters}
    assert meters[1].cached_prompt_tokens == 12 and meters[0].cached_prompt_tokens == 0
    assert s_on.prefix_hits == 1 and s_on.prefix_tokens_reused == 12
    assert s_on.mgr.live_pages == 0
    assert s_on.mgr.pages_in_use == s_on.mgr.cached_pages > 0


def test_prefix_cache_concurrent_shared_prompt(model):
    """One warm request, then a burst of four sharing its prompt: identical
    greedy tokens, every burst request forks the prefix, at least 2x fewer
    prefill tokens computed and a lower live-page high-water — in both
    packages alike."""
    rng = np.random.default_rng(8)
    shared = rng.integers(0, 256, 17).tolist()
    burst = [shared + rng.integers(0, 256, 2 + i).tolist() for i in range(4)]
    warm = list(shared) + [1, 2, 3]
    off = _both(model, burst, rc_kw=dict(quant_policy="*=int8"), warm=warm)
    on = _both(model, burst, rc_kw=dict(quant_policy="*=int8", prefix_cache=True), warm=warm)
    _agree(*off)
    _agree(*on)
    (s_off, out_off), (s_on, out_on) = off[1], on[1]
    assert out_off == out_on
    assert s_on.prefix_hits == 4
    assert s_on.prefix_tokens_reused == 4 * 16
    assert s_on.prefill_tokens_computed * 2 <= s_off.prefill_tokens_computed
    assert s_on.mgr.live_high_water < s_off.mgr.live_high_water
    assert s_on.mgr.live_pages == 0


def test_prefix_cache_with_speculative_decode(model):
    """Prefix forking + an int2 speculative draft emit the plain uncached
    tokens, fork in both packages alike, and keep the one BlockManager's
    refcounts consistent through fork and rollback."""
    rng = np.random.default_rng(9)
    shared = rng.integers(0, 256, 9).tolist()
    prompts = [shared + rng.integers(0, 256, 2 + i).tolist() for i in range(3)]
    kw = dict(max_new=5, max_batch=1, sequential=True, track_energy=True)
    plain = _both(model, prompts, rc_kw=dict(quant_policy="*=int8"), **kw)
    spec = _both(model, prompts, rc_kw=dict(quant_policy="*=int8", prefix_cache=True,
                                            spec_gamma=2, draft_policy="*=int2"), **kw)
    _agree(*spec)
    assert spec[1][1] == plain[1][1] == plain[0][1]
    assert spec[1][0].prefix_hits == 2
    assert spec[1][0].drafted_tokens > 0


def test_prefix_cache_with_spec_mla_moe_matches_reference():
    """The composition on deepseek-v2-lite-16b_smoke (MLA pools, MoE
    layers) under per-token scales: both packages fork, draft, accept and
    meter alike, with the cache alone and with speculation on top, and
    speculation changes no token of the cached run. (A fork starts the
    prefill at the forked length, which moves the chunk boundaries; on a
    capacity-routed MoE model that moves the router's drops, so the cached
    run's tokens may differ from the uncached run's — in the reference
    too.)"""
    arch = "deepseek-v2-lite-16b_smoke"
    policy = "mla.*=int8:per_token,*=int2:per_token"
    params = j_init(get_config(arch), RunConfig(**dict(RC_KW, quant_policy=policy)),
                    jax.random.PRNGKey(0))
    model = (params, params_from_reference(jax.tree.map(np.asarray, params), device="cpu"))
    rng = np.random.default_rng(9)
    shared = rng.integers(0, get_config(arch).vocab_size, 9).tolist()
    prompts = [shared + rng.integers(0, 64, 2 + i).tolist() for i in range(2)]
    kw = dict(max_new=4, max_batch=1, sequential=True, track_energy=True, arch=arch)
    cached = _both(model, prompts, rc_kw=dict(quant_policy=policy, prefix_cache=True), **kw)
    spec = _both(model, prompts, rc_kw=dict(quant_policy=policy, prefix_cache=True,
                                            spec_gamma=2), **kw)
    _agree(*cached)
    _agree(*spec)
    assert spec[1][1] == cached[1][1]
    assert spec[1][0].prefix_hits == 1 and spec[1][0].prefix_tokens_reused == 8
    assert spec[1][0].drafted_tokens > 0


def _cow_scheduler(model):
    """A prefix + spec scheduler after one served request, with one forced
    copy-on-write queued: the registered prefix forked onto both slots and
    slot 0 rolled back into the shared second block, then extended."""
    _, tparams = model
    rc = TRunConfig(**dict(RC_KW, quant_policy="*=int8", prefix_cache=True, spec_gamma=2))
    s = Scheduler(t_get_config(ARCH), rc, tparams, capacity=32, max_batch=2, device="cpu")
    rng = np.random.default_rng(10)
    s.submit(Request(rid=0, prompt=rng.integers(0, 256, 9).tolist(), max_new=2))
    s.run()
    seq = s.finished[0].prompt + s.finished[0].out
    nodes, matched = s.mgr.lookup_prefix(seq, now=99)
    assert matched >= 8
    s.mgr.fork_prefix(0, nodes[:2], now=99)
    s.mgr.fork_prefix(1, nodes[:2], now=99)
    s.mgr.truncate(0, 7)
    assert s.mgr.extend(0, 8)
    assert s.mgr.cow_events == 1
    return s


def test_scheduler_cow_device_copy(model):
    """The drain copies the page in EVERY leaf of the target pools and the
    draft pool, int8 scales included: after it, each leaf's destination page
    equals its seeded source page exactly."""
    s = _cow_scheduler(model)
    src, dst = s.mgr.cow_copies[0]
    gen = torch.Generator().manual_seed(11)
    leaves = s._pools()
    target = [t for g in s.caches for blk in g.values() for t in blk.values()]
    assert s.spec is not None and len(leaves) == 2 * len(target)
    assert any(t.dtype == torch.int8 for t in leaves) and any(
        t.dtype == torch.float32 for t in leaves)           # pools and their scales
    for leaf in leaves:
        fill = torch.randint(-100, 100, leaf[:, src].shape, generator=gen)
        leaf[:, src] = fill.to(leaf.dtype)
    want = [leaf[:, src].clone() for leaf in leaves]
    s._drain_cow()
    assert not s.mgr.cow_copies
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf[:, dst], w)
        assert torch.equal(leaf[:, src], w)
    s.mgr.check_invariants()


def test_cow_drain_chained_pairs_apply_in_order(model):
    """When a page is both a source and a destination in one drain, the
    pairs apply one by one in queue order (a batched gather would read the
    old contents): (a -> b), (b -> c) leaves a's contents in c."""
    s = _cow_scheduler(model)
    s.mgr.drain_cow_copies()
    a, b, c = 0, 1, 2
    leaves = s._pools()
    for k, leaf in enumerate(leaves):
        for page, v in ((a, 1), (b, 2), (c, 3)):
            leaf[:, page] = v + k % 5
    s.mgr.cow_copies = [(a, b), (b, c)]
    s._drain_cow()
    for leaf in leaves:
        assert torch.equal(leaf[:, c], leaf[:, a]) and torch.equal(leaf[:, b], leaf[:, a])


def test_prefix_counters_in_health_and_registry(model):
    """health()["prefix_cache"] and the registry's cache gauges carry the
    trie's real numbers (hits, indexed and cached pages, COW events)."""
    _, tparams = model
    rc = TRunConfig(**dict(RC_KW, quant_policy="*=int8", prefix_cache=True))
    s = Scheduler(t_get_config(ARCH), rc, tparams, capacity=32, max_batch=2, device="cpu")
    rng = np.random.default_rng(12)
    shared = rng.integers(0, 256, 12).tolist()
    for rid in range(3):
        s.submit(Request(rid=rid, prompt=shared + [rid + 1], max_new=2))
        s.run()
    h = s.health()["prefix_cache"]
    assert h["enabled"] and h["hits"] == 2 and h["tokens_reused"] == 24
    assert h["indexed_pages"] == len(s.mgr.prefix) > 0
    assert h["cached_pages"] == s.mgr.cached_pages == s.mgr.pages_in_use
    snap = s.metrics.snapshot()
    assert snap["cache_prefix"]["values"]["kind=hits"] == 2
    assert snap["cache_pages"]["values"]["state=cached"] == s.mgr.cached_pages


def test_prefix_cache_off_keeps_plain_path(model):
    """With the cache off nothing is indexed or forked and health() reports
    the reference's disabled entry."""
    _, tparams = model
    s = Scheduler(t_get_config(ARCH), TRunConfig(**dict(RC_KW, quant_policy="*=int8")),
                  tparams, capacity=32, max_batch=2, device="cpu")
    s.submit(Request(rid=0, prompt=list(range(9)), max_new=2))
    s.run()
    assert s.mgr.prefix is None and s.mgr.pages_in_use == 0
    assert s.health()["prefix_cache"] == {"enabled": False,
                                          "prefill_tokens_computed": 9}
