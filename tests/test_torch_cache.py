"""Port parity: the port's copy of the paged-pool ``BlockManager`` against
the reference's on seeded tapes of extend / truncate / release ops
(including pool exhaustion). Every return value and every piece of
allocator state the port keeps must be identical after every op."""

import numpy as np
import pytest

from repro.serve.cache import BlockManager as JBM
from repro.serve.cache import num_pages_for as j_num_pages_for
from repro_torch.serve.cache import BlockManager as TBM
from repro_torch.serve.cache import num_pages_for as t_num_pages_for


def _state(m):
    return (m.tables.tolist(), m.lens.tolist(), m.blocks_used.tolist(),
            list(m.free), m.high_water, m.version, m.pages_in_use)


def _tape(seed, n_ops, slots, cap):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n_ops):
        kind = rng.choice(["extend", "extend", "extend", "truncate", "release"])
        ops.append((str(kind), int(rng.integers(slots)), int(rng.integers(0, cap + 1))))
    return ops


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_alloc_tape_identical(seed):
    pages, bs, slots, cap = 10, 4, 3, 24
    j, t = JBM(pages, bs, slots, cap), TBM(pages, bs, slots, cap)
    for kind, slot, n in _tape(seed, 200, slots, cap):
        if kind == "extend":
            assert j.extend(slot, n) == t.extend(slot, n)
        elif kind == "truncate":
            n = min(n, int(j.lens[slot]))
            j.truncate(slot, n)
            t.truncate(slot, n)
        else:
            j.release(slot)
            t.release(slot)
        assert _state(j) == _state(t)
        t.check_invariants()


@pytest.mark.parametrize("capacity,block_size,slots", [(24, 4, 3), (256, 16, 4), (17, 16, 2)])
def test_num_pages_for_matches_reference(capacity, block_size, slots):
    assert t_num_pages_for(capacity, block_size, slots) == j_num_pages_for(
        capacity, block_size, slots)
