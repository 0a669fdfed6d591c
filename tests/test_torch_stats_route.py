"""Port parity for the cycle-statistics routes of ``csrc/unary_stats.cu`` and
the int8 GEMM's stats (``csrc/tugemm_int8.cu`` on ``tugemm_mainloop.cuh``),
on CPU tensors, i.e. their plain PyTorch versions and Python emulations of
the kernels' grids, against the reference's ``repro.kernels.ops`` (its
Pallas kernels in interpret mode) on the same numpy inputs.

Three routes produce a GEMM's ``TuGemmStats`` on the card:
1. ``ops.matmul_int8(collect_stats=True)``: the int8 GEMM takes the step
   maxima from its own tiles, ``unary_stats.tugemm_stats`` assembles them;
2. ``ops.matmul_fused``: the same assembly of the fused kernel's maxima;
3. ``ops.unary_step_stats``: one launch takes both operands' maxima, then the
   same assembly.
The plain path takes each route through the wrappers' plain versions.
Everything is integer: tolerance 0, dtypes included. The reference's
Pallas stats path refuses a K whose two paddings disagree (K = 333: its
column-max block does not divide its padded K), so such a shape is held
against the reference's XLA twin only."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import unary_stats as tstats
from repro_torch.kernels.ref import assemble_stats_ref
from repro_torch.kernels.tugemm_fused import BM, KC, split_plan
from repro_torch.kernels.tugemm_int8 import tugemm_int8

FIELDS = ("step_cycles", "serial_cycles", "parallel_cycles", "max_abs", "act_max")
DTYPES = (torch.int32, torch.int64, torch.int32, torch.int32, torch.int32)
# (M, K, N): ragged, two M tiles, K % 64 != 0 with a short B
SHAPES = [(37, 333, 65), (70, 130, 40), (9, 100, 24)]


def _int8(rng, shape):
    a = rng.integers(-128, 128, shape).astype(np.int8)
    a.flat[0] = -128
    a.flat[-1] = -128      # |-128| must count 128 on both ends of a row
    return a


def _operands(shape):
    M, K, N = shape
    rng = np.random.default_rng(M * 7 + K + N)
    a, b = _int8(rng, (M, K)), _int8(rng, (K, N))
    b[1] = 0               # an all-zero row of B: the step still costs its A max
    a[:, 2] = 0            # an all-zero column of A: the step costs nothing
    return a, b


def _assert_stats(jst, fields):
    """Every field equal to the reference's, with the port's plain dtypes."""
    for f, want_dtype, got in zip(FIELDS, DTYPES, fields):
        assert got.dtype == want_dtype, (f, got.dtype)
        np.testing.assert_array_equal(np.asarray(getattr(jst, f)), got.numpy(), err_msg=f)


def _pallas_takes(K):
    """Whether the reference's Pallas stats path takes K (its paddings)."""
    (bk, kp), (bk2, kp2) = jops._block(K, 512), jops._block(K, 256)
    kpad = max(kp, kp2)
    return kpad % min(bk, kpad) == 0 and kpad % min(bk2, kpad) == 0


def _reference(a, b, impl="pallas_interpret"):
    if not _pallas_takes(a.shape[1]):
        impl = "xla"
    return jops.unary_step_stats(jnp.asarray(a), jnp.asarray(b), impl=impl)


CASES = [(s, impl) for s in SHAPES for impl in ("xla", "pallas_interpret")
         if impl == "xla" or _pallas_takes(s[1])]


@pytest.mark.parametrize("shape,impl", CASES)
def test_matmul_int8_stats_match_the_reference(shape, impl):
    a, b = _operands(shape)
    jy, jst = jops.matmul_int8(jnp.asarray(a), jnp.asarray(b), collect_stats=True, impl=impl)
    ty, tst = tops.matmul_int8(torch.from_numpy(a), torch.from_numpy(b), collect_stats=True)
    np.testing.assert_array_equal(np.asarray(jy), ty.numpy())
    _assert_stats(jst, tuple(tst))


@pytest.mark.parametrize("shape,impl", CASES)
def test_gemm_route_plain_versions_match_the_reference(shape, impl):
    """The card's route of ``ops.matmul_int8(collect_stats=True)``, each
    step by its plain version: the GEMM's (1, K) / (K, 1) maxima, then the
    assembly."""
    a, b = _operands(shape)
    K = a.shape[1]
    y, ca, rb = tugemm_int8(torch.from_numpy(a), torch.from_numpy(b), collect_stats=True)
    assert ca.shape == (1, K) and rb.shape == (K, 1)
    assert ca.dtype == rb.dtype == torch.int32
    jca, jrb, _ = jref.unary_stats_ref(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(np.asarray(jca), ca.reshape(-1).numpy())
    np.testing.assert_array_equal(np.asarray(jrb), rb.reshape(-1).numpy())
    np.testing.assert_array_equal(np.asarray(jops.matmul_int8(jnp.asarray(a), jnp.asarray(b),
                                                              impl=impl)), y.numpy())
    _assert_stats(_reference(a, b, impl), tstats.tugemm_stats(ca, rb, K))


@pytest.mark.parametrize("shape,impl", CASES)
def test_unary_step_stats_match_the_reference(shape, impl):
    a, b = _operands(shape)
    jst = _reference(a, b, impl)
    _assert_stats(jst, tuple(tops.unary_step_stats(torch.from_numpy(a), torch.from_numpy(b))))
    _assert_stats(jst, tstats.unary_step_stats(torch.from_numpy(a), torch.from_numpy(b)))


# --------------------- route 1: which blocks of the int8 grid write ca and rb
def _int8_stats_emulation(a, b, sms):
    """``csrc/tugemm_int8.cu``'s stats under ``split_plan`` (one plane): block
    (K slice s, N tile nt, M tile mt) holds rows [mt·64, +64) of A and
    columns [nt·bn, +bn) of B for the W rows of its chunks; ca[k] is merged
    by max only from the blocks of N tile 0, rb[k] only from those of M tile
    0. Returns (ca, rb, writers): writers[k] counts the blocks that wrote
    ca[k] and rb[k] (each k must be covered)."""
    M, K = a.shape
    N = b.shape[1]
    bn, splits, chunks = split_plan(M, N, K, 1, sms)
    ai, bi = a.to(torch.int32).abs(), b.to(torch.int32).abs()
    ca = torch.zeros(K, dtype=torch.int32)
    rb = torch.zeros(K, dtype=torch.int32)
    writers = torch.zeros((2, K), dtype=torch.int32)
    for mt in range(-(-M // BM)):
        for nt in range(-(-N // bn)):
            for s in range(splits):
                k0, k1 = s * chunks * KC, min((s + 1) * chunks * KC, K)
                if k0 >= k1:
                    continue
                if nt == 0:
                    tile = ai[mt * BM:(mt + 1) * BM, k0:k1].amax(0)
                    ca[k0:k1] = torch.maximum(ca[k0:k1], tile)
                    writers[0, k0:k1] += 1
                if mt == 0:
                    tile = bi[k0:k1, nt * bn:(nt + 1) * bn].amax(1)
                    rb[k0:k1] = torch.maximum(rb[k0:k1], tile)
                    writers[1, k0:k1] += 1
    return ca, rb, writers


@pytest.mark.parametrize("sms", [2, 4, 132])
@pytest.mark.parametrize("shape", SHAPES + [(4, 1024, 96), (64, 200, 300)])
def test_int8_stats_block_coverage_matches_the_reference(shape, sms):
    a, b = _operands(shape)
    M, K, N = shape
    ca, rb, writers = _int8_stats_emulation(torch.from_numpy(a), torch.from_numpy(b), sms)
    # every step is written for both operands: by the M tiles (ca) and the N
    # tiles (rb) of its own K slice
    bn = split_plan(M, N, K, 1, sms)[0]
    assert (writers[0] == -(-M // BM)).all() and (writers[1] == -(-N // bn)).all()
    jca, jrb, _ = jref.unary_stats_ref(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(np.asarray(jca), ca.numpy())
    np.testing.assert_array_equal(np.asarray(jrb), rb.numpy())
    _assert_stats(_reference(a, b),
                  tstats.tugemm_stats(ca.reshape(1, K), rb.reshape(K, 1), K))


# ------------------------------- route 2: the assembly of plane-major maxima
@pytest.mark.parametrize("planes,Kw,K", [(1, 40, 40), (1, 64, 37), (2, 50, 97),
                                         (4, 30, 113), (4, 64, 200)])
def test_finisher_plain_version_matches_the_reference_assembly(planes, Kw, K):
    rng = np.random.default_rng(planes * 100 + K)
    ca_log = rng.integers(0, 129, K).astype(np.int32)
    rb_log = rng.integers(0, 129, K).astype(np.int32)
    rb_log[::7] = 0                    # zero rows of W: step costs its A max
    ca_log[3] = 128
    # plane-major, with junk past the logical K that must not count
    ca_pm = np.full(planes * Kw, 127, np.int32)
    rb_pm = np.full(planes * Kw, 126, np.int32)
    ca_pm[:K], rb_pm[:K] = ca_log, rb_log
    ca = torch.from_numpy(ca_pm.reshape(planes, Kw))
    rb = torch.from_numpy(rb_pm.reshape(planes, Kw).T.copy())
    jst = jops._assemble_stats(jnp.asarray(ca_log), jnp.asarray(rb_log))
    got = tstats.tugemm_stats(ca, rb, K)
    _assert_stats(jst, got)
    plain = assemble_stats_ref(torch.from_numpy(ca_log), torch.from_numpy(rb_log))
    assert all(g.dtype == p.dtype and torch.equal(g, p) for g, p in zip(got, plain))


@pytest.mark.parametrize("K", [1, 5, 64])
def test_stats_output_layout_reads_the_kernels_words(K):
    """``stats_fields`` reads the layout ``csrc/unary_stats.cu`` writes: serial
    as int64 in words 0-1, parallel, max_abs, act_max in words 2-4, the
    step cycles from word HDR on."""
    out = torch.zeros(tstats.HDR + K, dtype=torch.int32)
    out[0:2].view(torch.int64)[0] = 2 ** 40 + 5
    out[2], out[3], out[4] = 7, 9, 11
    out[tstats.HDR:] = torch.arange(K, dtype=torch.int32) + 1
    step, ser, par, mx, act = tstats.stats_fields(out, K)
    assert (ser.dtype, int(ser)) == (torch.int64, 2 ** 40 + 5)
    assert (int(par), int(mx), int(act)) == (7, 9, 11)
    assert step.shape == (K,) and torch.equal(step, torch.arange(K, dtype=torch.int32) + 1)


# ------------------------------ route 3: the absmax kernel's blocks
@pytest.mark.parametrize("M,K,N", [(64, 1024, 2048), (37, 333, 65), (4, 16, 3)])
def test_absmax_kernel_blocks_cover_each_maximum_once(M, K, N):
    """``absmax_kernel`` on both operands: A's blocks hold 32 columns (a lane
    each) over all of M, in 8 row lanes merged by max; then B's blocks hold
    8 rows, a warp each. Every ca[k] and rb[k] has exactly one writer, and
    the maxima each block computes equal the reference's."""
    a, b = _operands((M, K, N))
    cw, cr, rw = 32, 8, 8
    ablocks = -(-K // cw)
    ca, rb = np.zeros(K, np.int64), np.zeros(K, np.int64)
    hits = np.zeros((2, K), np.int64)
    for blk in range(ablocks + -(-K // rw)):
        if blk < ablocks:
            c0, c1 = blk * cw, min(blk * cw + cw, K)
            lanes = [np.abs(a[r::cr, c0:c1].astype(np.int64)).max(0, initial=0)
                     for r in range(cr)]
            ca[c0:c1] = np.max(lanes, axis=0)
            hits[0, c0:c1] += 1
        else:
            for k in range((blk - ablocks) * rw, min((blk - ablocks + 1) * rw, K)):
                rb[k] = np.abs(b[k].astype(np.int64)).max()
                hits[1, k] += 1
    assert (hits == 1).all()
    jca, jrb, _ = jref.unary_stats_ref(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(np.asarray(jca), ca)
    np.testing.assert_array_equal(np.asarray(jrb), rb)


# ---------------------------------------------------------- paths and counts
def test_cuda_requests_on_cpu_tensors_raise_instead_of_falling_back():
    a = torch.zeros((2, 3), dtype=torch.int8)
    b = torch.zeros((3, 4), dtype=torch.int8)
    ca, rb = torch.zeros((1, 3), dtype=torch.int32), torch.zeros((3, 1), dtype=torch.int32)
    for call in (lambda: tstats.unary_step_stats(a, b, impl="cuda"),
                 lambda: tstats.tugemm_stats(ca, rb, 3, impl="cuda"),
                 lambda: tstats.colabsmax(a, impl="cuda"),
                 lambda: tstats.rowabsmax(b, impl="cuda"),
                 lambda: tugemm_int8(a, b, collect_stats=True, impl="cuda")):
        with pytest.raises(ValueError, match="CUDA"):
            call()


@pytest.mark.parametrize("impl", ["auto", "torch", "cuda"])
@pytest.mark.parametrize("M,K,N", [(0, 8, 5), (3, 8, 0), (3, 0, 5)])
def test_stats_of_an_empty_gemm_raise_on_every_path(M, K, N, impl):
    """An empty M, N or K leaves a maximum without a value: the plain version
    and the card refuse it alike, before they look at the device."""
    a, b = torch.zeros((M, K), dtype=torch.int8), torch.zeros((K, N), dtype=torch.int8)
    with pytest.raises(ValueError, match="M, N, K > 0"):
        tugemm_int8(a, b, collect_stats=True, impl=impl)
    with pytest.raises(ValueError, match="M, N, K > 0"):
        tstats.unary_step_stats(a, b, impl=impl)
    if impl != "cuda":   # without stats the empty GEMM is fine
        assert tugemm_int8(a, b, impl=impl).shape == (M, N)


def test_kernel_counts_list_the_stats_kernels_and_plain_calls_count():
    tops.reset_counts()
    rng = np.random.default_rng(1)
    a, b = _operands((5, 20, 6))
    x = torch.from_numpy(rng.standard_normal((5, 20)).astype(np.float32))
    tops.matmul_fused(x, torch.from_numpy(b).float(), sx=torch.tensor(0.1),
                      sw=torch.full((6,), 0.01), bits=8, collect_stats=True)
    tstats.unary_step_stats(torch.from_numpy(a), torch.from_numpy(b))
    counts = tops.kernel_counts()
    assert len(counts) == 10
    # the standalone route's plain version runs the same wrappers as the card
    assert counts["tugemm_stats"] == {"launches": 0, "plain_calls": 2}
    for name in ("unary_step_stats", "colabsmax", "rowabsmax", "tugemm_fused"):
        assert counts[name] == {"launches": 0, "plain_calls": 1}, name
    tops.reset_counts()
    assert all(c == {"launches": 0, "plain_calls": 0} for c in tops.kernel_counts().values())
