"""Port parity: paged flash-decode attention (``repro_torch.kernels.flash_paged``
on CPU tensors, i.e. its plain version: gather, dequantize, masked softmax)
against the reference's Pallas kernel in interpret mode and its XLA twin
(``kv_cache_read`` gather + ``blockwise_attention``), on the same numpy
pools, block tables and queries.

Tolerance: ``atol=2e-5`` on O(1) f32 outputs — the three implementations
sum scores and probabilities in different orders (online softmax over pages
vs one masked softmax), nothing else differs. Idle rows must be exact zeros."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_paged import flash_paged_decode as j_flash
from repro.models.attention import KVView, _quantize_kv, kv_cache_read
from repro.models.flash import blockwise_attention
from repro_torch.interop import tensor_from_numpy
from repro_torch.kernels.flash_paged import flash_paged_decode as t_flash

torch.set_float32_matmul_precision("highest")
TOL = 2e-5


def tn(arr):
    return tensor_from_numpy(arr, device="cpu")


def _pool(P, bs, feat, int8, seed):
    r = np.random.default_rng(seed)
    data = r.standard_normal((P + 1, bs) + feat).astype(np.float32)
    if not int8:
        return data, None
    q, s = _quantize_kv(jnp.asarray(data))
    return np.asarray(q), np.asarray(s)


def _tables(rows, bs, MB, P, seed):
    r = np.random.default_rng(seed)
    B = len(rows)
    tables = np.full((B, MB), P, np.int32)      # unused entries: the trash page
    ids = r.permutation(P)
    nxt = 0
    pos = np.array([p for p, _ in rows], np.int32)
    lens = np.array([l for _, l in rows], np.int32)
    for b, (p, l) in enumerate(rows):
        for m in range(-(-(p + l) // bs)):
            tables[b, m] = ids[nxt]
            nxt += 1
    return tables, pos, lens


def _run(rows, *, kv, group, parts, hdv, sq, bs=4, MB=4, int8=True, window=None,
         seed=0, alias_v=False):
    """parts: per-K-part feature widths per kv head (MLA: (lora, rope))."""
    B = len(rows)
    P = B * MB
    tables, pos, lens = _tables(rows, bs, MB, P, seed)
    kp = [_pool(P, bs, (kv * f,), int8, seed + 1 + i) for i, f in enumerate(parts)]
    v, vs = kp[0] if alias_v else _pool(P, bs, (kv * hdv,), int8, seed + 9)
    q = np.random.default_rng(seed + 3).standard_normal(
        (B, sq, kv * group, sum(parts))).astype(np.float32)
    kv_len = pos + lens
    j_args = (jnp.asarray(q), tuple(jnp.asarray(k) for k, _ in kp),
              tuple(None if s is None else jnp.asarray(s) for _, s in kp),
              jnp.asarray(v), None if vs is None else jnp.asarray(vs),
              jnp.asarray(tables), jnp.asarray(pos), jnp.asarray(kv_len))
    kern = np.asarray(j_flash(*j_args, kv_heads=kv, causal=True, window=window,
                              interpret=True))
    port = t_flash(tn(q), tuple(tn(k) for k, _ in kp),
                   tuple(None if s is None else tn(s) for _, s in kp),
                   tn(v), None if vs is None else tn(vs), tn(tables), tn(pos), tn(kv_len),
                   kv_heads=kv, causal=True, window=window).numpy()
    return kern, port, (j_args, tables, pos, lens)


def _twin(j_args, tables, pos, lens, *, kv, parts, hdv, bs, window):
    """The reference's XLA path: gather + length-mask, then blockwise attention."""
    q, kparts, kscales, v, vs = j_args[:5]
    view = KVView(jnp.asarray(pos), jnp.asarray(lens), jnp.asarray(tables),
                  block_size=bs, layout="paged")
    cache = {}
    for i, (k, s) in enumerate(zip(kparts, kscales)):
        cache[f"k{i}"] = k.reshape(k.shape[0], bs, kv, -1)
        if s is not None:
            cache[f"k{i}_scale"] = s
    cache["v"] = v.reshape(v.shape[0], bs, kv, -1)
    if vs is not None:
        cache["v_scale"] = vs
    ks = [kv_cache_read(cache, f"k{i}", jnp.float32, kv_len=view.kv_len, view=view)
          for i in range(len(kparts))]
    k_full = jnp.concatenate(ks, axis=-1)
    v_full = kv_cache_read(cache, "v", jnp.float32, kv_len=view.kv_len, view=view)
    return np.asarray(blockwise_attention(q, k_full, v_full, q_offset=view.pos,
                                          kv_len=view.kv_len, causal=True, window=window))


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("sq", [1, 3, 5])
def test_gqa_matches_reference(int8, sq):
    # partial page / fresh / idle / near-full rows
    rows = [(5, min(sq, 1)), (0, sq), (0, 0), (10, 1)]
    kern, port, (j_args, tables, pos, lens) = _run(rows, kv=2, group=3, parts=(8,), hdv=8,
                                                   sq=sq, int8=int8)
    np.testing.assert_allclose(port, kern, atol=TOL, rtol=0)
    twin = _twin(j_args, tables, pos, lens, kv=2, parts=(8,), hdv=8, bs=4, window=None)
    np.testing.assert_allclose(port, twin, atol=TOL, rtol=0)
    assert (port[2] == 0).all()


def test_gqa_mixed_step_width():
    rows = [(0, 5), (3, 5), (7, 1), (0, 0)]
    kern, port, _ = _run(rows, kv=2, group=2, parts=(8,), hdv=8, sq=5, int8=True)
    np.testing.assert_allclose(port, kern, atol=TOL, rtol=0)


def test_gqa_sliding_window():
    rows = [(5, 1), (9, 1), (0, 0)]
    kern, port, (j_args, tables, pos, lens) = _run(rows, kv=2, group=3, parts=(8,), hdv=8,
                                                   sq=1, window=3)
    np.testing.assert_allclose(port, kern, atol=TOL, rtol=0)
    twin = _twin(j_args, tables, pos, lens, kv=2, parts=(8,), hdv=8, bs=4, window=3)
    np.testing.assert_allclose(port, twin, atol=TOL, rtol=0)


def test_idle_rows_emit_exact_zeros():
    rows = [(0, 0), (6, 1), (0, 0)]
    _, port, _ = _run(rows, kv=1, group=2, parts=(8,), hdv=8, sq=3, int8=True, seed=4)
    assert (port[0] == 0).all() and (port[2] == 0).all()
    assert np.abs(port[1]).max() > 0


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("sq", [1, 3])
def test_mla_two_parts(int8, sq):
    """MLA absorbed decode: K = [ckv ; kr] per page, V aliases the ckv pool."""
    rows = [(6, 1), (0, sq), (0, 0)]
    kern, port, _ = _run(rows, kv=1, group=4, parts=(16, 4), hdv=16, sq=sq, int8=int8,
                         alias_v=True, seed=7)
    np.testing.assert_allclose(port, kern, atol=TOL, rtol=0)
    assert (port[2] == 0).all()


def test_bf16_query_output_dtype():
    rows = [(5, 1), (0, 2)]
    _, port32, (j_args, *_rest) = _run(rows, kv=2, group=2, parts=(8,), hdv=8, sq=2)
    q, kparts, kscales, v, vs, tables, pos, kv_len = j_args
    q16 = tn(np.asarray(q)).to(torch.bfloat16)
    out = t_flash(q16, tuple(tn(np.asarray(k)) for k in kparts),
                  tuple(tn(np.asarray(s)) for s in kscales), tn(np.asarray(v)),
                  tn(np.asarray(vs)), tn(np.asarray(tables)), tn(np.asarray(pos)),
                  tn(np.asarray(kv_len)), kv_heads=2)
    assert out.dtype == torch.bfloat16 and out.shape == port32.shape
    # bf16 rounding of q and of the output: a few bf16 steps on O(1) values
    np.testing.assert_allclose(out.float().numpy(), port32, atol=5e-2, rtol=0)


def test_cuda_impl_on_cpu_tensor_raises():
    rows = [(1, 1)]
    _, _, (j_args, *_rest) = _run(rows, kv=1, group=1, parts=(8,), hdv=8, sq=1)
    t = [tn(np.asarray(a)) if not isinstance(a, tuple) else tuple(tn(np.asarray(b)) for b in a)
         for a in j_args]
    with pytest.raises(ValueError, match="needs CUDA"):
        t_flash(*t, kv_heads=1, impl="cuda")


@pytest.mark.parametrize("int8", [False, True])
def test_kv_cache_read_matches_reference(int8):
    """The paged gather + dequantize + length mask, exactly."""
    from repro_torch.models.attention import KVView as TView
    from repro_torch.models.attention import kv_cache_read as t_read

    rows = [(5, 1), (0, 3), (0, 0)]
    bs, MB, kv, hd = 4, 3, 2, 8
    P = len(rows) * MB
    tables, pos, lens = _tables(rows, bs, MB, P, seed=2)
    data, scale = _pool(P, bs, (kv, hd), int8, seed=8)
    jc = {"k": jnp.asarray(data)}
    tc = {"k": tn(data)}
    if int8:
        jc["k_scale"], tc["k_scale"] = jnp.asarray(scale), tn(scale)
    jv = KVView(jnp.asarray(pos), jnp.asarray(lens), jnp.asarray(tables), block_size=bs,
                layout="paged")
    tv = TView(tn(pos), tn(lens), tn(tables), block_size=bs)
    want = np.asarray(kv_cache_read(jc, "k", jnp.float32, kv_len=jv.kv_len, view=jv))
    got = t_read(tc, "k", torch.float32, view=tv).numpy()
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------- split over pages + combine
from repro_torch.kernels.flash_paged import ROW_TILE, flash_paged_ref, split_plan  # noqa: E402


@pytest.mark.parametrize("pages", [1, 2, 15, 16, 17, 128, 1000])
@pytest.mark.parametrize("tiles", [(1, 1, 1), (4, 8, 2), (4, 1, 256), (64, 8, 32)])
def test_split_plan_covers_every_page_once(pages, tiles):
    B, kv, rows_head = tiles
    splits, per = split_plan(B, kv, rows_head, pages, sms=132)
    owner = np.zeros(pages, int)
    for s in range(splits):
        owner[s * per:min((s + 1) * per, pages)] += 1
    assert (owner == 1).all()
    assert 1 <= splits <= min(pages, 256) and (splits - 1) * per < pages


@pytest.mark.parametrize("case", [
    ("gqa decode", 4, 8, 2, 128), ("gqa step16", 4, 8, 32, 128),
    ("mla decode", 4, 1, 16, 128), ("mla step16", 4, 1, 256, 128),
    ("serve step16", 4, 8, 32, 16)])
def test_split_plan_fills_the_card_at_the_chip_shapes(case):
    """At least one block per SM of an H100 (132) in pass 1."""
    _, B, kv, rows_head, pages = case
    splits, _ = split_plan(B, kv, rows_head, pages, sms=132)
    assert B * kv * -(-rows_head // ROW_TILE) * splits >= 132


def test_split_plan_takes_shapes_only():
    import inspect

    assert list(inspect.signature(split_plan).parameters) == [
        "batch", "kv_heads", "rows_head", "pages", "sms"]


def _split_emulation(q, k_parts, k_scales, v_pool, v_scale, tables, pos, kv_len, *, kv_heads,
                     window, sms=132, chunk=32):
    """Pass 1 and pass 2 of csrc/flash_paged.cu in torch: each split walks the
    tokens of its pages that its rows can see in chunks with an online
    softmax and keeps (m, l, acc) per query row; the combine merges them."""
    from repro_torch.kernels.flash_paged import NEG_INF, gather_pages

    B, sq, H, hd = q.shape
    kv, group = kv_heads, H // kv_heads
    MB, bs = tables.shape[1], v_pool.shape[1]
    k = torch.cat([gather_pages(p, s, tables).reshape(B, MB * bs, kv, -1)
                   for p, s in zip(k_parts, k_scales)], dim=-1)
    v = gather_pages(v_pool, v_scale, tables).reshape(B, MB * bs, kv, -1)
    qf = q.float() * (1.0 / hd ** 0.5)
    splits, per = split_plan(B, kv, group * sq, MB, sms)
    out = torch.zeros(B, sq, H, v.shape[-1])
    for b in range(B):
        L, p0 = int(kv_len[b]), int(pos[b])
        for h in range(H):
            g = h // group
            for s in range(sq):
                qpos = p0 + s
                parts = []
                for sp in range(splits):
                    lo = sp * per * bs
                    hi = min(min((sp + 1) * per, MB) * bs, L, p0 + sq)
                    if window is not None:
                        lo = max(lo, p0 - window + 1)
                    m, l, acc = NEG_INF, 0.0, torch.zeros(v.shape[-1])
                    for c0 in range(lo, hi, chunk):
                        ks = torch.arange(c0, c0 + chunk)
                        vis = (ks < hi) & (ks < L) & (ks <= qpos)
                        if window is not None:
                            vis &= qpos - ks < window
                        kc = ks.clamp_max(MB * bs - 1)
                        kk = torch.where((ks < hi)[:, None], k[b, kc, g], 0.0)
                        vv = torch.where((ks < hi)[:, None], v[b, kc, g], 0.0)
                        sc = kk @ qf[b, s, h]
                        mx = max(m, float(torch.where(vis, sc, NEG_INF).max()))
                        p = torch.where(vis, torch.exp(sc - mx), 0.0)
                        alpha = float(np.exp(np.float32(m - mx)))
                        l = l * alpha + float(p.sum())
                        acc = acc * alpha + p @ vv
                        m = mx
                    parts.append((m, l, acc))
                big = max(m for m, _, _ in parts)
                w = [float(np.exp(np.float32(m - big))) for m, _, _ in parts]
                tot = sum(wi * l for wi, (_, l, _) in zip(w, parts))
                o = sum(wi * a for wi, (_, _, a) in zip(w, parts))
                out[b, s, h] = o / max(tot, 1e-30)
    return out


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("int8", [False, True])
def test_split_combine_matches_the_plain_version(int8, window):
    """Two pages per split (4 splits); rows: a long one, one whose live
    pages end on a split boundary, an idle row (every split empty), kv_len
    1; the window leaves the long row's first two splits empty."""
    rows = [(27, 1), (7, 1), (0, 0), (0, 1)]
    B, MB, bs, kv = len(rows), 8, 4, 2
    P = B * MB
    tables, pos, lens = _tables(rows, bs, MB, P, seed=5)
    kp, ks = _pool(P, bs, (kv * 8,), int8, 11)
    v, vs = _pool(P, bs, (kv * 8,), int8, 12)
    q = np.random.default_rng(13).standard_normal((B, 1, kv * 3, 8)).astype(np.float32)
    args = (tn(q), (tn(kp),), (None if ks is None else tn(ks),), tn(v),
            None if vs is None else tn(vs), tn(tables), tn(pos), tn(pos + lens))
    assert split_plan(B, kv, 3, MB, sms=64) == (4, 2)
    got = _split_emulation(*args, kv_heads=kv, window=window, sms=64, chunk=4)
    want = flash_paged_ref(*args, kv_heads=kv, window=window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=0)
    assert (got[2] == 0).all()


@pytest.mark.parametrize("sq", [1, 3])
def test_split_combine_mla_step_matches_the_plain_version(sq):
    """Two K parts, V aliasing the first, a step of several query positions
    (causal inside the step), splits of several pages and chunks that cross
    page boundaries."""
    rows = [(13, sq), (0, sq), (0, 0)]
    B, MB, bs = len(rows), 6, 4
    P = B * MB
    tables, pos, lens = _tables(rows, bs, MB, P, seed=8)
    k0, s0 = _pool(P, bs, (16,), True, 21)
    k1, s1 = _pool(P, bs, (4,), True, 22)
    q = np.random.default_rng(23).standard_normal((B, sq, 4, 20)).astype(np.float32)
    args = (tn(q), (tn(k0), tn(k1)), (tn(s0), tn(s1)), tn(k0), tn(s0), tn(tables), tn(pos),
            tn(pos + lens))
    got = _split_emulation(*args, kv_heads=1, window=None, sms=2, chunk=3)
    want = flash_paged_ref(*args, kv_heads=1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=0)
    assert (got[2] == 0).all()


def test_kernel_shape_plan_refuses_rows_not_whole_16_bytes():
    """The kernel copies and reads token rows 16 bytes at a time: int8 head
    widths must be multiples of 16, bf16 of 8, f32 of 4; the query's too."""
    from repro_torch.kernels.flash_paged import _shape_plan

    def plan(f, kv_dtype, q_dtype=torch.bfloat16):
        scale = ((9, 16), torch.float32) if kv_dtype == torch.int8 else None
        return _shape_plan((2, 1, 4, f), q_dtype, 2, (((9, 16, 2 * f), kv_dtype),),
                           (9, 16, 2 * f), kv_dtype, (scale, scale), (2, 4), (2,), (2,), 132)

    assert plan(16, torch.int8)[:2] == ([16], 16)
    assert plan(8, torch.bfloat16)[:2] == ([8], 8)
    for f, dt in ((8, torch.int8), (4, torch.bfloat16)):
        with pytest.raises(ValueError, match="16-byte rows"):
            plan(f, dt)
    with pytest.raises(ValueError, match="16-byte rows"):
        plan(4, torch.float32)                 # f32 pools fine, bf16 q rows of 8 bytes not
    assert plan(4, torch.float32, torch.float32)[:2] == ([4], 4)
