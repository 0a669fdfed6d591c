"""``csrc/flash_paged.cu`` on the card at head widths whose rows are not
whole 16-byte pieces (the kernel's narrow path) against its plain version
(``kernels/flash_paged.py::flash_paged_ref``): ``smollm-360m_smoke``'s
head_dim 20 (40-byte bf16 rows, 20-byte int8 rows) on bf16, int8 and f32
pools, decode and 16-wide steps, a window, an idle row (exact zeros); widths
whose rows are not whole 4-byte words (one element a lane); a two-part K
with V aliasing its first part. bf16 outputs to 2**-7 relative, f32 to
1e-5, as ``chip_smoke.py``'s ``ATTN_TOL``. Then ``smollm-360m_smoke`` serves
on the card through the kernel. Marked ``gpu``; without a CUDA card each
test skips with its reason. On a machine with one::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_flash_paged.py
"""

import pytest
import torch

from repro_torch.kernels import flash_paged as fp
from repro_torch.models.attention import _quantize_kv

pytestmark = pytest.mark.gpu

TOL = {torch.bfloat16: (1e-6, 2.0 ** -7), torch.float32: (1e-5, 1e-5)}
DEC = [(47, 1), (20, 1), (0, 0), (3, 1)]          # (pos, new tokens) a row; row 2 idle
STEP = [(32, 16), (5, 16), (0, 0), (0, 16)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _case(dev, rows, *, kv, group, parts, hdv, kv_dtype, q_dtype, sq, bs=16, MB=4,
          alias=False, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    B, P = len(rows), len(rows) * MB
    perm = torch.randperm(P, device=dev, generator=gen).reshape(B, MB).to(torch.int32)
    tables = torch.full((B, MB), P, dtype=torch.int32, device=dev)
    for b, (p, n) in enumerate(rows):
        k = -(-(p + n) // bs)
        tables[b, :k] = perm[b, :k]
    pos = torch.tensor([p for p, _ in rows], dtype=torch.int32, device=dev)
    kv_len = pos + torch.tensor([n for _, n in rows], dtype=torch.int32, device=dev)

    def pool(f):
        data = torch.randn(P + 1, bs, kv * f, device=dev, generator=gen)
        if kv_dtype == torch.int8:
            q, s = _quantize_kv(data.reshape(P + 1, bs, kv, f))
            return q.reshape(P + 1, bs, kv * f), s
        return data.to(kv_dtype), None

    ks = [pool(f) for f in parts]
    v, vs = ks[0] if alias else pool(hdv)
    q = torch.randn(B, sq, kv * group, sum(parts), device=dev, generator=gen).to(q_dtype)
    return (q, tuple(k for k, _ in ks), tuple(s for _, s in ks), v, vs, tables, pos, kv_len)


def _check(args, rows, kv, window=None):
    before = fp.COUNT.launches
    got = fp.flash_paged_decode(*args, kv_heads=kv, window=window, impl="cuda")
    torch.cuda.synchronize()
    want = fp.flash_paged_ref(*args, kv_heads=kv, window=window)
    assert fp.COUNT.launches == before + 1
    assert got.shape == want.shape and got.dtype == want.dtype
    atol, rtol = TOL[args[0].dtype]
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= atol + rtol * want.float().abs()).all()), diff.max().item()
    for b, (_, n) in enumerate(rows):
        if n == 0:
            assert bool((got[b] == 0).all())


# smollm-360m_smoke's attention: 3 heads on 1 kv head, head_dim 20
SMOLLM = dict(kv=1, group=3, parts=(20,), hdv=20)


@pytest.mark.parametrize("kv_dtype,q_dtype", [(torch.bfloat16, torch.bfloat16),
                                              (torch.int8, torch.bfloat16),
                                              (torch.float32, torch.float32)])
@pytest.mark.parametrize("rows,sq", [(DEC, 1), (STEP, 16)], ids=["decode", "step16"])
def test_head_dim_20_matches_the_plain_version(cuda, kv_dtype, q_dtype, rows, sq):
    args = _case(cuda, rows, kv_dtype=kv_dtype, q_dtype=q_dtype, sq=sq, **SMOLLM)
    _check(args, rows, 1)


def test_head_dim_20_window(cuda):
    args = _case(cuda, STEP, kv_dtype=torch.int8, q_dtype=torch.bfloat16, sq=16, seed=3,
                 **dict(SMOLLM, kv=2))
    _check(args, STEP, 2, window=8)


@pytest.mark.parametrize("f,kv_dtype", [(5, torch.int8), (18, torch.int8), (3, torch.bfloat16),
                                        (21, torch.bfloat16), (6, torch.float32)])
def test_rows_not_whole_4_byte_words(cuda, f, kv_dtype):
    """Copies of one element a lane (rows not whole 4-byte words), and
    hdv not a multiple of 4 (the combine's one-column path)."""
    q_dtype = torch.float32 if kv_dtype == torch.float32 else torch.bfloat16
    args = _case(cuda, STEP, kv=2, group=2, parts=(f,), hdv=f, kv_dtype=kv_dtype,
                 q_dtype=q_dtype, sq=16, seed=f)
    _check(args, STEP, 2)


def test_two_parts_v_aliasing_the_first(cuda):
    """MLA's form at narrow widths: K = [ckv ; kr], V read from ckv's copy."""
    args = _case(cuda, DEC, kv=1, group=4, parts=(20, 4), hdv=20, kv_dtype=torch.int8,
                 q_dtype=torch.bfloat16, sq=1, alias=True, seed=5)
    _check(args, DEC, 1)


def test_smollm_smoke_serves_on_the_card(cuda):
    """The paged Scheduler serves ``smollm-360m_smoke`` through the kernel."""
    from repro_torch.launch.serve import main as serve_main

    before = fp.COUNT.launches
    done = serve_main(["--arch", "smollm-360m_smoke", "--kv-layout", "paged", "--kv-dtype",
                       "int8", "--requests", "4", "--max-new", "8", "--capacity", "64"])
    assert done and fp.COUNT.launches > before
