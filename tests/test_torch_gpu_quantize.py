"""``csrc/quantize_sym.cu`` on the card against its plain version
(``kernels/ref.py::quantize_sym_ref``), exactly, dtype included: the C1
path's 14 operand shapes on qwen3-0.6b, ragged shapes, an x that is not
16-byte aligned, and every scale form ``ops.quantize_sym`` takes. Marked
``gpu``; without a CUDA card each test skips with its reason. On a machine
with one::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_quantize.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.quantize import quantize_sym
from repro_torch.kernels.ref import quantize_sym_ref

pytestmark = pytest.mark.gpu

C1_WEIGHTS = [(1024, 2048), (1024, 1024), (2048, 1024), (1024, 3072), (3072, 1024)]
RAGGED = [(37, 333), (333, 37), (64, 1004), (5, 15), (1, 1), (0, 16), (16, 0)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _x(shape, dtype, seed, device, offset=0):
    """A seeded x of ``shape``, laid ``offset`` elements into its buffer (an
    offset of 1 leaves the data pointer off 16-byte alignment)."""
    M, N = shape
    vals = np.random.default_rng(seed).normal(0, 3.0, M * N).astype(np.float32)
    if vals.size:
        vals[0], vals[-1] = 1e6, -1e6            # clipped at both ends of the range
    buf = torch.empty(M * N + offset, dtype=dtype, device=device)
    x = buf[offset:].view(M, N)
    x.copy_(torch.from_numpy(vals).view(M, N))
    return x


def _scale(x, per_col):
    if x.numel() == 0:
        return torch.ones(x.shape[1] if per_col else (), device=x.device)
    amax = x.float().abs().amax(dim=0) if per_col else x.float().abs().amax()
    return amax.clamp_min(1e-8) * (1.0 / 127)


def _check(x, bits, per_col):
    scale = _scale(x, per_col)
    got = quantize_sym(x, scale, bitwidth=bits, impl="cuda")
    torch.cuda.synchronize()
    want = quantize_sym_ref(x, (1.0 / scale).reshape(1, -1), bits)
    assert got.dtype == torch.int8 and got.shape == x.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("KN", C1_WEIGHTS)
def test_c1_shapes_match_plain(cuda, KN, dtype, bits):
    K, N = KN
    _check(_x((K, N), dtype, K + N, cuda), bits, per_col=True)
    _check(_x((64, K), dtype, K, cuda), bits, per_col=False)


@pytest.mark.parametrize("per_col", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", RAGGED)
def test_ragged_shapes_match_plain(cuda, shape, dtype, per_col):
    _check(_x(shape, dtype, sum(shape), cuda), 8, per_col)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(1024, 2048), (37, 333)])
def test_misaligned_x_matches_plain(cuda, shape, dtype):
    x = _x(shape, dtype, 3, cuda, offset=1)
    assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    _check(x, 8, per_col=True)
    _check(x, 4, per_col=False)


@pytest.mark.parametrize("form", ["float", "0-d", "(N,)", "(1, N)"])
@pytest.mark.parametrize("shape", [(1024, 2048), (37, 333)])
def test_scale_forms_are_one_launch_and_match_plain(cuda, shape, form):
    from repro_torch.kernels.quantize import COUNT

    x = _x(shape, torch.bfloat16, 4, cuda)
    per_col = form in ("(N,)", "(1, N)")
    s = _scale(x, per_col)
    scale = float(s) if form == "float" else s.reshape(1, -1) if form == "(1, N)" else s
    want = ops.quantize_sym(x, scale, bitwidth=8, impl="torch")
    launches = COUNT.launches
    got = ops.quantize_sym(x, scale, bitwidth=8)
    torch.cuda.synchronize()
    assert COUNT.launches == launches + 1
    assert torch.equal(got, want)
