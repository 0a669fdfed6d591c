"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import no JAX
and nothing of the reference package, and a CUDA request on a machine
without a card raises instead of quietly running on the CPU."""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|ml_dtypes|repro)\b(?!_)|from\s+(jax|ml_dtypes|repro)\b(?!_))",
    re.MULTILINE)


def test_port_imports_without_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(' '.join(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""},
                         timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 20
    # the C1 validation path's modules are walked too
    assert {f"repro_torch.{m}" for m in (
        "core.encoding", "core.tugemm", "core.cycle_sim", "core.latency", "core.tiling",
        "core.report", "core.ugemm_baseline", "configs.tugemm_paper", "kernels.quantize",
        "kernels.temporal_unary", "quant.stats", "quickstart")} <= names
    # and the serving robustness and observability modules
    assert {f"repro_torch.{m}" for m in (
        "obs", "obs.logs", "obs.metrics", "obs.trace", "obs.profile", "serve.admission",
        "serve.faults", "serve.cache", "serve.scheduler")} <= names


def test_sources_name_no_jax_or_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    hits = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
            for f in files for m in FORBIDDEN.finditer(f.read_text())]
    assert not hits, hits
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert FORBIDDEN.search("from repro.models import init")
    assert not FORBIDDEN.search("from repro_torch.models import init")


def test_cuda_request_without_a_card_raises(monkeypatch):
    from repro_torch import resolve_device
    from repro_torch.configs.base import RunConfig, get_config
    from repro_torch.interop import params_from_reference
    from repro_torch.models import init, init_caches

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        init(get_config("qwen3-0.6b_smoke"), RunConfig(kv_layout="paged"))
    with pytest.raises(RuntimeError, match="CUDA"):
        init_caches(get_config("qwen3-0.6b_smoke"), RunConfig(kv_layout="paged"), 1, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_reference({"w": np.zeros(2, np.float32)})
    assert resolve_device("cpu").type == "cpu"


def test_chip_smoke_refuses_without_a_card():
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": ""})
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
