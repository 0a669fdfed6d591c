"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C launcher and is compiled on first
use into ``build/repro_torch/`` at the repository root (listed in
``.gitignore``), named by a hash of its source, of every ``csrc`` header it
includes (``#include "..."``, followed through headers) and of the flags, so
an edited source or header never loads a stale library. Only sources in this
repository are compiled; a failed build raises with the compiler's output.
Independent sources are compiled in parallel, one ``nvcc`` each. ``python -m
repro_torch.kernels.build [name ...]`` prints ptxas's register, shared
memory and spill report of each source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["BuildError", "SOURCES", "build", "load", "ptxas_report"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("tugemm_fused", "flash_paged", "tugemm_int8", "tugemm_packed", "unary_stats",
           "quantize_sym", "temporal_unary")
# no --use_fast_math: the kernels depend on IEEE divide and rounding
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
_libs: dict[str, ctypes.CDLL] = {}


class BuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise BuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def _sources(path: Path, seen: dict[Path, bytes]) -> dict[Path, bytes]:
    """``path`` and every file it includes by ``#include "..."`` (relative
    to the including file), each once: {path: bytes}."""
    path = path.resolve()
    if path not in seen:
        seen[path] = text = path.read_bytes()
        for inc in _INCLUDE.findall(text):
            _sources(path.parent / inc.decode(), seen)
    return seen


def _target(name: str, csrc: Path = CSRC) -> Path:
    files = _sources(csrc / f"{name}.cu", {})
    digest = hashlib.sha256(b"".join(files.values()) + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"


def build(names=SOURCES) -> dict[str, float]:
    """Compile every named source whose library is missing, all at once.
    Returns {name: seconds} for the sources compiled by this call."""
    todo = [n for n in names if not _target(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = _target(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    took, failed = {}, []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        took[n] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- {n}.cu (exit {proc.returncode}) ---\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _target(n))
    if failed:
        raise BuildError("nvcc failed:\n" + "\n".join(failed))
    return took


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build((name,))
        lib = _libs[name] = ctypes.CDLL(str(_target(name)))
    return lib


def ptxas_report(names=SOURCES) -> dict[str, list[str]]:
    """Compile each named source with ``-Xptxas -v`` into a temporary
    directory and return ptxas's resource lines (registers, shared memory,
    spills) per source, each kernel's line after its demangled-name line."""
    import tempfile

    nvcc = _nvcc()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for n in names:
            proc = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(Path(tmp) / f"{n}.so"),
                 str(CSRC / f"{n}.cu")], capture_output=True, text=True)
            if proc.returncode != 0:
                raise BuildError(f"nvcc failed on {n}.cu:\n{proc.stdout}{proc.stderr}")
            out[n] = [line.strip() for line in (proc.stdout + proc.stderr).splitlines()
                      if "ptxas info" in line or "spill" in line]
    return out


if __name__ == "__main__":
    import sys

    # python -m repro_torch.kernels.build [source ...]: ptxas's report
    for name, lines in ptxas_report(tuple(sys.argv[1:]) or SOURCES).items():
        print(f"--- {name}.cu")
        print("\n".join(lines))
