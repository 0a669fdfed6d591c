"""Hand-written CUDA kernels for Hopper beside their plain PyTorch versions.

- ``tugemm_fused`` — fused quantize -> int8 GEMM -> dequant(+bias)(+stats)
  (``csrc/tugemm_fused.cu``; replaces ``repro/kernels/tugemm_fused.py``)
- ``flash_paged`` — paged flash-decode attention straight from the page
  pool (``csrc/flash_paged.cu``; replaces ``repro/kernels/flash_paged.py``)

Sources build with ``nvcc`` at first use (``kernels/build.py``) and load
through ``ctypes``; nothing here imports a GPU toolchain at import time.
"""
