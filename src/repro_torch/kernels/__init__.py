"""Hand-written CUDA kernels for Hopper beside their plain PyTorch versions.

- ``tugemm_fused`` — fused quantize -> int8 GEMM -> dequant(+bias)(+stats)
  (``csrc/tugemm_fused.cu``; replaces ``repro/kernels/tugemm_fused.py``)
- ``flash_paged`` — paged flash-decode attention straight from the page
  pool (``csrc/flash_paged.cu``; replaces ``repro/kernels/flash_paged.py``)
- ``tugemm_int8`` — exact int8 GEMM, accumulators optionally seeded with C
  (``csrc/tugemm_int8.cu``; replaces ``repro/kernels/tugemm_int8.py``)
- ``tugemm_packed`` — exact int8 x plane-packed int4/int2 GEMM
  (``csrc/tugemm_packed.cu``; replaces ``repro/kernels/tugemm_packed.py``)
- ``unary_stats`` — column / row absmax of the tuGEMM cycle statistics
  (``csrc/unary_stats.cu``; replaces ``repro/kernels/unary_stats.py``)
- ``quantize`` — symmetric w-bit quantization by a reciprocal scale
  (``csrc/quantize_sym.cu``; replaces ``repro/kernels/quantize.py``)
- ``temporal_unary`` — the thermometer-decomposed exact GEMM, the paper's
  C1 validation path (``csrc/temporal_unary.cu``; replaces
  ``repro/kernels/temporal_unary.py``)

Sources build with ``nvcc`` at first use (``kernels/build.py``) and load
through ``ctypes``; nothing here imports a GPU toolchain at import time.
"""
