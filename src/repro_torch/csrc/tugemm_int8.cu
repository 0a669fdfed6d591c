// Exact int8 GEMM with int32 accumulators for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/tugemm_int8.py::matmul_int8_pallas
// (both of its bodies, _kernel and _kernel_with_c). One launch computes
//
//     Y = A @ B [+ C]      A (M, K) int8, B (K, N) int8, C (M, N) int32
//
// exactly in int32: the tuGEMM contract, with the output counters starting
// at the binary-loaded C when it is given (paper §II-B). C is a nullable
// pointer, so one kernel covers both TPU bodies.
//
// What bounds it on this card: on the unfused serving path M is small
// (max_batch x step width, 4..64 rows), so the work is reading B once
// (1-2 MiB at the layer shapes, ~0.3-0.6 us at 3.35 TB/s), far below the
// int8 tensor-core rate. The first port (32x32 tiles walking all of K, one
// stage, byte loads, __dp4a) gave 64-128 blocks and read B twice at M=64.
//
// Design: the fused kernel's mainloop (tugemm_mainloop.cuh; see
// tugemm_fused.cu) without the quantizer. A and B go in flight in 16-byte
// cp.async chunks of 64 K rows, a block's whole K slice at once; all rows of
// a 64-row tile share one read of B; B is transposed K-contiguous by prmt and
// multiplied on the s8 tensor cores (mma.sync.m16n8k32); K is split across
// the blocks of a thread block cluster by kernels/tugemm_fused.py::split_plan
// (planes = 1) and the int32 partial tiles are summed through distributed
// shared memory. C is added once, by the rank that reduces that element,
// never by every K slice. Ragged M, N and K are zero-filled on load and
// masked on store (byte rows that are not 16-byte multiples go through
// plain loads), so the caller pads nothing.
//
// Cycle statistics (collect): the tuGEMM step maxima ca[k] = max_m |A[m,k]|
// and rb[k] = max_n |B[k,n]| (the TPU kernels repro/kernels/unary_stats.py::
// colabsmax_pallas and ::rowabsmax_pallas) come out of the same launch, from
// the A and B tiles already in shared memory: byte-wise maxima in registers,
// one atomicMax per k and block, ca only from the blocks of N tile 0, rb
// only from those of M tile 0 (the mainloop's stats, as in the fused
// kernel). The operands are not read again; unary_stats.cu's tugemm_stats
// launch turns the two vectors into TuGemmStats.
//
// Experts (E > 1, the unfused MoE expert GEMMs, the TPU kernel under the
// reference's vmap): A (E, M, K), B (E, K, N), C and Y (E, M, N) in one
// launch, the expert folded into grid z as in the fused kernel; each
// expert's maxima go to its own rows, ca (E, K) then rb (E, K), which
// tugemm_stats assembles one block an expert.

#include "tugemm_mainloop.cuh"

// stats (collect) is one int32 buffer, ca (E, K) then rb (E, K), zeroed here
// (one cudaMemsetAsync on the stream) before the kernel merges its maxima
// into it; null without collect. Returns 0 on success, -2 for a plan outside
// the kernel's range, else the cudaError_t of the launch. c may be null. The
// plan (bn, splits, chunks) comes from kernels/tugemm_fused.py::split_plan.
extern "C" int tugemm_int8_launch(const void* a, const void* b, const void* c, void* y,
                                  int* stats, int E, int M, int N, int K, int collect, int bn,
                                  int splits, int chunks, void* stream) {
  using namespace tugemm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params p = {};
  p.x = a; p.w = b; p.c = static_cast<const int*>(c); p.y = y;
  p.E = E; p.M = M; p.N = N; p.Kw = K; p.Kx = K; p.planes = 1; p.bn = bn; p.chunks = chunks;
  if (!collect) return launch<int8_t, W_INT8, int8_t, int, false>(p, splits, s);
  p.collect = 1;
  p.ca = stats;
  p.rb = stats + (long)E * K;
  const cudaError_t e = cudaMemsetAsync(stats, 0, 2 * (size_t)E * K * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  return launch<int8_t, W_INT8, int8_t, int, true>(p, splits, s);
}
