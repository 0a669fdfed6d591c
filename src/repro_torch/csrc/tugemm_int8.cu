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

#include "tugemm_mainloop.cuh"

// Returns 0 on success, -2 for a plan outside the kernel's range, else the
// cudaError_t of the launch. c may be null. The plan (bn, splits, chunks)
// comes from kernels/tugemm_fused.py::split_plan.
extern "C" int tugemm_int8_launch(const void* a, const void* b, const void* c, void* y,
                                  int M, int N, int K, int bn, int splits, int chunks,
                                  void* stream) {
  using namespace tugemm;
  Params p = {};
  p.x = a; p.w = b; p.c = static_cast<const int*>(c); p.y = y;
  p.M = M; p.N = N; p.Kw = K; p.Kx = K; p.planes = 1; p.bn = bn; p.chunks = chunks;
  return launch<int8_t, W_INT8, int8_t, int>(p, splits, static_cast<cudaStream_t>(stream));
}
