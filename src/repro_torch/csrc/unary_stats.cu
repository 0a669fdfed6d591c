// tuGEMM cycle-statistics reductions for Hopper (sm_90a).
//
// Replace the TPU kernels repro/kernels/unary_stats.py::colabsmax_pallas and
// ::rowabsmax_pallas. For A (M, K) @ B (K, N), step k of the temporal-unary
// GEMM drains in max_m |A[m,k]| * max(max_n |B[k,n]|, 1) cycles; these two
// launchers compute the two maxima:
//
//     colabsmax: ca[k] = max_m |A[m, k]|     (M, K) int8 -> (K,) int32
//     rowabsmax: rb[k] = max_n |B[k, n]|     (K, N) int8 -> (K,) int32
//
// The absolute value is taken in int32, so -128 counts 128.
//
// What bounds them on the card: one read of the operand (bytes), at sizes
// (64 KiB to 3 MiB) where the launch itself is a large share of the time.
// Design: the TPU kernels carry a running maximum across a sequential grid
// axis; here the whole reduction axis is walked inside one block, so each
// output is written once with no atomics and no zeroed buffer.
// colabsmax: a block holds 32 columns x 8 row lanes; a warp reads 32
// neighbouring bytes of a row, the 8 lanes stride over M, and their maxima
// meet in shared memory. rowabsmax: one warp per row, reading along N in
// 16-byte words when the rows are 16-byte aligned (bytes otherwise), with a
// shuffle-max across the warp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CW = 32;   // colabsmax: columns per block (one per lane)
constexpr int CR = 8;    // colabsmax: row lanes per block (one per warp)
constexpr int RW = 8;    // rowabsmax: rows per block (one per warp)

__global__ void __launch_bounds__(CW * CR) colabsmax_kernel(
    const int8_t* __restrict__ x, int* __restrict__ out, int M, int K) {
  __shared__ int part[CR][CW];
  const int lane = threadIdx.x, w = threadIdx.y;
  const int k = blockIdx.x * CW + lane;
  int mx = 0;
  if (k < K)
    for (int m = w; m < M; m += CR) mx = max(mx, abs((int)x[(long)m * K + k]));
  part[w][lane] = mx;
  __syncthreads();
  if (w == 0 && k < K) {
#pragma unroll
    for (int r = 1; r < CR; ++r) mx = max(mx, part[r][lane]);
    out[k] = mx;
  }
}

__device__ __forceinline__ int absmax_word(int v, int mx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) mx = max(mx, abs((int)(int8_t)(v >> (8 * i))));
  return mx;
}

__global__ void __launch_bounds__(32 * RW) rowabsmax_kernel(
    const int8_t* __restrict__ x, int* __restrict__ out, int K, int N, int vec16) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * RW + threadIdx.x / 32;
  if (row >= K) return;   // uniform across the warp
  const int8_t* r = x + (long)row * N;
  int mx = 0;
  if (vec16) {
    const int4* r4 = reinterpret_cast<const int4*>(r);
    for (int i = lane; i < N / 16; i += 32) {
      const int4 v = r4[i];
      mx = absmax_word(v.x, mx);
      mx = absmax_word(v.y, mx);
      mx = absmax_word(v.z, mx);
      mx = absmax_word(v.w, mx);
    }
  } else {
    for (int i = lane; i < N; i += 32) mx = max(mx, abs((int)r[i]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (lane == 0) out[row] = mx;
}

}  // namespace

// Both return 0 on success, else the cudaError_t of the launch
// (cudaGetLastError right after it).
extern "C" int colabsmax_launch(const void* x, void* out, int M, int K, void* stream) {
  colabsmax_kernel<<<(K + CW - 1) / CW, dim3(CW, CR), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<int*>(out), M, K);
  return (int)cudaGetLastError();
}

// vec16: the caller guarantees N % 16 == 0 and a 16-byte aligned x.
extern "C" int rowabsmax_launch(const void* x, void* out, int K, int N, int vec16,
                                void* stream) {
  rowabsmax_kernel<<<(K + RW - 1) / RW, 32 * RW, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<int*>(out), K, N, vec16);
  return (int)cudaGetLastError();
}
