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
// What bounds it on the card: on the unfused serving path M is small
// (max_batch x step width, 4..64 rows), so the kernel is bound by reading B
// once (bytes), far below the int8 tensor-core rate. Design: the fused
// kernel's tile loop (csrc/tugemm_fused.cu) without the quantizer. A grid of
// (N/BN, M/BM) output tiles with the K loop inside the block (the TPU's
// sequential K grid axis); every global load of a K step is issued before
// any is stored to shared memory; B is stored transposed so both operands
// are read as 4-byte words and multiplied exactly with __dp4a. Ragged M, N
// and K edges are masked here (zeros are invisible to an exact sum), so the
// caller pads nothing where the TPU wrapper padded to block multiples.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;       // output rows per block
constexpr int BN = 32;       // output columns per block
constexpr int BK = 64;       // K per step
constexpr int NT = 128;      // threads per block: 8 x 16, each 2 rows x 4 cols
constexpr int XS = BK + 4;   // padded row stride in bytes of the shared tiles
constexpr int TPT = BM * BK / NT;   // tile elements each thread loads (A and B alike)
static_assert(BM * BK == BK * BN, "A and B tiles have the same element count");

__global__ void __launch_bounds__(NT) tugemm_int8_kernel(
    const int8_t* __restrict__ a, const int8_t* __restrict__ b,
    const int* __restrict__ c, int* __restrict__ y, int M, int N, int K) {
  __shared__ __align__(16) int8_t as[BM * XS];   // [m][k]
  __shared__ __align__(16) int8_t bs[BN * XS];   // [n][k] (transposed)

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int tx = tid % 8;    // columns tx*4 .. tx*4+3
  const int ty = tid / 8;    // rows ty*2 .. ty*2+1

  int acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + ty * 2 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      acc[i][j] = (c != nullptr && m < M && n < N) ? c[(long)m * N + n] : 0;
    }
  }

  for (int k0 = 0; k0 < K; k0 += BK) {
    int8_t av[TPT], bv[TPT];
#pragma unroll
    for (int i = 0; i < TPT; ++i) {
      const int e = tid + i * NT;
      const int m = m0 + e / BK, k = k0 + e % BK;
      av[i] = (m < M && k < K) ? a[(long)m * K + k] : (int8_t)0;
    }
#pragma unroll
    for (int i = 0; i < TPT; ++i) {
      const int e = tid + i * NT;
      const int k = k0 + e / BN, n = n0 + e % BN;
      bv[i] = (k < K && n < N) ? b[(long)k * N + n] : (int8_t)0;
    }
    __syncthreads();  // tiles of the previous step are consumed
#pragma unroll
    for (int i = 0; i < TPT; ++i) {
      const int e = tid + i * NT;
      as[(e / BK) * XS + e % BK] = av[i];
    }
#pragma unroll
    for (int i = 0; i < TPT; ++i) {
      const int e = tid + i * NT;
      bs[(e % BN) * XS + e / BN] = bv[i];
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; kk += 4) {
      int av4[2], bv4[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        av4[i] = *reinterpret_cast<const int*>(&as[(ty * 2 + i) * XS + kk]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bv4[j] = *reinterpret_cast<const int*>(&bs[(tx * 4 + j) * XS + kk]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av4[i], bv4[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + ty * 2 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) y[(long)m * N + n] = acc[i][j];
    }
  }
}

}  // namespace

// Returns 0 on success, else the cudaError_t of the launch (cudaGetLastError
// right after it). c may be null.
extern "C" int tugemm_int8_launch(const void* a, const void* b, const void* c, void* y,
                                  int M, int N, int K, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  tugemm_int8_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<const int*>(c), static_cast<int*>(y), M, N, K);
  return (int)cudaGetLastError();
}
