// Exact int8 x plane-packed int4/int2 GEMM for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/tugemm_packed.py::matmul_packed_pallas.
// One launch computes
//
//     Y[m, n] = sum_p sum_k A[m, p*Kp + k] * plane_p(PB)[k, n]      (int32)
//
// with PB (Kp, N) int8 holding 8/bits values per byte in plane layout
// (kernels/packing.py): plane p of packed row k sits in bits
// [p*bits, (p+1)*bits) and is logical row k + p*Kp of B. A (M, K) has
// K <= planes*Kp logical columns; columns at or past K read as zeros, the
// TPU wrapper's zero extension of A done by masking instead of a copy.
//
// What bounds it on the card: reading the packed weight once (bytes; 2-4x
// fewer than int8, which is the point of the format), far below the int8
// tensor-core rate at the serving path's 4..64 rows. Design: the tile loop
// of the int8 GEMM (csrc/tugemm_int8.cu) with a packed B tile. Each K step
// loads one (BK, BN) packed tile and the matching A tile of every plane,
// issued before any is stored; the packed tile is unpacked once into one
// shared int8 tile per plane, sign-extended by the int-shift decode (shift
// the field to the top of the byte, arithmetic-shift it back down), and
// each plane's A tile accumulates against its own unpacked tile with __dp4a.
// Ragged M, N, Kp and K edges are masked, so the caller pads nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;       // output rows per block
constexpr int BN = 32;       // output columns per block
constexpr int BK = 64;       // packed rows per step
constexpr int NT = 128;      // threads per block: 8 x 16, each 2 rows x 4 cols
constexpr int XS = BK + 4;   // padded row stride in bytes of the shared tiles
constexpr int TPT = BM * BK / NT;   // tile elements each thread loads
static_assert(BM * BK == BK * BN, "A and B tiles have the same element count");

template <int BITS>
__global__ void __launch_bounds__(NT) tugemm_packed_kernel(
    const int8_t* __restrict__ a, const int8_t* __restrict__ pb,
    int* __restrict__ y, int M, int N, int K, int Kp) {
  constexpr int PLANES = 8 / BITS;
  __shared__ __align__(16) int8_t as[PLANES][BM * XS];   // [p][m][k]
  __shared__ __align__(16) int8_t bs[PLANES][BN * XS];   // [p][n][k] (transposed)

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int tx = tid % 8;    // columns tx*4 .. tx*4+3
  const int ty = tid / 8;    // rows ty*2 .. ty*2+1

  int acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < Kp; k0 += BK) {
    int8_t av[PLANES][TPT], bv[TPT];
#pragma unroll
    for (int p = 0; p < PLANES; ++p)
#pragma unroll
      for (int i = 0; i < TPT; ++i) {
        const int e = tid + i * NT;
        const int m = m0 + e / BK, k = k0 + e % BK;
        const long col = (long)p * Kp + k;
        av[p][i] = (m < M && k < Kp && col < K) ? a[(long)m * K + col] : (int8_t)0;
      }
#pragma unroll
    for (int i = 0; i < TPT; ++i) {
      const int e = tid + i * NT;
      const int k = k0 + e / BN, n = n0 + e % BN;
      bv[i] = (k < Kp && n < N) ? pb[(long)k * N + n] : (int8_t)0;   // 0 decodes to 0
    }
    __syncthreads();  // tiles of the previous step are consumed
#pragma unroll
    for (int p = 0; p < PLANES; ++p)
#pragma unroll
      for (int i = 0; i < TPT; ++i) {
        const int e = tid + i * NT;
        as[p][(e / BK) * XS + e % BK] = av[p][i];
      }
#pragma unroll
    for (int i = 0; i < TPT; ++i) {
      const int e = tid + i * NT;
      const int r = e / BN, c = e % BN;   // r: packed k, c: n
      const int byte = (int)(uint8_t)bv[i];
#pragma unroll
      for (int p = 0; p < PLANES; ++p) {
        const int up = 8 - (p + 1) * BITS;
        bs[p][c * XS + r] = (int8_t)((int)(int8_t)(uint8_t)(byte << up) >> (8 - BITS));
      }
    }
    __syncthreads();

#pragma unroll
    for (int p = 0; p < PLANES; ++p) {
#pragma unroll 4
      for (int kk = 0; kk < BK; kk += 4) {
        int av4[2], bv4[4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          av4[i] = *reinterpret_cast<const int*>(&as[p][(ty * 2 + i) * XS + kk]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bv4[j] = *reinterpret_cast<const int*>(&bs[p][(tx * 4 + j) * XS + kk]);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av4[i], bv4[j], acc[i][j]);
      }
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

// Returns 0 on success, -1 for a bitwidth other than 4 or 2, else the
// cudaError_t of the launch (cudaGetLastError right after it).
extern "C" int tugemm_packed_launch(const void* a, const void* pb, void* y, int M, int N,
                                    int K, int Kp, int bits, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* a8 = static_cast<const int8_t*>(a);
  const int8_t* b8 = static_cast<const int8_t*>(pb);
  int* y32 = static_cast<int*>(y);
  if (bits == 4)
    tugemm_packed_kernel<4><<<grid, NT, 0, s>>>(a8, b8, y32, M, N, K, Kp);
  else if (bits == 2)
    tugemm_packed_kernel<2><<<grid, NT, 0, s>>>(a8, b8, y32, M, N, K, Kp);
  else
    return -1;
  return (int)cudaGetLastError();
}
