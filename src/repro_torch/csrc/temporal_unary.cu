// Thermometer-decomposed (temporal-unary) exact GEMM for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/temporal_unary.py::
// temporal_unary_gemm_pallas (body _kernel). The paper's C1 claim as a
// kernel: temporal coding decomposes an integer GEMM into 2^(w-1) binary
// masked accumulations, one per tick u of the hardware's column counter,
//
//     Y = sum_{u=0}^{2^(w-1)-1}  sign(A) * 1[u < |A|]  @  B
//
// A (M, K), B (K, N) int8 -> Y (M, N) int32. Each term's A side is a
// {-1, 0, +1} matrix (one unary bitline state). On w-bit operands the sum is
// A @ B exactly; on operands outside the w-bit range it saturates |a| at
// 2^(w-1), as the TPU kernel does (in-range operands are the contract; the
// wrapper adds no range check the reference lacks). |a| is taken in int32,
// so -128 counts 128.
//
// What bounds it on the card: the decomposition multiplies the work of one
// int8 GEMM by 2^(w-1) (128x at w=8), so at every serving shape it is bound
// by operations (2^(w-1) * 2*M*K*N), not by the bytes of A and B. That is
// the point of this validation path, not a defect: tugemm_int8.cu is the
// speed path. Design: the int8 GEMM's 32x32 tile loop (csrc/tugemm_int8.cu)
// with the unary loop inside the block, as the TPU kernel's fori_loop runs
// inside its block: each K tile of A and B is loaded into shared memory once,
// A as magnitude bytes (128 fits unsigned) and sign bytes (+1/-1/0); for each
// 4-byte group of K a thread holds its A and B words in registers and runs
// the u loop on them: __vcmpgtu4 builds the 1[|a| > u] byte mask, an AND with
// the sign word gives a_u, and __dp4a accumulates a_u . b exactly in int32.
// B is thus read from device memory once, never once per unary step. Ragged
// M, N and K edges are masked (zeros add nothing), so the caller pads nothing
// where the TPU wrapper padded to block multiples.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;       // output rows per block
constexpr int BN = 32;       // output columns per block
constexpr int BK = 64;       // K per tile
constexpr int NT = 128;      // threads per block: 8 x 16, each 2 rows x 4 cols
constexpr int XS = BK + 4;   // padded row stride in bytes of the shared tiles
constexpr int TPT = BM * BK / NT;   // tile elements each thread loads (A and B alike)
static_assert(BM * BK == BK * BN, "A and B tiles have the same element count");

__global__ void __launch_bounds__(NT) temporal_unary_kernel(
    const int8_t* __restrict__ a, const int8_t* __restrict__ b, int* __restrict__ y,
    int M, int N, int K, int steps) {
  __shared__ __align__(16) uint8_t amag[BM * XS];  // [m][k] |a| (0..128)
  __shared__ __align__(16) int8_t asgn[BM * XS];   // [m][k] sign(a)
  __shared__ __align__(16) int8_t bs[BN * XS];     // [n][k] (transposed)

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int tx = tid % 8;    // columns tx*4 .. tx*4+3
  const int ty = tid / 8;    // rows ty*2 .. ty*2+1

  int acc[2][4] = {};

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
      const int v = av[i];
      amag[(e / BK) * XS + e % BK] = (uint8_t)abs(v);          // int32 abs: |-128| = 128
      asgn[(e / BK) * XS + e % BK] = (int8_t)((v > 0) - (v < 0));
    }
#pragma unroll
    for (int i = 0; i < TPT; ++i) {
      const int e = tid + i * NT;
      bs[(e % BN) * XS + e / BN] = bv[i];
    }
    __syncthreads();

    for (int kk = 0; kk < BK; kk += 4) {
      unsigned mag4[2], sgn4[2];
      int bv4[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mag4[i] = *reinterpret_cast<const unsigned*>(&amag[(ty * 2 + i) * XS + kk]);
        sgn4[i] = *reinterpret_cast<const unsigned*>(&asgn[(ty * 2 + i) * XS + kk]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bv4[j] = *reinterpret_cast<const int*>(&bs[(tx * 4 + j) * XS + kk]);
      // the column counter's ticks: bitline state a_u = sign(a) * 1[|a| > u]
#pragma unroll 4
      for (int u = 0; u < steps; ++u) {
        const unsigned uu = 0x01010101u * (unsigned)u;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int au = (int)(sgn4[i] & __vcmpgtu4(mag4[i], uu));
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(au, bv4[j], acc[i][j]);
        }
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

// steps = 2^(w-1) unary ticks. Returns 0 on success, else the cudaError_t of
// the launch (cudaGetLastError right after it).
extern "C" int temporal_unary_launch(const void* a, const void* b, void* y, int M, int N,
                                     int K, int steps, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  temporal_unary_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b), static_cast<int*>(y),
      M, N, K, steps);
  return (int)cudaGetLastError();
}
