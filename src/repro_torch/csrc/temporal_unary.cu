// Thermometer-decomposed (temporal-unary) exact GEMM for Hopper (sm_90a),
// on the tensor cores.
//
// Replaces the TPU kernel repro/kernels/temporal_unary.py::
// temporal_unary_gemm_pallas (body _kernel). The paper's C1 claim as a
// kernel: temporal coding decomposes an integer GEMM into 2^(w-1) binary
// masked accumulations, one per tick u of the hardware's column counter,
//
//     Y = sum_{u=0}^{2^(w-1)-1}  sign(A) * 1[u < |A|]  @  B
//
// A (M, K), B (K, N) int8 -> Y (M, N) int32. Each term's A side is a
// {-1, 0, +1} matrix (one unary bitline state), and every one of them goes
// through the product, as the TPU kernel's fori_loop does. On w-bit operands
// the sum is A @ B exactly; on operands outside the w-bit range it saturates
// |a| at 2^(w-1), as the TPU kernel does. |-128| counts 128.
//
// What bounds it on this card: the decomposition multiplies the work of one
// int8 GEMM by 2^(w-1) (128x at w=8), so it is bound by operations
// (2^(w-1) * 2*M*K*N) at every serving shape. The first port ran each unary
// step as __dp4a on the CUDA cores, one 32x32 tile per block, 64-128 blocks:
// far below the int8 tensor-core rate and one block per SM.
//
// Design.
// 1. mma.sync.m16n8k32 s8 x s8 -> s32. A block owns a 64x128 output tile
//    (4 warps, 16 rows x 128 columns each). Each K tile (64) of A and B is
//    staged raw into a two-stage ring in shared memory with cp.async, 16
//    bytes a thread (byte loads where K or N is not a multiple of 16), the
//    next tile in flight while the current one is consumed; B's tile is then
//    transposed once in shared memory (4x4 byte transposes by prmt) so each
//    column's K bytes are contiguous, as the mma's B fragment wants. Rows of
//    80 bytes make every fragment load conflict-free. For each 32-wide slice
//    of K, a warp loads its A words and its 16 B fragments into registers
//    once, turns A into magnitude bytes (|-128| = 0x80) and sign bytes
//    (0x01, 0xFF or 0), and runs the unary loop in registers: per step and
//    A register, t = |a| + (127 - u) has bit 7 set iff |a| > u, prmt
//    replicates bit 7 over the byte and an AND with the sign bytes gives the
//    step's {-1, 0, +1} bytes (3 integer ops); the fragment is reused by the
//    warp's 16 mma of the step. B is read from device memory once per
//    (block, K tile), never once per step.
// 2. Enough blocks. A 64x128 tile gives q (64x2048) 16 blocks, so the grid
//    also splits K (whole K tiles) and then the step range: the split plan
//    (kernels/temporal_unary.py split_plan, a plain host function of the
//    shapes) aims at two blocks per SM. Each block adds its partial int32
//    sums into the output, which the launcher zeroes first (one
//    cudaMemsetAsync in the same call), with atomicAdd: integer
//    addition is exact in any order, so the result stays bit-exact and
//    deterministic. Rows of a block past M are skipped by their warp;
//    ragged M, N and K are zero-filled on load and masked on store.
// No early exit past a tile's largest |a|: the work stays what the
// operation bound counts.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

using namespace hopper;

constexpr int BM = 64;       // output rows per block: 4 warps x 16
constexpr int BN = 128;      // output columns per block: 16 n8 fragments a warp
constexpr int BK = 64;       // K per tile
constexpr int NT = 128;      // threads per block
constexpr int AST = BK + 16; // row stride (bytes) of A tiles and of the transposed B tile
constexpr int BST = BN;      // row stride (bytes) of the raw B tile [k][n]
constexpr int NF = BN / 8;   // n8 fragments of a warp

__global__ void __launch_bounds__(NT) temporal_unary_kernel(
    const int8_t* __restrict__ a, const int8_t* __restrict__ b, int* __restrict__ y, int M,
    int N, int K, int steps, int kchunk, int ksplits, int uchunk, int vec16) {
  __shared__ __align__(16) uint8_t As[2][BM * AST];   // raw A tiles [m][k]
  __shared__ __align__(16) uint8_t Bs[2][BK * BST];   // raw B tiles [k][n]
  __shared__ __align__(16) uint8_t Bt[BN * AST];      // B tile transposed [n][k]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int ks = blockIdx.z % ksplits, us = blockIdx.z / ksplits;
  const int k_tiles = (K + BK - 1) / BK;
  const int kt0 = ks * kchunk, kt1 = min(kt0 + kchunk, k_tiles);
  const int u0 = us * uchunk, u1 = min(u0 + uchunk, steps);
  if (kt0 >= kt1 || u0 >= u1) return;   // uniform over the block

  auto load_tile = [&](int kt, int st) {
    const int k0 = kt * BK;
    if (vec16) {   // K and N multiples of 16: whole 16-byte chunks in or out
#pragma unroll
      for (int i = 0; i < BM * BK / 16 / NT; ++i) {
        const int e = tid + i * NT, r = e >> 2, c = (e & 3) * 16;
        const bool ok = m0 + r < M && k0 + c < K;
        cp_async16(&As[st][r * AST + c], ok ? a + (long)(m0 + r) * K + k0 + c : a, ok ? 16 : 0);
      }
#pragma unroll
      for (int i = 0; i < BK * BN / 16 / NT; ++i) {
        const int e = tid + i * NT, r = e >> 3, c = (e & 7) * 16;
        const bool ok = k0 + r < K && n0 + c < N;
        cp_async16(&Bs[st][r * BST + c], ok ? b + (long)(k0 + r) * N + n0 + c : b, ok ? 16 : 0);
      }
    } else {       // any shape: byte loads, zeros past the edges
      for (int e = tid; e < BM * BK; e += NT) {
        const int r = e / BK, c = e % BK;
        As[st][r * AST + c] =
            (m0 + r < M && k0 + c < K) ? (uint8_t)a[(long)(m0 + r) * K + k0 + c] : (uint8_t)0;
      }
      for (int e = tid; e < BK * BN; e += NT) {
        const int r = e / BN, c = e % BN;
        Bs[st][r * BST + c] =
            (k0 + r < K && n0 + c < N) ? (uint8_t)b[(long)(k0 + r) * N + n0 + c] : (uint8_t)0;
      }
    }
    cp_commit();
  };

  const bool active = m0 + warp * 16 < M;
  const int g = lane >> 2, t = lane & 3;
  int acc[NF][4];
#pragma unroll
  for (int j = 0; j < NF; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;

  const int tk = tid >> 3, tn = tid & 7;   // transpose: rows 4tk.., columns 16tn..
  const int nkt = kt1 - kt0;
  load_tile(kt0, 0);
  for (int i = 0; i < nkt; ++i) {
    const int st = i & 1;
    if (i + 1 < nkt) {
      load_tile(kt0 + i + 1, st ^ 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();   // tile i visible

    // transpose B: 4 k rows x 16 n columns per thread, 4x4 byte blocks by prmt
    {
      uint4 r[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        r[q] = *reinterpret_cast<const uint4*>(&Bs[st][(tk * 4 + q) * BST + tn * 16]);
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        unsigned col[4];
        transpose4x4((&r[0].x)[w], (&r[1].x)[w], (&r[2].x)[w], (&r[3].x)[w], col);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<unsigned*>(&Bt[(tn * 16 + w * 4 + j) * AST + tk * 4]) = col[j];
      }
    }
    __syncthreads();   // Bt complete

    if (active) {
      const uint8_t* arow0 = &As[st][(warp * 16 + g) * AST + t * 4];
#pragma unroll
      for (int kk = 0; kk < BK; kk += 32) {
        // A words: rows g, g+8; K bytes t*4.. and 16+t*4..
        const unsigned raw[4] = {
            *reinterpret_cast<const unsigned*>(arow0 + kk),
            *reinterpret_cast<const unsigned*>(arow0 + 8 * AST + kk),
            *reinterpret_cast<const unsigned*>(arow0 + kk + 16),
            *reinterpret_cast<const unsigned*>(arow0 + 8 * AST + kk + 16)};
        unsigned mag[4], sgn[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const unsigned neg = bit7_bytes(raw[q]);                 // 0xFF where a < 0
          mag[q] = (raw[q] ^ neg) + (neg & 0x01010101u);           // |a|, -128 -> 0x80
          const unsigned nz = ((mag[q] + 0x7F7F7F7Fu) & 0x80808080u) >> 7;
          sgn[q] = neg | nz;                                       // 0xFF, 0x01 or 0
        }
        unsigned bf[NF][2];
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          const uint8_t* col = &Bt[(j * 8 + g) * AST + kk + t * 4];
          bf[j][0] = *reinterpret_cast<const unsigned*>(col);
          bf[j][1] = *reinterpret_cast<const unsigned*>(col + 16);
        }
        // the column counter's ticks: a_u = sign(a) * 1[|a| > u]
#pragma unroll 2
        for (int u = u0; u < u1; ++u) {
          const unsigned cu = 0x01010101u * (unsigned)(127 - u);
          unsigned au[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) au[q] = bit7_bytes(mag[q] + cu) & sgn[q];
#pragma unroll
          for (int j = 0; j < NF; ++j) mma_s8(acc[j], au, bf[j][0], bf[j][1]);
        }
      }
    }
    __syncthreads();   // stage st and Bt consumed
  }

  if (!active) return;
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    const int n = n0 + j * 8 + t * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + warp * 16 + g + h * 8;
      if (m >= M) continue;
      if (n < N) atomicAdd(&y[(long)m * N + n], acc[j][2 * h]);
      if (n + 1 < N) atomicAdd(&y[(long)m * N + n + 1], acc[j][2 * h + 1]);
    }
  }
}

}  // namespace

// y is zeroed here (cudaMemsetAsync), then every block adds its partial
// sums. steps = 2^(w-1)
// unary ticks; the grid is (N tiles, M tiles, ksplits * usplits), block z
// taking K tiles [ks*kchunk, +kchunk) and steps [us*uchunk, +uchunk).
// Returns 0 on success, else the cudaError_t of the launch.
extern "C" int temporal_unary_launch(const void* a, const void* b, void* y, int M, int N, int K,
                                     int steps, int kchunk, int ksplits, int uchunk,
                                     int usplits, void* stream) {
  const int vec16 = K % 16 == 0 && N % 16 == 0 &&
                    ((uintptr_t)a | (uintptr_t)b) % 16 == 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, ksplits * usplits);
  cudaError_t err = cudaMemsetAsync(y, 0, (size_t)M * N * sizeof(int),
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  temporal_unary_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b), static_cast<int*>(y), M, N,
      K, steps, kchunk, ksplits, uchunk, vec16);
  return (int)cudaGetLastError();
}
