// tuGEMM cycle statistics for Hopper (sm_90a).
//
// Replace the TPU kernels repro/kernels/unary_stats.py::colabsmax_pallas and
// ::rowabsmax_pallas, and the assembly of their two maxima into TuGemmStats
// that the reference leaves to XLA (repro/kernels/ops.py::unary_step_stats).
// For A (M, K) @ B (K, N), step k of the temporal-unary GEMM drains in
// ca[k] * max(rb[k], 1) cycles, where
//
//     ca[k] = max_m |A[m, k]|,   rb[k] = max_n |B[k, n]|   (|-128| = 128)
//
// and a GEMM's TuGemmStats are step_cycles[k] (int32), serial_cycles =
// sum_k step (int64, summed in int64), parallel_cycles = max_k step,
// max_abs = max(max ca, max rb) and act_max = max ca (int32).
//
// What bounds them on the card: one read of each operand (64 KiB - 3 MiB at
// the serving shapes, 0.02 - 1 us at 3.35 TB/s), less than a launch costs.
// The first port spent a launch on each maximum and left the assembly to
// eight more PyTorch launches, each reading an operand the GEMM had just
// read. The design therefore counts launches:
//
// 1. The GEMM route. tugemm_fused.cu and tugemm_int8.cu take ca and rb from
//    the tiles they already hold (tugemm_mainloop.cuh), plane-major: ca
//    (planes, Kw), rb (Kw, planes). finish_kernel, one block, turns them into
//    the five fields for the logical steps k = p*Kw + kk < K: a GEMM's stats
//    cost its zeroing memset and this one launch. The E GEMMs of one launch
//    over MoE experts are assembled by one launch too, a block an expert.
// 2. The standalone route (ops.unary_step_stats, and the colabsmax /
//    rowabsmax entry points). absmax_kernel reads each operand once, each
//    maximum with one writer, so nothing is zeroed: A's blocks hold 32
//    columns, a byte a lane, and 8 warps stride over M (a warp reads 32
//    neighbouring bytes of a row; the 8 maxima meet in shared memory); B's
//    blocks hold 8 rows, a warp a row, reading along N in 16-byte words
//    where the rows are 16-byte aligned, as byte-wise maxima of four bytes a
//    word (abs_bytes, __vmaxu4). unary_step_stats launches it once on both
//    operands, then finish_kernel on (1, K) / (K, 1): two launches. Lanes
//    over A's rows with 16-byte loads took longer at the serving shapes
//    than a byte a lane over its columns.
//
// Everything is integer and exact; nothing allocates or synchronizes with
// the host, so both routes can be captured in a CUDA graph.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

using hopper::abs_bytes;

constexpr int HDR = 6;      // int32 words of an output before step_cycles:
                            // serial (int64, words 0-1), parallel, max_abs, act_max
constexpr int FU = 8;       // finisher: steps a thread loads before it uses one
constexpr int FT = 512;     // finisher threads
constexpr int CW = 32;      // absmax_kernel, A blocks: columns (a byte a lane)
constexpr int CR = 8;       // absmax_kernel, A blocks: row lanes (a warp each)
constexpr int RW = 8;       // absmax_kernel, B blocks: rows (a warp each)

// The stats of one GEMM from its maxima, by one block: ca is read in logical
// order (plane-major (planes, Kw) is), rb as (Kw, planes), FU steps a thread
// in flight at once. With BATCH, block e takes GEMM e of a batch: its maxima
// at e times their size past ca and rb, its output at e * ostride words past
// out; one GEMM (E = 1) runs the instantiation without those offsets.
template <bool BATCH>
__global__ void __launch_bounds__(FT) finish_kernel(const int* __restrict__ ca,
                                                    const int* __restrict__ rb, int Kw,
                                                    int planes, int K, int ostride,
                                                    int* __restrict__ out) {
  if constexpr (BATCH) {
    ca += (long)blockIdx.x * planes * Kw;
    rb += (long)blockIdx.x * planes * Kw;
    out += (long)blockIdx.x * ostride;
  }
  __shared__ long long s_sum[32];
  __shared__ int s_par[32], s_a[32], s_b[32];
  int* step = out + HDR;
  long long sum = 0;
  int par = 0, am = 0, bm = 0;   // every value is >= 0
  for (int k0 = threadIdx.x; k0 < K; k0 += FU * blockDim.x) {
    int a[FU], b[FU];
#pragma unroll
    for (int u = 0; u < FU; ++u) {
      const int k = k0 + u * blockDim.x, pl = k / Kw, kk = k - pl * Kw;
      a[u] = k < K ? ca[k] : 0;
      b[u] = k < K ? rb[(long)kk * planes + pl] : 0;
    }
#pragma unroll
    for (int u = 0; u < FU; ++u) {
      const int k = k0 + u * blockDim.x, s = a[u] * max(b[u], 1);
      if (k < K) step[k] = s;
      sum += s;
      par = max(par, s);
      am = max(am, a[u]);
      bm = max(bm, b[u]);
    }
  }
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, nw = blockDim.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(~0u, sum, off);
  par = __reduce_max_sync(~0u, par);
  am = __reduce_max_sync(~0u, am);
  bm = __reduce_max_sync(~0u, bm);
  if (lane == 0) {
    s_sum[w] = sum; s_par[w] = par; s_a[w] = am; s_b[w] = bm;
  }
  __syncthreads();
  if (w == 0) {
    sum = lane < nw ? s_sum[lane] : 0;
    par = lane < nw ? s_par[lane] : 0;
    am = lane < nw ? s_a[lane] : 0;
    bm = lane < nw ? s_b[lane] : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(~0u, sum, off);
    par = __reduce_max_sync(~0u, par);
    am = __reduce_max_sync(~0u, am);
    bm = __reduce_max_sync(~0u, bm);
    if (lane == 0) {
      *reinterpret_cast<long long*>(out) = sum;
      out[2] = par;
      out[3] = max(am, bm);
      out[4] = am;
    }
  }
}

// The operands are read through the read-only path (__ldg): the struct's
// pointers carry no __restrict__.
struct AbsArgs {
  const int8_t* a;   // A (M, K), or null
  const int8_t* b;   // B (K, N), or null
  int* ca;           // (K,) max_m |A[m, k]| (with a)
  int* rb;           // (K,) max_n |B[k, n]| (with b)
  int M, N, K;
  int vb;            // 16-byte loads of B's rows
  int ablocks;       // the first ablocks blocks take A, the rest B
};

// DO_A / DO_B: which operands an instantiation reads (the one-operand ones
// carry none of the other's code)
template <bool DO_A, bool DO_B>
__global__ void __launch_bounds__(CW * CR) absmax_kernel(const AbsArgs p) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (DO_A && (!DO_B || (int)blockIdx.x < p.ablocks)) {   // uniform across the block
    __shared__ int part[CR][CW];
    const int k = blockIdx.x * CW + lane;
    int mx = 0;
    if (k < p.K)
      for (int m = w; m < p.M; m += CR) mx = max(mx, abs((int)__ldg(p.a + (long)m * p.K + k)));
    part[w][lane] = mx;
    __syncthreads();
    if (w == 0 && k < p.K) {
#pragma unroll
      for (int r = 1; r < CR; ++r) mx = max(mx, part[r][lane]);
      p.ca[k] = mx;
    }
    return;
  }
  if (!DO_B) return;
  const int row = (blockIdx.x - p.ablocks) * RW + w;
  if (row >= p.K) return;   // uniform across the warp
  const int8_t* r = p.b + (long)row * p.N;
  unsigned m = 0;
  if (p.vb) {
    const uint4* r4 = reinterpret_cast<const uint4*>(r);
    for (int i = lane; i < p.N / 16; i += 32) {
      const uint4 v = __ldg(r4 + i);
      m = __vmaxu4(m, __vmaxu4(__vmaxu4(abs_bytes(v.x), abs_bytes(v.y)),
                               __vmaxu4(abs_bytes(v.z), abs_bytes(v.w))));
    }
    m = __vmaxu4(m, m >> 16);
    m = __vmaxu4(m, m >> 8);
    m &= 0xFFu;
  } else {
    for (int i = lane; i < p.N; i += 32) m = max(m, (unsigned)abs((int)__ldg(r + i)));
  }
  m = __reduce_max_sync(~0u, m);
  if (lane == 0) p.rb[row] = (int)m;
}

}  // namespace

// Both return 0 on success, else the cudaError_t of the launch
// (cudaGetLastError right after it). Every launch runs on `stream`.

// The assembly of E GEMMs' stats: ca (E, planes, Kw) and rb (E, Kw, planes)
// int32 -> out (E, ostride) int32, HDR + K words of each row used, for the
// logical steps k < K <= planes * Kw; ostride is even (the int64 sum).
extern "C" int tugemm_stats_launch(const void* ca, const void* rb, int E, int Kw, int planes,
                                   int K, int ostride, void* out, void* stream) {
  auto kernel = E > 1 ? finish_kernel<true> : finish_kernel<false>;
  kernel<<<E, FT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ca), static_cast<const int*>(rb), Kw, planes, K, ostride,
      static_cast<int*>(out));
  return (int)cudaGetLastError();
}

// The maxima of A (M, K) into ca and/or of B (K, N) into rb (a or b null to
// skip one), K > 0, in one launch.
extern "C" int absmax_launch(const void* a, const void* b, void* ca, void* rb, int M, int N,
                             int K, void* stream) {
  AbsArgs p;
  p.a = static_cast<const int8_t*>(a);
  p.b = static_cast<const int8_t*>(b);
  p.ca = static_cast<int*>(ca);
  p.rb = static_cast<int*>(rb);
  p.M = M; p.N = N; p.K = K;
  p.vb = N % 16 == 0 && (uintptr_t)b % 16 == 0;
  p.ablocks = a != nullptr ? (K + CW - 1) / CW : 0;
  const int blocks = p.ablocks + (b != nullptr ? (K + RW - 1) / RW : 0);
  auto kernel = a == nullptr ? absmax_kernel<false, true>
                : b == nullptr ? absmax_kernel<true, false> : absmax_kernel<true, true>;
  kernel<<<blocks, CW * CR, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
