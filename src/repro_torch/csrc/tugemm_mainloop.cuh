// The split-K s8 tensor-core GEMM mainloop shared by tugemm_fused.cu (the
// fused quantize -> GEMM -> dequant kernel), tugemm_int8.cu (the exact int8
// GEMM) and tugemm_packed.cu (the exact int8 x plane-packed GEMM), for
// Hopper (sm_90a). See tugemm_fused.cu for the design and
// kernels/tugemm_fused.py::split_plan for the grid.
//
// One block (256 threads) owns all rows of a 64-row tile of one expert (grid
// z = expert * M tiles + M tile), bn output columns (grid y) and one K slice
// of `chunks` chunks of KC = 64 rows of W (grid x). A call over E experts
// (the MoE expert GEMMs) is one launch: expert e reads its own X (M, Kx),
// W, scales, bias and C, and writes its own Y and stats, each at e times the
// operand's size past the base pointer. Every kernel takes E > 1 through its
// EXPERTS instantiations (the fused GEMM over the MoE experts, and the int8
// and packed GEMMs of the unfused expert route); a plain GEMM (E = 1) runs
// one compiled without the expert index and offsets. The S blocks of one (M
// tile, N tile) form a thread block cluster; each
// writes its int32 partial tile to its own shared memory, and after a cluster
// barrier every rank reduces 1/S of the tile's elements over all S partials
// (distributed shared memory) and applies the epilogue. Integer sums do not
// depend on order, so the result is exact and deterministic.
//
// Cycle statistics (STATS instantiations, p.collect): ca[p, k] = max_m |X|
// from the X tiles, only in the blocks of N tile 0, and rb[k, p] = max_n |W|
// from the W tiles, only in the blocks of M tile 0, each expert's into its
// own rows of ca and rb, each merged by atomicMax
// into a buffer the launcher zeroed; the order of the merges does not
// matter. The fused kernel compiles them in (collect chosen at run time);
// the int8 GEMM has one instantiation with and one without them, so the
// GEMM without stats carries none of their code; the packed GEMM never
// collects.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_common.cuh"
#include "launch_attrs.cuh"

namespace tugemm {

using namespace hopper;
namespace cg = cooperative_groups;

constexpr int BM = 64;                  // rows of a block tile: 4 m16 fragments
constexpr int KC = 64;                  // W rows a chunk: two mma k-steps a plane
constexpr int NT = 256;                 // 8 warps: each bn/4 columns x 2 m16 fragments
constexpr int NWARP = NT / 32;
constexpr int MPW = BM / 16 / (NWARP / 4);   // m16 fragments a warp
constexpr int QST = KC + 16;            // byte stride of the int8 operand rows (80)
constexpr int NFMAX = 4;                // n8 fragments a warp (bn <= 128)
constexpr int RMAX = 8;                 // deepest raw-copy ring (cp_wait_upto)
constexpr int RING_BUDGET = 96 * 1024;  // raw ring bytes: two blocks an SM
constexpr int PPAD = 8;                 // int32 padding of a partial-tile row
constexpr int MAX_SPLITS = 16;          // the largest (non-portable) cluster
constexpr int SMEM_MAX = 227 * 1024;

enum { W_QUANT = 0, W_INT8 = 1, W_PACKED = 2 };

struct Params {
  const void* x;        // (E, M, Kx) XT: plane p's columns are [p*Kw, (p+1)*Kw)
  const void* w;        // (E, Kw, N) WT
  const float* sx;      // (E, 1) or (E, M) (fused only)
  const float* sw;      // (E, N) (fused only)
  const void* bias;     // (E, N) OT or null (fused only)
  const int* c;         // (E, M, N) int32 or null (int8 GEMM only)
  void* y;              // (E, M, N) OT
  int* ca;              // (E, planes, Kw), zeroed by the caller (STATS, collect)
  int* rb;              // (E, Kw, planes), zeroed by the caller (STATS, collect)
  int E;                // experts (0 is taken as 1)
  int M, N, Kw, planes, bits, per_token, collect;
  int Kx;               // X's row length (<= planes*Kw); columns past it read as 0
  int bn, chunks;       // the split plan: tile columns, chunks a K slice
  int ring;             // raw stages (ring_depth)
  int vx, vw;           // 16-byte copies of X rows / W rows allowed
};

// shared memory: [raw ring | partial tile (aliased)] [xq: 2 x planes x BM x QST]
// [wq: 2 x planes x bn x QST] [ca scratch: NWARP x planes x KC/4 words]
struct Layout {
  int xraw, stage, xq, wq, scratch, total;
};

__host__ __device__ inline Layout layout(int planes, int bn, int ring, int xsize, int wsize) {
  Layout l;
  l.xraw = BM * planes * KC * xsize;
  l.stage = l.xraw + KC * bn * wsize;
  const int part = BM * (bn + PPAD) * 4;
  l.xq = ring * l.stage > part ? ring * l.stage : part;
  l.wq = l.xq + 2 * planes * BM * QST;
  l.scratch = l.wq + 2 * planes * bn * QST;
  l.total = l.scratch + NWARP * planes * (KC / 4) * 4;
  return l;
}

// raw stages: the whole slice where it fits the budget, at most RMAX
inline int ring_depth(int planes, int bn, int chunks, int xsize, int wsize) {
  const int stage = BM * planes * KC * xsize + KC * bn * wsize;
  int r = RING_BUDGET / stage;
  r = r < 1 ? 1 : (r > RMAX ? RMAX : r);
  return chunks < 1 ? 1 : (chunks < r ? chunks : r);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T zero_of() { return T(0); }
template <> __device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

template <typename O> __device__ __forceinline__ O from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// bias add in the output type (bf16: through f32, rounded once back to bf16)
__device__ __forceinline__ float add_out(float y, float b) { return __fadd_rn(y, b); }
__device__ __forceinline__ __nv_bfloat16 add_out(__nv_bfloat16 y, __nv_bfloat16 b) {
  return __float2bfloat16_rn(__fadd_rn(__bfloat162float(y), __bfloat162float(b)));
}

// IEEE divide, round half to even, clamp: the plain version's ops
__device__ __forceinline__ int quant(float v, float s, int lo, int hi) {
  float q = rintf(__fdiv_rn(v, s));
  q = fminf(fmaxf(q, (float)lo), (float)hi);
  return (int)q;
}

__device__ __forceinline__ unsigned pack4(int a, int b, int c, int d) {
  return (unsigned)(a & 0xFF) | (unsigned)(b & 0xFF) << 8 | (unsigned)(c & 0xFF) << 16 |
         (unsigned)(d & 0xFF) << 24;
}

__device__ __forceinline__ float bf16_lo(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(unsigned u) { return __uint_as_float(u & 0xFFFF0000u); }

// one 16-byte raw chunk of X -> its int8 codes, packed 4 to a word
__device__ __forceinline__ void quant_chunk(float, uint4 r, float s, int lo, int hi,
                                            unsigned* q) {
  q[0] = pack4(quant(__uint_as_float(r.x), s, lo, hi), quant(__uint_as_float(r.y), s, lo, hi),
               quant(__uint_as_float(r.z), s, lo, hi), quant(__uint_as_float(r.w), s, lo, hi));
}
__device__ __forceinline__ void quant_chunk(__nv_bfloat16, uint4 r, float s, int lo, int hi,
                                            unsigned* q) {
  q[0] = pack4(quant(bf16_lo(r.x), s, lo, hi), quant(bf16_hi(r.x), s, lo, hi),
               quant(bf16_lo(r.y), s, lo, hi), quant(bf16_hi(r.y), s, lo, hi));
  q[1] = pack4(quant(bf16_lo(r.z), s, lo, hi), quant(bf16_hi(r.z), s, lo, hi),
               quant(bf16_lo(r.w), s, lo, hi), quant(bf16_hi(r.w), s, lo, hi));
}

// four consecutive W values of one raw row, as f32
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  v[0] = __uint_as_float(r.x); v[1] = __uint_as_float(r.y);
  v[2] = __uint_as_float(r.z); v[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  v[0] = bf16_lo(r.x); v[1] = bf16_hi(r.x); v[2] = bf16_lo(r.y); v[3] = bf16_hi(r.y);
}

// plane pl of four packed bytes, sign-extended: the field XOR its sign bit,
// minus the sign bit, done as + (0x80 - s) then XOR 0x80 so no carry leaves
// a byte (equal to the plain version's shift-up, arithmetic shift-down)
__device__ __forceinline__ unsigned decode_plane(unsigned r, int pl, int bits) {
  const unsigned s = 1u << (bits - 1);
  const unsigned f = ((r >> (pl * bits)) & (0x01010101u * ((1u << bits) - 1))) ^ (0x01010101u * s);
  return (f + 0x01010101u * (0x80u - s)) ^ 0x80808080u;
}

__device__ __forceinline__ unsigned lds32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

template <typename XT, int WMODE, typename WT, typename OT, bool STATS, bool EXPERTS>
__global__ void __launch_bounds__(NT, 2) gemm_kernel(const Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr bool INT_GEMM = std::is_same<XT, int8_t>::value;   // X taken as stored
  constexpr int XE = 16 / (int)sizeof(XT);   // X elements a 16-byte chunk
  constexpr int XW = XE / 4;                 // int8 words they become
  constexpr int WE = 16 / (int)sizeof(WT);   // W elements a 16-byte chunk
  cg::cluster_group cluster = cg::this_cluster();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slice = blockIdx.x, S = gridDim.x;   // cluster rank, cluster size
  const int bn = p.bn, planes = p.planes, R = p.ring;
  const int M = p.M, N = p.N, Kw = p.Kw;
  const int Kx = p.Kx;
  // the expert (0 unless EXPERTS: every offset below folds away)
  const int ex = EXPERTS ? (int)blockIdx.z / ((M + BM - 1) / BM) : 0;
  const int mtile = EXPERTS ? (int)blockIdx.z - ex * ((M + BM - 1) / BM) : (int)blockIdx.z;
  const int n0 = blockIdx.y * bn, m0 = mtile * BM;
  // this expert's operands: X and W as pointers; the scales and stats as
  // int offsets into the kernel parameters' pointers (fewer registers)
  const XT* X = static_cast<const XT*>(p.x) + (long)ex * M * Kx;
  const WT* W = static_cast<const WT*>(p.w) + (long)ex * Kw * N;
  const int sxo = ex * (p.per_token ? M : 1), swo = ex * N, so = ex * planes * Kw;
  const int mrows = min(BM, M - m0);
  const int mfr = (mrows + 15) >> 4;        // m16 fragments holding rows
  const int rows = mfr * 16;                // X rows copied and quantized
  const int kc0 = slice * p.chunks;
  const int nch = max(0, min(p.chunks, (Kw + KC - 1) / KC - kc0));
  const int lo = INT_GEMM ? 0 : -(1 << (p.bits - 1));
  const int hi = INT_GEMM ? 0 : (1 << (p.bits - 1)) - 1;
  const bool do_ca = STATS && p.collect && blockIdx.y == 0;
  const bool do_rb = STATS && p.collect && mtile == 0;
  const float sx0 = (INT_GEMM || p.per_token) ? 0.f : p.sx[sxo];

  const Layout L = layout(planes, bn, R, (int)sizeof(XT), (int)sizeof(WT));
  int8_t* xq = reinterpret_cast<int8_t*>(smem + L.xq);
  int8_t* wq = reinterpret_cast<int8_t*>(smem + L.wq);
  unsigned* scratch = reinterpret_cast<unsigned*>(smem + L.scratch);
  const int xch = planes * KC / XE;   // 16-byte chunks of a raw X row (a power of 2)
  const int wch = bn / WE;            // 16-byte chunks of a raw W row (a power of 2)
  const int xsh = __ffs(xch) - 1, wsh = __ffs(wch) - 1, bsh = __ffs(bn) - 1;

  // chunk i of this slice into raw stage st, one commit group; ragged edges
  // (rows past M, W rows past Kw, X columns past Kx) are zero-filled
  // (cp.async reads only the valid bytes of a chunk)
  auto load_chunk = [&](int i, int st) {
    const int k0 = (kc0 + i) * KC;
    uint8_t* xs = smem + st * L.stage;
    uint8_t* ws = xs + L.xraw;
    if (p.vx) {
      for (int e = tid; e < rows * xch; e += NT) {
        const int r = e >> xsh, c = e & (xch - 1);
        const int pl = c / (KC / XE), kk = k0 + (c - pl * (KC / XE)) * XE;
        const int col = pl * Kw + kk;
        const int nv = m0 + r < M ? max(0, min(min(XE, Kw - kk), Kx - col)) : 0;
        cp_async16(xs + e * 16, nv ? X + (long)(m0 + r) * Kx + col : X, nv * (int)sizeof(XT));
      }
    } else {
      XT* xd = reinterpret_cast<XT*>(xs);
      const int rw = planes * KC;
      for (int e = tid; e < rows * rw; e += NT) {
        const int r = e / rw, c = e - r * rw;
        const int pl = c / KC, kk = k0 + c - pl * KC, col = pl * Kw + kk;
        xd[e] = (m0 + r < M && kk < Kw && col < Kx) ? X[(long)(m0 + r) * Kx + col]
                                                    : zero_of<XT>();
      }
    }
    if (p.vw) {
      for (int e = tid; e < KC * wch; e += NT) {
        const int r = e >> wsh, c = e & (wch - 1);
        const int k = k0 + r, n = n0 + c * WE;
        const int nv = k < Kw ? max(0, min(WE, N - n)) : 0;
        cp_async16(ws + e * 16, nv ? W + (long)k * N + n : W, nv * (int)sizeof(WT));
      }
    } else {
      WT* wd = reinterpret_cast<WT*>(ws);
      for (int e = tid; e < KC * bn; e += NT) {
        const int r = e >> bsh, c = e & (bn - 1);
        wd[e] = (k0 + r < Kw && n0 + c < N) ? W[(long)(k0 + r) * N + n0 + c] : zero_of<WT>();
      }
    }
    cp_commit();
  };

  int acc[MPW][NFMAX][4];   // this warp's m16 fragments x its n8 fragments
#pragma unroll
  for (int mt = 0; mt < MPW; ++mt)
#pragma unroll
    for (int j = 0; j < NFMAX; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0;

  // every chunk of the slice in flight at once where the ring holds them
  for (int i = 0; i < R; ++i) {
    if (i < nch) load_chunk(i, i);
    else cp_commit();
  }

  const int nf = bn / 32;                   // n8 fragments of a warp
  const int wn = warp & 3, wm = warp >> 2;  // column group, m16 fragment group
  const int g = lane >> 2, t4 = lane & 3;
  const int xc = tid & (xch - 1);           // this thread's X chunk column
  const int xpl = xc / (KC / XE), xkb = (xc % (KC / XE)) * XE;
  const int tpk = bn / 4, tsh = bsh - 2;    // W tasks (lanes) sharing 4 k rows
  const int pw = planes * (KC / 4);         // ca words of a chunk

  for (int i = 0; i < nch; ++i) {
    const int st = i % R, buf = i & 1, k0 = (kc0 + i) * KC;
    cp_wait_upto(R - 1);   // chunk i landed (one commit group per chunk or step)
    __syncthreads();
    const uint8_t* xs = smem + st * L.stage;
    const uint8_t* ws = xs + L.xraw;
    int8_t* xqb = xq + buf * planes * BM * QST;
    int8_t* wqb = wq + buf * planes * bn * QST;

    // X: one 16-byte raw chunk a step -> int8 [plane][m][k]; ca maxima in registers
    unsigned xmax[XW];
#pragma unroll
    for (int w = 0; w < XW; ++w) xmax[w] = 0;
    if (do_ca) {   // this warp's scratch row: words of chunks no lane of it owns stay 0
      for (int t = lane; t < pw; t += 32) scratch[warp * pw + t] = 0;
      __syncwarp();
    }
    for (int r = tid >> xsh; r < rows; r += NT >> xsh) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xs + (r * xch + xc) * 16);
      unsigned q[XW];
      if constexpr (INT_GEMM) {
        q[0] = raw.x; q[1] = raw.y; q[2] = raw.z; q[3] = raw.w;
      } else {
        const float s = p.per_token ? (m0 + r < M ? p.sx[sxo + m0 + r] : 1.f) : sx0;
        quant_chunk(XT(), raw, s, lo, hi, q);   // padding quantizes to 0
      }
      int8_t* dst = xqb + (xpl * BM + r) * QST + xkb;
      if constexpr (XW == 1) *reinterpret_cast<unsigned*>(dst) = q[0];
      else if constexpr (XW == 2) *reinterpret_cast<uint2*>(dst) = make_uint2(q[0], q[1]);
      else *reinterpret_cast<uint4*>(dst) = make_uint4(q[0], q[1], q[2], q[3]);
      if (do_ca) {
#pragma unroll
        for (int w = 0; w < XW; ++w) xmax[w] = __vmaxu4(xmax[w], abs_bytes(q[w]));
      }
    }
    if (do_ca) {
      for (int off = xch; off < 32; off <<= 1) {
#pragma unroll
        for (int w = 0; w < XW; ++w)
          xmax[w] = __vmaxu4(xmax[w], __shfl_xor_sync(~0u, xmax[w], off));
      }
      if (lane < xch) {   // one lane a chunk column of this warp
#pragma unroll
        for (int w = 0; w < XW; ++w) scratch[warp * pw + xc * XW + w] = xmax[w];
      }
    }

    // W: a task is 4 k rows x 4 columns -> per plane, 4 words of 4 k bytes,
    // one a column, stored [plane][n][k] as the mma's B fragment wants;
    // rb maxima over the task's columns, then over the lanes sharing its rows
    for (int t = tid; t < (KC / 4) * tpk; t += NT) {
      const int kg = t >> tsh, ng = t & (tpk - 1);
      unsigned raw[4];
      if constexpr (WMODE != W_QUANT) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          raw[q] = *reinterpret_cast<const unsigned*>(ws + (kg * 4 + q) * bn + ng * 4);
      }
      for (int pl = 0; pl < planes; ++pl) {
        unsigned col[4];
        if constexpr (WMODE == W_QUANT) {
          float v[4][4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            load4(reinterpret_cast<const WT*>(ws) + (kg * 4 + q) * bn + ng * 4, v[q]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = n0 + ng * 4 + j;
            col[j] = 0;
            if (n < N) {
              const float s = p.sw[swo + n];
              col[j] = pack4(quant(v[0][j], s, lo, hi), quant(v[1][j], s, lo, hi),
                             quant(v[2][j], s, lo, hi), quant(v[3][j], s, lo, hi));
            }
          }
        } else if constexpr (WMODE == W_PACKED) {
          transpose4x4(decode_plane(raw[0], pl, p.bits), decode_plane(raw[1], pl, p.bits),
                       decode_plane(raw[2], pl, p.bits), decode_plane(raw[3], pl, p.bits), col);
        } else {
          transpose4x4(raw[0], raw[1], raw[2], raw[3], col);
        }
        int8_t* base = wqb + (pl * bn + ng * 4) * QST + kg * 4;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {   // rotated by ng: fewer bank conflicts
          const int j = (jj + ng) & 3;
          const unsigned v = j == 0 ? col[0] : j == 1 ? col[1] : j == 2 ? col[2] : col[3];
          *reinterpret_cast<unsigned*>(base + j * QST) = v;
        }
        if (do_rb) {
          unsigned m = __vmaxu4(__vmaxu4(abs_bytes(col[0]), abs_bytes(col[1])),
                                __vmaxu4(abs_bytes(col[2]), abs_bytes(col[3])));
          for (int off = 1; off < tpk; off <<= 1) m = __vmaxu4(m, __shfl_xor_sync(~0u, m, off));
          if (ng == 0) {
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              const int k = k0 + kg * 4 + b;
              const int v = (int)((m >> (8 * b)) & 0xFFu);
              if (v && k < Kw) atomicMax(&p.rb[so + (long)k * planes + pl], v);
            }
          }
        }
      }
    }
    __syncthreads();   // raw stage st consumed; xq/wq[buf] and the ca scratch complete

    if (i + R < nch) load_chunk(i + R, st);
    else cp_commit();

    if (do_ca) {   // one atomicMax per (plane, k) of the chunk
      for (int t = tid; t < pw; t += NT) {
        unsigned m = 0;
#pragma unroll
        for (int w = 0; w < NWARP; ++w) m = __vmaxu4(m, scratch[w * pw + t]);
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int col = t * 4 + b, pl = col / KC, k = k0 + col % KC;
          const int v = (int)((m >> (8 * b)) & 0xFFu);
          if (v && k < Kw) atomicMax(&p.ca[so + (long)pl * Kw + k], v);
        }
      }
    }

    // the product: every plane's 64 k of this chunk; this warp's m16
    // fragments that hold rows and its bn/4 columns
    for (int pl = 0; pl < planes; ++pl) {
#pragma unroll
      for (int kk = 0; kk < KC; kk += 32) {
        const int8_t* xa = xqb + pl * BM * QST + kk;
        const int8_t* wb = wqb + (pl * bn + wn * nf * 8) * QST + kk;
        unsigned b[NFMAX][2];
#pragma unroll
        for (int j = 0; j < NFMAX; ++j) {
          if (j < nf) {
            const int8_t* cj = wb + (j * 8 + g) * QST + t4 * 4;
            b[j][0] = lds32(cj);
            b[j][1] = lds32(cj + 16);
          }
        }
#pragma unroll
        for (int mt = 0; mt < MPW; ++mt) {
          if (wm * MPW + mt < mfr) {
            const int8_t* ar = xa + ((wm * MPW + mt) * 16 + g) * QST + t4 * 4;
            const unsigned a[4] = {lds32(ar), lds32(ar + 8 * QST), lds32(ar + 16),
                                   lds32(ar + 8 * QST + 16)};
#pragma unroll
            for (int j = 0; j < NFMAX; ++j)
              if (j < nf) mma_s8(acc[mt][j], a, b[j][0], b[j][1]);
          }
        }
      }
    }
  }

  // partial tile into shared memory over the raw ring: every thread is past
  // the last chunk's second barrier, and no copy is in flight
  int* part = reinterpret_cast<int*>(smem);
  const int pst = bn + PPAD;
#pragma unroll
  for (int mt = 0; mt < MPW; ++mt) {
    if (wm * MPW + mt < mfr) {
#pragma unroll
      for (int j = 0; j < NFMAX; ++j) {
        if (j < nf) {
          const int r = (wm * MPW + mt) * 16 + g, c = (wn * nf + j) * 8 + 2 * t4;
          *reinterpret_cast<int2*>(&part[r * pst + c]) = make_int2(acc[mt][j][0], acc[mt][j][1]);
          *reinterpret_cast<int2*>(&part[(r + 8) * pst + c]) =
              make_int2(acc[mt][j][2], acc[mt][j][3]);
        }
      }
    }
  }
  cluster.sync();   // every rank's partial tile visible across the cluster

  // rank `slice` reduces its share of the tile's (row, 4-column) units over
  // the S partials, then the epilogue
  const int ncols = min(bn, N - n0);
  const int upr = (ncols + 3) >> 2;
  const int U = mrows * upr;
  const int u0 = (int)((long)U * slice / S), u1 = (int)((long)U * (slice + 1) / S);
  OT* Y = static_cast<OT*>(p.y) + (long)ex * M * N;
  for (int u = u0 + tid; u < u1; u += NT) {
    const int r = u / upr, c = (u - r * upr) * 4;
    int s4[4] = {0, 0, 0, 0};
#pragma unroll 4
    for (int q = 0; q < S; ++q) {
      const int* src = cluster.map_shared_rank(part, q);
      const int4 v = *reinterpret_cast<const int4*>(src + r * pst + c);
      s4[0] += v.x; s4[1] += v.y; s4[2] += v.z; s4[3] += v.w;
    }
    const int m = m0 + r;
    if constexpr (INT_GEMM) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + c + j;
        if (n < N) {
          const long o = (long)m * N + n;
          Y[o] = p.c != nullptr ? s4[j] + p.c[(long)ex * M * N + o] : s4[j];
        }
      }
    } else {
      const float s_m = p.per_token ? p.sx[sxo + m] : sx0;
      const OT* B = p.bias == nullptr ? nullptr : static_cast<const OT*>(p.bias) + swo;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + c + j;
        if (n < N) {
          const float v = __fmul_rn(__int2float_rn(s4[j]), __fmul_rn(s_m, p.sw[swo + n]));
          OT o = from_f32<OT>(v);
          if (B != nullptr) o = add_out(o, B[n]);
          Y[(long)m * N + n] = o;
        }
      }
    }
  }
  cluster.sync();   // no rank leaves while another still reads its partial tile
}

// Launches gemm_kernel on the plan (p.bn, p.chunks; splits = cluster size).
// Returns 0, -2 for a plan outside the kernel's range, or the cudaError_t.
// One launch of the gemm_kernel instantiation: grid (splits, N tiles, z)
// with the cluster over x, and its shared-memory attributes set once per
// device.
template <typename XT, int WMODE, typename WT, typename OT, bool STATS, bool EXPERTS>
int launch_kernel(const Params& p, int splits, unsigned zdim, int smem, cudaStream_t stream) {
  auto kern = gemm_kernel<XT, WMODE, WT, OT, STATS, EXPERTS>;
  static launch_attrs::Cache attrs;   // per instantiation, per device
  cudaError_t e = launch_attrs::allow(attrs, kern, SMEM_MAX, true);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (p.N + p.bn - 1) / p.bn, zdim);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// STATS: the statistics code is compiled in (taken where p.collect is set);
// by default for the quantizing kernel, not for int8 X taken as stored.
// E > 1 runs the EXPERTS instantiation.
template <typename XT, int WMODE, typename WT, typename OT,
          bool STATS = !std::is_same<XT, int8_t>::value>
int launch(Params p, int splits, cudaStream_t stream) {
  if (p.E < 1) p.E = 1;
  const long zdim = (long)p.E * ((p.M + BM - 1) / BM);
  if (!(p.bn == 32 || p.bn == 64 || p.bn == 128) || splits < 1 || splits > MAX_SPLITS ||
      p.chunks < 1 || p.planes < 1 || p.planes > 4 || p.Kx < 0 || p.Kx > p.planes * p.Kw ||
      zdim > 65535)
    return -2;
  p.ring = ring_depth(p.planes, p.bn, p.chunks, (int)sizeof(XT), (int)sizeof(WT));
  const Layout L = layout(p.planes, p.bn, p.ring, (int)sizeof(XT), (int)sizeof(WT));
  if (L.total > SMEM_MAX) return -2;
  // 16-byte X copies: every plane's start and every row's start on 16 bytes
  p.vx = (uintptr_t)p.x % 16 == 0 && ((long)p.Kw * sizeof(XT)) % 16 == 0 &&
         ((long)p.Kx * sizeof(XT)) % 16 == 0;
  p.vw = (uintptr_t)p.w % 16 == 0 && ((long)p.N * sizeof(WT)) % 16 == 0;
  if (p.E > 1)
    return launch_kernel<XT, WMODE, WT, OT, STATS, true>(p, splits, (unsigned)zdim, L.total,
                                                         stream);
  return launch_kernel<XT, WMODE, WT, OT, STATS, false>(p, splits, (unsigned)zdim, L.total,
                                                        stream);
}

}  // namespace tugemm
