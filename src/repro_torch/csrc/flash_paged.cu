// Paged flash-decode attention for Hopper (sm_90a): split over pages, then
// combine (flash-decoding).
//
// Replaces the TPU kernel repro/kernels/flash_paged.py::flash_paged_decode.
// Attention for a step of Sq query positions per row, read straight from the
// paged KV pool through per-row block tables: int8 K/V pages are dequantized
// with their per-(page, token) scales as they are read, scores and the
// softmax run in f32, and no gathered copy of the pool is ever written.
//
// Masks (the reference's, l.129-136): key k of row b is visible to query row
// r iff k < kv_len[b], and (causal) k <= pos[b] + r % Sq, and (window > 0)
// pos[b] + r % Sq - k < window. Masked probabilities are set to exactly 0
// after the exp, so a fully masked (idle) row emits exact zeros. The flush
// divides by max(l, 1e-30). q is pre-scaled by qscale = 1/sqrt(hd_tot).
//
// What bounds it on this card: decode reads every live page of K and V once
// per (row, kv head) and does ~2 flops per loaded element per query row, so
// at decode it is bound by device-memory bytes; MLA's 16 heads x 16 query
// positions per kv head (K width 576) make the step16 case bound by f32
// operations. At the serving batch (4 rows) the danger is neither: one block
// per (row, kv head) gives 4-32 blocks for 132 SMs, and a block that walks
// 128 pages in sequence pays the load latency of every page.
//
// Design.
// 1. Split over pages. Pass 1 (flash_split_kernel) gives each block a
//    (split, row tile of 16 query rows, (row b, kv head)). The host picks
//    the number of splits from shapes alone (kernels/flash_paged.py
//    split_plan: MB, B x kv x row tiles and the SM count; never kv_len or
//    pos, which would cost a sync per layer). A block reads kv_len and pos
//    itself and walks only the tokens of its pages that any of its rows can
//    see: [max(split start, pos - window + 1), min(split end, kv_len,
//    pos + Sq)) under causal/window. It writes a partial (m, l, acc) per
//    query row into f32 scratch; a block with nothing to see writes
//    (NEG_INF, 0, 0). Pass 2 (flash_combine_kernel) merges the splits of a
//    row in a fixed order, o = sum_s e^(m_s - M) acc_s / max(sum_s
//    e^(m_s - M) l_s, 1e-30): no float atomics, so results do not depend on
//    the order blocks finish in, and an idle row still emits exact zeros.
// 2. Loads. A block first reads the block-table entries of its tokens into
//    shared memory, all in parallel (a page id per thread), so no copy
//    waits on a table lookup. It then walks its tokens in chunks of 32. Each
//    chunk's K parts, V and scales are copied raw (int8, bf16 or f32) into a
//    ring of three stages in shared memory (two where three do not fit) with
//    cp.async, 16 bytes a lane (where a head's token rows are whole 16-byte
//    pieces), neighbouring lanes on neighbouring bytes of a token row; two
//    chunks are in flight while one is consumed. Head widths whose rows are
//    not whole 16-byte pieces (smollm-360m_smoke's head_dim 20: 40-byte bf16
//    rows) take the narrow instantiation (WIDE = false): 4-byte cp.async
//    pieces where every row is whole 4-byte words, else one element a lane
//    copied in place; the query tile, the dot products, P.V (a column a
//    lane, up to 16 per lane) and the partials go element by element, in the
//    wide path's summation order, in tiles of RT rows (one instantiation a
//    dtype pair). The wide instantiation is as it was. A token's page is found
//    once per token row, never per element. Tokens past the block's range
//    are zero-filled. When V is the ckv pool (MLA), V is read from the K
//    part's copy.
// 3. Every warp busy, no branch per row. A block holds 2, 4, 8 or 16 query
//    rows (a template count: the kv head's rows rounded up, the extra rows a
//    zero query never stored), so the inner loops are straight-line code.
//    Warp w owns rows w, w+4, ... for the whole chunk (at a 2-row tile
//    warps 2 and 3 own none and only copy), and lane t owns token t.
//    Scores: each lane reads its token's K row 16 bytes at a time,
//    dequantizes it once in registers (int8 x scale, rounded as the
//    reference rounds it) and adds it into every owned row's dot product,
//    one FMA chain in d per (row, token), the order a plain GEMM sums in
//    (the serving path's step parity depends on it); the Q reads are warp
//    broadcasts. Softmax: per owned row across the lanes (max, exp and sum
//    by shuffles, never inside a branch), straight from the scores'
//    registers. P.V: the same warp keeps those rows' accumulators, 4
//    columns a lane (up to 4 groups of 128 columns), rescales them by its
//    own alphas and adds P[r, t..t+3] . V[t..t+3] for every token in order,
//    V dequantized in registers; P goes through shared memory with only a
//    warp barrier. One block barrier per chunk, after its copy lands. The
//    query tile comes in with 16-byte loads, four a thread in flight.
// Q.K^T stays in f32 on the CUDA cores: bf16 mma.sync would round
// q * qscale to 8 bits of mantissa (and f32 pools too), which the bf16
// output tolerance of 2^-7 relative does not leave room for.
//
// K parts: GQA passes one; MLA passes two ([ckv ; kr]), concatenated per
// token in that order (the reference's concat). The output (B, Sq, H, hdv)
// is written in q's dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_attrs.cuh"

namespace {

constexpr int NT = 128;              // threads per block of pass 1
constexpr int RT = 16;               // most query rows of one block (row tile)
constexpr int TC = 32;               // tokens per chunk: one per lane in the softmax
constexpr int PAD = 16;              // bytes of padding per token row of a raw tile
constexpr int MAX_SPLITS = 256;      // splits the combine pass takes
constexpr int MAX_HDV = 512;         // 4 groups of 128 columns a lane covers in P.V
constexpr size_t MAX_SMEM = 232448;  // dynamic shared memory a Hopper block may use
constexpr float NEG_INF = -1e30f;    // the reference's finite mask value

enum { F32 = 0, BF16 = 1, I8 = 2 };

template <typename O> __device__ __forceinline__ O from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// four consecutive pool elements from a raw shared tile, in f32; int8 ones
// times their token's scale (the reference's dequantize: one f32 product)
__device__ __forceinline__ float4 load4(const int8_t* p, float s) {
  const int w = *reinterpret_cast<const int*>(p);
  return make_float4(__fmul_rn((float)(int8_t)(w & 0xff), s),
                     __fmul_rn((float)(int8_t)((w >> 8) & 0xff), s),
                     __fmul_rn((float)(int8_t)((w >> 16) & 0xff), s),
                     __fmul_rn((float)(int8_t)(w >> 24), s));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, float) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
}
__device__ __forceinline__ float4 load4(const float* p, float) {
  return *reinterpret_cast<const float4*>(p);
}

// one pool element from a raw shared tile in f32 (int8 times its token's scale)
__device__ __forceinline__ float load1(const int8_t* p, float s) { return __fmul_rn((float)*p, s); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p, float) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load1(const float* p, float) { return *p; }

// a += p.x v[0] + p.y v[1] + p.z v[2] + p.w v[3], per component, in that order
__device__ __forceinline__ void pv4(float4& a, float4 p, const float4 (&v)[4]) {
  a.x = fmaf(p.w, v[3].x, fmaf(p.z, v[2].x, fmaf(p.y, v[1].x, fmaf(p.x, v[0].x, a.x))));
  a.y = fmaf(p.w, v[3].y, fmaf(p.z, v[2].y, fmaf(p.y, v[1].y, fmaf(p.x, v[0].y, a.y))));
  a.z = fmaf(p.w, v[3].z, fmaf(p.z, v[2].z, fmaf(p.y, v[1].z, fmaf(p.x, v[0].z, a.z))));
  a.w = fmaf(p.w, v[3].w, fmaf(p.z, v[2].w, fmaf(p.y, v[1].w, fmaf(p.x, v[0].w, a.w))));
}

// cp.async of `bytes` (16 or 4) from global to shared; a copy that is not
// valid zero-fills its destination and reads nothing
__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? bytes : 0;
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ bool visible(int kpos, int qpos, int L, int causal, int window) {
  return kpos < L && (!causal || kpos <= qpos) && (window <= 0 || qpos - kpos < window);
}

// n consecutive pool elements (n = 16 / sizeof(KVT) for a 16-byte read, or
// 4) from a raw shared tile into f32, int8 ones times their token's scale
template <typename KVT, int N>
__device__ __forceinline__ void load_n(const KVT* p, float s, float (&out)[N]) {
#pragma unroll
  for (int e = 0; e < N; e += 4) {
    const float4 f = load4(p + e, s);
    out[e] = f.x; out[e + 1] = f.y; out[e + 2] = f.z; out[e + 3] = f.w;
  }
}
// one 16-byte read: 16 int8 or 8 bf16 elements
template <>
__device__ __forceinline__ void load_n<int8_t, 16>(const int8_t* p, float s, float (&out)[16]) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const unsigned x[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int e = 0; e < 16; ++e)
    out[e] = __fmul_rn((float)(int8_t)((x[e / 4] >> (8 * (e % 4))) & 0xffu), s);
}
template <>
__device__ __forceinline__ void load_n<__nv_bfloat16, 8>(const __nv_bfloat16* p, float,
                                                         float (&out)[8]) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const unsigned x[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    out[2 * e] = __uint_as_float(x[e] << 16);
    out[2 * e + 1] = __uint_as_float(x[e] & 0xffff0000u);
  }
}

// acc[i] += Q[warp + 4i, 0:f] . k[0:f] for the warp's rows, as one FMA chain
// in d per row; k is the lane's token row of one K part (raw, in shared
// memory), q the part's first column of the Q tile (row stride hd)
template <typename KVT, int RPW>
__device__ __forceinline__ void score_part(float (&acc)[RPW], const unsigned char* k, int f,
                                           float scale, const float* q, int hd, int warp) {
  constexpr int NV = 16 / sizeof(KVT);   // elements of a 16-byte read
  const KVT* kr = reinterpret_cast<const KVT*>(k);
  for (int d = 0; d < f; d += NV) {
    float kv[NV];
    load_n<KVT, NV>(kr + d, scale, kv);
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const float* qr = q + (warp + 4 * i) * hd + d;
#pragma unroll
      for (int e = 0; e < NV; e += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(qr + e);
        acc[i] = fmaf(qv.w, kv[e + 3], fmaf(qv.z, kv[e + 2],
                 fmaf(qv.y, kv[e + 1], fmaf(qv.x, kv[e], acc[i]))));
      }
    }
  }
}

// score_part for rows that are not whole 16-byte pieces: one element at a
// time, the same FMA chain in d
template <typename KVT, int RPW>
__device__ __forceinline__ void score_part1(float (&acc)[RPW], const unsigned char* k, int f,
                                            float scale, const float* q, int hd, int warp) {
  const KVT* kr = reinterpret_cast<const KVT*>(k);
  for (int d = 0; d < f; ++d) {
    const float kv = load1(kr + d, scale);
#pragma unroll
    for (int i = 0; i < RPW; ++i) acc[i] = fmaf(q[(warp + 4 * i) * hd + d], kv, acc[i]);
  }
}

// Shared-memory plan of pass 1 (bytes), identical on host and device: the
// Q tile (rows x hd f32), a ring of nst chunk stages, the scores (then
// probabilities) of one chunk and the page ids of one split.
struct Layout {
  int ks0, ks1, vst;        // raw token-row strides of K part 0, part 1, V
  int q, stage, s, pg;      // offsets: Q tile, ring, scores/probs, page ids
  int k0, k1, v, sc;        // offsets inside one stage
  int total;
  __host__ __device__ Layout(int f0, int f1, int hdv, int es, int alias, int nst, int pps,
                             int rows) {
    ks0 = f0 * es + PAD;
    ks1 = f1 * es + PAD;
    vst = alias ? ks0 : hdv * es + PAD;
    k0 = 0;
    k1 = k0 + TC * ks0;
    v = k1 + TC * ks1;
    sc = v + (alias ? 0 : TC * vst);
    q = 0;
    stage = q + rows * (f0 + f1) * 4;
    s = stage + nst * stage_bytes();
    pg = s + rows * TC * 4;
    total = pg + pps * 4;
  }
  __host__ __device__ int stage_bytes() const { return sc + 3 * TC * 4; }
};

// ROWS: query rows per block (2, 4, 8 or 16), a compile-time count so that
// no inner loop branches per row; rows of the tile past the kv head's last
// one hold a zero query and are never stored. Warp w owns rows w + 4i; at
// ROWS = 2 warps 2 and 3 own none and only copy chunks. WIDE: every row is
// whole 16-byte pieces; else the narrow path, whose copies move `lb` bytes
// a piece (4, or one element).
template <typename QT, typename KVT, int ROWS, bool WIDE>
__global__ void __launch_bounds__(NT) flash_split_kernel(
    const QT* __restrict__ q, const KVT* k0, const float* ks0, const KVT* k1,
    const float* ks1, const KVT* v, const float* vs, const int* __restrict__ tables,
    const int* __restrict__ pos, const int* __restrict__ kv_len, float* __restrict__ pm,
    float* __restrict__ pl, float* __restrict__ pacc, int sq, int H, int kv, int f0, int f1,
    int hdv, int bs, int MB, int pages_per_split, float qscale, int causal, int window,
    int alias, int nst, int lb) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ES = sizeof(KVT);
  constexpr int RPW = ROWS >= 4 ? ROWS / 4 : 1;   // rows a warp owns (softmax, P.V)
  constexpr int BUSY = ROWS >= 4 ? 4 : ROWS;       // warps that own rows
  const Layout lay(f0, f1, hdv, ES, alias, nst, pages_per_split, ROWS);
  const int hd = f0 + f1;
  const int group = H / kv;
  const int rows_head = group * sq;
  const int split = blockIdx.x, S = gridDim.x;
  const int r0 = blockIdx.y * ROWS;
  const int R = min(ROWS, rows_head - r0);
  const int b = blockIdx.z / kv, g = blockIdx.z % kv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long row0 = (long)blockIdx.z * rows_head + r0;   // first partial row

  float* Qs = reinterpret_cast<float*>(smem + lay.q);
  float* Ss = reinterpret_cast<float*>(smem + lay.s);
  int* pg = reinterpret_cast<int*>(smem + lay.pg);

  const int L = kv_len[b];
  const int p0 = pos[b];
  // tokens any row of this tile can see, within this split's pages
  int k_lo = split * pages_per_split * bs;
  int k_hi = min((split + 1) * pages_per_split, MB) * bs;
  k_hi = min(k_hi, L);
  if (causal) k_hi = min(k_hi, p0 + sq);
  if (window > 0) k_lo = max(k_lo, p0 - window + 1);
  const int n_chunks = k_hi > k_lo ? (k_hi - k_lo + TC - 1) / TC : 0;
  if (n_chunks == 0) {   // no page to read: the (NEG_INF, 0, 0) partials
    for (int r = warp; r < R; r += NT / 32) {
      if (lane == 0) {
        pm[(row0 + r) * S + split] = NEG_INF;
        pl[(row0 + r) * S + split] = 0.f;
      }
      if constexpr (WIDE) {
        for (int c = lane * 4; c < hdv; c += 128)
          *reinterpret_cast<float4*>(pacc + ((row0 + r) * S + split) * hdv + c) =
              make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        for (int c = lane; c < hdv; c += 32) pacc[((row0 + r) * S + split) * hdv + c] = 0.f;
      }
    }
    return;
  }

  // the block-table entries of those tokens, read once, all in parallel
  const int m_lo = k_lo / bs;
  for (int i = tid; i < (k_hi + bs - 1) / bs - m_lo; i += NT)
    pg[i] = tables[(long)b * MB + m_lo + i];
  // the query tile, pre-scaled, in f32; rows past R are zeros. 16-byte
  // loads, four a thread in flight (narrow rows: an element a thread)
  if constexpr (!WIDE) {
    for (int e = tid; e < ROWS * hd; e += NT) {
      const int r = e / hd, d = e - r * hd;
      const int j = r0 + r, rep = j / sq, s = j - rep * sq;
      Qs[e] = r < R ? __fmul_rn(to_f32(q[(((long)b * sq + s) * H + g * group + rep) * hd + d]),
                                qscale)
                    : 0.f;
    }
  } else {
    constexpr int EPC = 16 / sizeof(QT);
    const int cpr = hd / EPC;   // 16-byte pieces of a query row
    for (int e0 = 0; e0 < ROWS * cpr; e0 += 4 * NT) {
      uint4 buf[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * NT + tid, r = e / cpr;
        const int j = r0 + r, rep = j / sq, s = j - rep * sq;
        const QT* qr = q + (((long)b * sq + s) * H + g * group + rep) * hd;
        buf[u] = r < R ? *reinterpret_cast<const uint4*>(qr + (e - r * cpr) * EPC)
                       : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * NT + tid, r = e / cpr;
        if (r < ROWS) {
          const QT* x = reinterpret_cast<const QT*>(&buf[u]);
          float* dst = Qs + r * hd + (e - r * cpr) * EPC;
#pragma unroll
          for (int k = 0; k < EPC; ++k) dst[k] = __fmul_rn(to_f32(x[k]), qscale);
        }
      }
    }
  }
  __syncthreads();  // page ids visible

  // copy chunk c of this block's tokens into ring stage st. Each lane finds
  // the pool row of one token of the chunk; warp w copies tokens 8w..8w+7,
  // its lanes taking consecutive 16-byte pieces of those 8 rows (a shuffle
  // hands each lane its token's row), so one copy instruction moves up to
  // 512 bytes. Every lane runs every shuffle; only the copies are guarded.
  auto load_chunk = [&](int c, int st, bool live) {
    unsigned char* base = smem + lay.stage + st * lay.stage_bytes();
    const int kc0 = k_lo + c * TC;
    const int kl = kc0 + lane;
    const int ml = kl / bs;
    const int row_l = kl < k_hi ? pg[ml - m_lo] * bs + (kl - ml * bs) : 0;
    auto rows8 = [&](unsigned char* dst, int stride, const KVT* pool, int width) {
      const int pb = WIDE ? 16 : lb;     // bytes a piece
      const int cpr = width * ES / pb;   // pieces per token row
      for (int e0 = 0; e0 < 8 * cpr; e0 += 32) {
        const int e = e0 + lane;
        const int k = e < 8 * cpr ? e / cpr : 0;
        const int i = warp * 8 + k;
        const long row = __shfl_sync(0xffffffffu, row_l, i);
        if (live && e < 8 * cpr) {
          const int o = (e - k * cpr) * pb;
          const char* src =
              reinterpret_cast<const char*>(pool + row * kv * width + (long)g * width) + o;
          const bool ok = kc0 + i < k_hi;
          if (WIDE || pb == 4) {
            cp_async(dst + i * stride + o, src, pb, ok);
          } else {   // one element in place (zero past the block's tokens)
            KVT* d = reinterpret_cast<KVT*>(dst + i * stride + o);
            *d = ok ? *reinterpret_cast<const KVT*>(src) : KVT(0.f);
          }
        }
      }
    };
    rows8(base + lay.k0, lay.ks0, k0, f0);
    if (f1 > 0) rows8(base + lay.k1, lay.ks1, k1, f1);
    if (!alias) rows8(base + lay.v, lay.vst, v, hdv);
    if (ks0 != nullptr) {   // lanes 0-7, 8-15, 16-23: the scales of K0, K1, V
      const int part = lane >> 3, i = warp * 8 + (lane & 7);
      const long row = __shfl_sync(0xffffffffu, row_l, i);
      const float* src = part == 0 ? ks0 : part == 1 ? ks1 : vs;
      const bool want = part == 0 || (part == 1 && f1 > 0) || (part == 2 && !alias);
      if (live && want)
        cp_async(reinterpret_cast<float*>(base + lay.sc) + part * TC + i, src + row, 4,
                 kc0 + i < k_hi);
    }
  };

  // softmax state of the warp's rows (warp + 4i), held by every lane
  float row_m[RPW], row_l[RPW];
  int row_q[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    row_m[i] = NEG_INF;
    row_l[i] = 0.f;
    row_q[i] = p0 + (r0 + warp + 4 * i) % sq;
  }
  // P.V: the warp's rows x columns 4 (lane + 32j), j < ncg (narrow rows:
  // columns lane + 32j, j < ncol, in acc1)
  const int ncg = (hdv + 127) / 128;
  const int ncol = (hdv + 31) / 32;
  float4 acc[RPW][4];
  float acc1[RPW][16];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < 16; ++j) acc1[i][j] = 0.f;
  }


  // nst - 1 chunks in flight ahead of the one consumed; a commit without
  // copies keeps the group count uniform past the last chunk
  for (int c = 0; c < nst - 1; ++c) {
    load_chunk(c, c, c < n_chunks);
    cp_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    const int st = c % nst;
    if (nst == 3) cp_wait<1>();
    else cp_wait<0>();
    __syncthreads();  // chunk c visible; every thread is done with chunk c - 1
    {
      const int nxt = c + nst - 1;
      load_chunk(nxt, nxt % nst, nxt < n_chunks);
      cp_commit();
    }
    if (warp >= BUSY) continue;   // a warp that owns no row only copies
    const unsigned char* base = smem + lay.stage + st * lay.stage_bytes();
    const float* sc = reinterpret_cast<const float*>(base + lay.sc);
    const int kc0 = k_lo + c * TC;

    // scores: lane t holds token t's dot product with each of the warp's
    // rows, summed over d in order (one FMA chain, as a plain GEMM sums), the
    // K row read 16 bytes at a time and dequantized once for all the rows
    float sacc[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) sacc[i] = 0.f;
    {
      const float s0 = ks0 != nullptr ? sc[lane] : 1.f;
      const float s1 = ks0 != nullptr && f1 > 0 ? sc[TC + lane] : 1.f;
      if constexpr (WIDE) {
        score_part<KVT, RPW>(sacc, base + lay.k0 + lane * lay.ks0, f0, s0, Qs, hd, warp);
        if (f1 > 0)
          score_part<KVT, RPW>(sacc, base + lay.k1 + lane * lay.ks1, f1, s1, Qs + f0, hd, warp);
      } else {
        score_part1<KVT, RPW>(sacc, base + lay.k0 + lane * lay.ks0, f0, s0, Qs, hd, warp);
        if (f1 > 0)
          score_part1<KVT, RPW>(sacc, base + lay.k1 + lane * lay.ks1, f1, s1, Qs + f0, hd, warp);
      }
    }

    // online softmax: the warp's rows, one lane per token
    float alpha[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int kpos = kc0 + lane;
      const bool vis = kpos >= k_lo && kpos < k_hi && visible(kpos, row_q[i], L, causal, window);
      const float s = sacc[i];
      const float mx = fmaxf(row_m[i], warp_max(vis ? s : NEG_INF));
      const float p = vis ? expf(s - mx) : 0.f;
      const float sum = warp_sum(p);
      alpha[i] = expf(row_m[i] - mx);
      row_l[i] = fmaf(row_l[i], alpha[i], sum);
      row_m[i] = mx;
      Ss[(warp + 4 * i) * TC + lane] = p;
    }
    __syncwarp();   // the warp's probabilities, read back below

    // P.V: rescale the warp's rows, then add this chunk's tokens four at a time
    {
      const KVT* V = reinterpret_cast<const KVT*>(base + (alias ? lay.k0 : lay.v));
      const float* vsc = sc + (alias ? 0 : 2 * TC);
      const int vstride = (alias ? lay.ks0 : lay.vst) / ES;
      if constexpr (!WIDE) {   // a column a lane, every token in order
#pragma unroll
        for (int i = 0; i < RPW; ++i)
#pragma unroll
          for (int j = 0; j < 16; ++j) acc1[i][j] *= alpha[i];
        for (int t = 0; t < TC; ++t) {
          float p[RPW];
#pragma unroll
          for (int i = 0; i < RPW; ++i) p[i] = Ss[(warp + 4 * i) * TC + t];
          const float vsu = ks0 != nullptr ? vsc[t] : 1.f;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int c = lane + 32 * j;
            if (j < ncol && c < hdv) {
              const float vv = load1(V + t * vstride + c, vsu);
#pragma unroll
              for (int i = 0; i < RPW; ++i) acc1[i][j] = fmaf(p[i], vv, acc1[i][j]);
            }
          }
        }
        continue;
      }
#pragma unroll
      for (int i = 0; i < RPW; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j].x *= alpha[i]; acc[i][j].y *= alpha[i];
          acc[i][j].z *= alpha[i]; acc[i][j].w *= alpha[i];
        }
      for (int t = 0; t < TC; t += 4) {
        float4 p[RPW];
#pragma unroll
        for (int i = 0; i < RPW; ++i)
          p[i] = *reinterpret_cast<const float4*>(Ss + (warp + 4 * i) * TC + t);
        float vsu[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) vsu[u] = ks0 != nullptr ? vsc[t + u] : 1.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c4 = lane + 32 * j;
          if (j < ncg && c4 * 4 < hdv) {
            float4 vv[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) vv[u] = load4(V + (t + u) * vstride + c4 * 4, vsu[u]);
#pragma unroll
            for (int i = 0; i < RPW; ++i) pv4(acc[i][j], p[i], vv);
          }
        }
      }
    }
  }

  // the partials of this split, by the warp that owns each row
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp + 4 * i;
    if (r < R) {
      if (lane == 0) {
        pm[(row0 + r) * S + split] = row_m[i];
        pl[(row0 + r) * S + split] = row_l[i];
      }
      if constexpr (WIDE) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c4 = lane + 32 * j;
          if (j < ncg && c4 * 4 < hdv)
            *reinterpret_cast<float4*>(pacc + ((row0 + r) * S + split) * hdv + c4 * 4) =
                acc[i][j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int c = lane + 32 * j;
          if (j < ncol && c < hdv) pacc[((row0 + r) * S + split) * hdv + c] = acc1[i][j];
        }
      }
    }
  }
}

// Pass 2: one block per query row merges its splits in split order; a
// thread owns 4 output columns (VEC; else one, for hdv not a multiple of 4)
// and keeps 8 splits' loads in flight.
template <typename QT, bool VEC>
__global__ void __launch_bounds__(NT) flash_combine_kernel(
    const float* __restrict__ pm, const float* __restrict__ pl, const float* __restrict__ pacc,
    QT* __restrict__ out, int sq, int H, int kv, int hdv, int S) {
  __shared__ float w[MAX_SPLITS];
  __shared__ float l_tot;
  const int group = H / kv, rows_head = group * sq;
  const long row = blockIdx.x;
  const int j = (int)(row % rows_head);
  const int bg = (int)(row / rows_head);
  const int b = bg / kv, g = bg % kv;
  const int rep = j / sq, s = j % sq;
  const int tid = threadIdx.x;
  // every warp reduces the (m, l) of the row (no branch around the
  // shuffles); warp 0 keeps the weights
  const int lane = tid & 31;
  float mx = NEG_INF;
  for (int i = lane; i < S; i += 32) mx = fmaxf(mx, pm[row * S + i]);
  mx = warp_max(mx);
  float l = 0.f;
  for (int i = lane; i < S; i += 32) {
    const float e = expf(pm[row * S + i] - mx);
    if (tid < 32) w[i] = e;
    l = fmaf(e, pl[row * S + i], l);
  }
  l = warp_sum(l);
  if (tid == 0) l_tot = fmaxf(l, 1e-30f);
  __syncthreads();
  QT* o = out + (((long)b * sq + s) * H + g * group + rep) * hdv;
  if constexpr (!VEC) {
    for (int c = tid; c < hdv; c += NT) {
      float a = 0.f;
#pragma unroll 8
      for (int i = 0; i < S; ++i) a = fmaf(w[i], pacc[(row * S + i) * hdv + c], a);
      o[c] = from_f32<QT>(__fdiv_rn(a, l_tot));
    }
    return;
  }
  const float4* acc = reinterpret_cast<const float4*>(pacc + row * S * hdv);
  const int c4n = hdv / 4;
  for (int c = tid; c < c4n; c += NT) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int i = 0; i < S; ++i) {
      const float4 x = acc[(long)i * c4n + c];
      a.x = fmaf(w[i], x.x, a.x);
      a.y = fmaf(w[i], x.y, a.y);
      a.z = fmaf(w[i], x.z, a.z);
      a.w = fmaf(w[i], x.w, a.w);
    }
    o[4 * c] = from_f32<QT>(__fdiv_rn(a.x, l_tot));
    o[4 * c + 1] = from_f32<QT>(__fdiv_rn(a.y, l_tot));
    o[4 * c + 2] = from_f32<QT>(__fdiv_rn(a.z, l_tot));
    o[4 * c + 3] = from_f32<QT>(__fdiv_rn(a.w, l_tot));
  }
}

// Ring stages of pass 1: three where they fit one block, else two (0 if
// not even two fit).
int stages(int f0, int f1, int hdv, int es, int alias, int pps, int rows) {
  for (int nst = 3; nst >= 2; --nst)
    if ((size_t)Layout(f0, f1, hdv, es, alias, nst, pps, rows).total <= MAX_SMEM) return nst;
  return 0;
}

template <typename QT, typename KVT, int ROWS, bool WIDE>
int launch_rows(const void* q, const void* k0, const float* ks0, int f0, const void* k1,
                const float* ks1, int f1, const void* v, const float* vs, int hdv,
                const int* tables, const int* pos, const int* kv_len, void* out, float* pm,
                float* pl, float* pacc, int B, int sq, int H, int kv, int bs, int MB,
                int splits, int pages_per_split, float qscale, int causal, int window,
                int alias, int lb, cudaStream_t stream) {
  const int es = (int)sizeof(KVT);
  const int nst = stages(f0, f1, hdv, es, alias, pages_per_split, ROWS);
  const size_t smem =
      (size_t)Layout(f0, f1, hdv, es, alias, nst, pages_per_split, ROWS).total;
  auto kern = flash_split_kernel<QT, KVT, ROWS, WIDE>;
  if (smem > 48 * 1024) {   // set again only on a new device or a larger size
    static launch_attrs::Cache attrs;   // per instantiation, per device
    const cudaError_t err = launch_attrs::allow(attrs, kern, (int)smem, false);
    if (err != cudaSuccess) return (int)err;
  }
  const int rows_head = (H / kv) * sq;
  const dim3 grid(splits, (rows_head + ROWS - 1) / ROWS, B * kv);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k0), ks0, static_cast<const KVT*>(k1),
      ks1, static_cast<const KVT*>(v), vs, tables, pos, kv_len, pm, pl, pacc, sq, H, kv, f0, f1,
      hdv, bs, MB, pages_per_split, qscale, causal, window, alias, nst, lb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((long)B * kv * rows_head);
  if (hdv % 4 == 0)
    flash_combine_kernel<QT, true><<<blocks, NT, 0, stream>>>(
        pm, pl, pacc, static_cast<QT*>(out), sq, H, kv, hdv, splits);
  else
    flash_combine_kernel<QT, false><<<blocks, NT, 0, stream>>>(
        pm, pl, pacc, static_cast<QT*>(out), sq, H, kv, hdv, splits);
  return 0;
}

// rows of the tile: the kv head's query rows rounded up to 2, 4, 8 or 16
int tile_rows(int rows_head) {
  int r = 2;
  while (r < rows_head && r < RT) r <<= 1;
  return r;
}

template <typename QT, typename KVT>
int launch(const void* q, const void* k0, const float* ks0, int f0, const void* k1,
           const float* ks1, int f1, const void* v, const float* vs, int hdv, const int* tables,
           const int* pos, const int* kv_len, void* out, float* pm, float* pl, float* pacc, int B,
           int sq, int H, int kv, int bs, int MB, int splits, int pages_per_split, float qscale,
           int causal, int window, int alias, int lb, cudaStream_t stream) {
#define FLASH_ROWS(N, W)                                                                        \
  launch_rows<QT, KVT, N, W>(q, k0, ks0, f0, k1, ks1, f1, v, vs, hdv, tables, pos, kv_len, out, \
                             pm, pl, pacc, B, sq, H, kv, bs, MB, splits, pages_per_split,       \
                             qscale, causal, window, alias, lb, stream)
  if (lb != 16) return FLASH_ROWS(RT, false);   // narrow rows: one tile height
  switch (tile_rows((H / kv) * sq)) {
    case 2: return FLASH_ROWS(2, true);
    case 4: return FLASH_ROWS(4, true);
    case 8: return FLASH_ROWS(8, true);
    default: return FLASH_ROWS(16, true);
  }
#undef FLASH_ROWS
}

template <typename QT>
int dispatch_kv(int kv_dtype, const void* q, const void* k0, const float* ks0, int f0,
                const void* k1, const float* ks1, int f1, const void* v, const float* vs,
                int hdv, const int* tables, const int* pos, const int* kv_len, void* out,
                float* pm, float* pl, float* pacc, int B, int sq, int H, int kv, int bs, int MB,
                int splits, int pps, float qscale, int causal, int window, int alias, int lb,
                cudaStream_t s) {
  if (kv_dtype == I8)
    return launch<QT, int8_t>(q, k0, ks0, f0, k1, ks1, f1, v, vs, hdv, tables, pos, kv_len, out,
                              pm, pl, pacc, B, sq, H, kv, bs, MB, splits, pps, qscale, causal,
                              window, alias, lb, s);
  if (kv_dtype == F32)
    return launch<QT, float>(q, k0, ks0, f0, k1, ks1, f1, v, vs, hdv, tables, pos, kv_len, out,
                             pm, pl, pacc, B, sq, H, kv, bs, MB, splits, pps, qscale, causal,
                             window, alias, lb, s);
  if (kv_dtype == BF16)
    return launch<QT, __nv_bfloat16>(q, k0, ks0, f0, k1, ks1, f1, v, vs, hdv, tables, pos,
                                     kv_len, out, pm, pl, pacc, B, sq, H, kv, bs, MB, splits,
                                     pps, qscale, causal, window, alias, lb, s);
  return -1;
}

}  // namespace

// pm, pl (B*kv*rows_head, splits) and pacc (B*kv*rows_head, splits, hdv) are
// f32 scratch. alias: V is K part 0 (same pool, same scales, hdv == f0).
// Returns 0 on success, -1 for an unsupported dtype, -2 for head widths or a
// plan the kernel does not take, else a cudaError_t. Rows that are whole
// 16-byte pieces (and 16-byte aligned operands) take the wide path; any other
// width up to MAX_HDV the narrow one, with 4-byte copies where every row is
// whole 4-byte words, else one element a lane.
extern "C" int flash_paged_launch(
    const void* q, int q_dtype, const void* k0, const float* ks0, int f0, const void* k1,
    const float* ks1, int f1, const void* v, const float* vs, int hdv, int kv_dtype,
    const int* tables, const int* pos, const int* kv_len, void* out, float* pm, float* pl,
    float* pacc, int B, int sq, int H, int kv, int bs, int MB, int splits, int pages_per_split,
    float qscale, int causal, int window, int alias, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int es = kv_dtype == I8 ? 1 : kv_dtype == BF16 ? 2 : kv_dtype == F32 ? 4 : 0;
  if (es == 0) return -1;
  const int qes = q_dtype == F32 ? 4 : 2;
  const uintptr_t ptrs = (uintptr_t)q | (uintptr_t)k0 | (uintptr_t)k1 | (uintptr_t)v;
  // the bytes a copy moves: 16 where every token row of a head, and every
  // query row, is whole 16-byte pieces; else 4 where the pool rows are whole
  // 4-byte words; else one element (the narrow path, tiles of RT rows)
  auto whole = [&](int n) {
    return (f0 * es) % n == 0 && (f1 * es) % n == 0 && (hdv * es) % n == 0 && ptrs % n == 0;
  };
  const int lb = whole(16) && ((f0 + f1) * qes) % 16 == 0 ? 16 : whole(4) ? 4 : es;
  const int rows = lb == 16 ? tile_rows((H / kv) * sq) : RT;
  if (f0 <= 0 || hdv <= 0 || hdv > MAX_HDV || (alias && hdv != f0) || splits < 1 ||
      splits > MAX_SPLITS || pages_per_split < 1 ||
      stages(f0, f1, hdv, es, alias, pages_per_split, rows) == 0)
    return -2;
  int rc;
  if (q_dtype == F32)
    rc = dispatch_kv<float>(kv_dtype, q, k0, ks0, f0, k1, ks1, f1, v, vs, hdv, tables, pos,
                            kv_len, out, pm, pl, pacc, B, sq, H, kv, bs, MB, splits,
                            pages_per_split, qscale, causal, window, alias, lb, s);
  else if (q_dtype == BF16)
    rc = dispatch_kv<__nv_bfloat16>(kv_dtype, q, k0, ks0, f0, k1, ks1, f1, v, vs, hdv, tables,
                                    pos, kv_len, out, pm, pl, pacc, B, sq, H, kv, bs, MB, splits,
                                    pages_per_split, qscale, causal, window, alias, lb, s);
  else
    rc = -1;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
