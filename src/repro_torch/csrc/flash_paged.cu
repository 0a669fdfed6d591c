// Paged flash-decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_paged.py::flash_paged_decode.
// Attention for a step of Sq query positions per row, read straight from the
// paged KV pool through per-row block tables: int8 K/V pages are dequantized
// with their per-(page, token) scales as they are loaded, scores and an online
// softmax run in f32, and no gathered copy of the pool is ever written.
//
// Masks (the reference's, l.129-136): key k of row b is visible to query row r
// iff k < kv_len[b], and (causal) k <= pos[b] + r % Sq, and (window > 0)
// pos[b] + r % Sq - k < window. Masked probabilities are set to exactly 0
// after the exp, so a fully masked (idle) row emits exact zeros. The flush
// divides by max(l, 1e-30). q is pre-scaled by qscale = 1/sqrt(hd_tot).
//
// What bounds it on the card: decode reads every live page of K and V once
// per (row, kv head) and does only ~2 flops per loaded element per query row,
// so it is bound by device-memory bytes. Design: one block per
// (b, kv head, row tile). The block walks its row's block table itself (the
// TPU's scalar-prefetched page index map), loads each live page's K and V for
// its kv head into shared memory (dequantized to f32), and keeps the running
// max / sum in shared memory and the weighted accumulator in registers. Pages
// past ceil(kv_len / bs) are skipped: they are fully masked. The query rows
// of one kv head (group x Sq of them) are tiled so that the accumulator fits
// in registers and a tile's Q plus one K and V page fit in shared memory;
// this is what lets MLA (one kv head, 16 heads x Sq rows, K width 576) run:
// each row tile keeps its own online softmax, exact per row.
//
// K parts: GQA passes one; MLA passes two ([ckv ; kr]), concatenated per page
// in that order (the reference's concat). The output (B, Sq, H, hdv) is
// written in q's dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FT = 256;              // threads per block
constexpr int MAXACC = 64;           // accumulator registers per thread
constexpr size_t MAX_SMEM = 232448;  // dynamic shared memory a Hopper block may use
constexpr float NEG_INF = -1e30f;    // the reference's finite mask value

enum { F32 = 0, BF16 = 1, I8 = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }

template <typename O> __device__ __forceinline__ O from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// one pool element (page, token t, feature column col) in f32; int8 pools
// carry a per-(page, token) scale
template <typename KVT>
__device__ __forceinline__ float load_deq(const KVT* pool, const float* scale,
                                          long page, int bs, int t, int width, int col) {
  const float v = to_f32(pool[(page * bs + t) * width + col]);
  return scale != nullptr ? __fmul_rn(v, scale[page * bs + t]) : v;
}

__device__ __forceinline__ bool visible(int kpos, int qpos, int L, int causal, int window) {
  return kpos < L && (!causal || kpos <= qpos) && (window <= 0 || qpos - kpos < window);
}

template <typename QT, typename KVT>
__global__ void __launch_bounds__(FT) flash_paged_kernel(
    const QT* __restrict__ q, const KVT* __restrict__ k0, const float* __restrict__ ks0,
    const KVT* __restrict__ k1, const float* __restrict__ ks1,
    const KVT* __restrict__ v, const float* __restrict__ vs,
    const int* __restrict__ tables, const int* __restrict__ pos,
    const int* __restrict__ kv_len, QT* __restrict__ out,
    int sq, int H, int kv, int f0, int f1, int hdv, int bs, int MB,
    int rows_tile, float qscale, int causal, int window) {
  extern __shared__ float smem[];
  const int hd = f0 + f1;             // hd_tot
  const int kst = hd + 1;             // padded K row stride (bank spread)
  const int group = H / kv;
  const int rows_head = group * sq;   // query rows of one kv head: (rep, s)
  const int b = blockIdx.x, g = blockIdx.y;
  const int r0 = blockIdx.z * rows_tile;
  const int R = min(rows_tile, rows_head - r0);
  const int tid = threadIdx.x;

  float* Qs = smem;                       // [R][hd]
  float* Ks = Qs + rows_tile * hd;        // [bs][kst]
  float* Vs = Ks + bs * kst;              // [bs][hdv]
  float* Ps = Vs + bs * hdv;              // [R][bs]  scores, then probs
  float* row_m = Ps + rows_tile * bs;     // running max
  float* row_l = row_m + rows_tile;       // running sum
  float* row_a = row_l + rows_tile;       // this page's rescale factor

  const int L = kv_len[b];
  const int p0 = pos[b];

  for (int e = tid; e < R * hd; e += FT) {
    const int r = e / hd, d = e % hd;
    const int j = r0 + r, rep = j / sq, s = j % sq;
    const int h = g * group + rep;
    Qs[r * hd + d] = __fmul_rn(to_f32(q[(((long)b * sq + s) * H + h) * hd + d]), qscale);
  }
  for (int r = tid; r < R; r += FT) {
    row_m[r] = NEG_INF;
    row_l[r] = 0.f;
  }
  float acc[MAXACC];
#pragma unroll
  for (int i = 0; i < MAXACC; ++i) acc[i] = 0.f;

  const int n_pages = min(MB, (L + bs - 1) / bs);
  for (int m = 0; m < n_pages; ++m) {
    const long page = tables[(long)b * MB + m];
    __syncthreads();  // previous page fully consumed (and Qs/row state ready)

    for (int e = tid; e < bs * hd; e += FT) {
      const int t = e / hd, d = e % hd;
      float val = 0.f;
      if (m * bs + t < L) {
        val = d < f0 ? load_deq(k0, ks0, page, bs, t, kv * f0, g * f0 + d)
                     : load_deq(k1, ks1, page, bs, t, kv * f1, g * f1 + (d - f0));
      }
      Ks[t * kst + d] = val;
    }
    for (int e = tid; e < bs * hdv; e += FT) {
      const int t = e / hdv, d = e % hdv;
      Vs[t * hdv + d] = m * bs + t < L ? load_deq(v, vs, page, bs, t, kv * hdv, g * hdv + d) : 0.f;
    }
    __syncthreads();

    for (int e = tid; e < R * bs; e += FT) {
      const int r = e / bs, t = e % bs;
      const float* qr = Qs + r * hd;
      const float* kt = Ks + t * kst;
      float dot = 0.f;
      for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kt[d], dot);
      Ps[r * bs + t] = dot;
    }
    __syncthreads();

    for (int r = tid; r < R; r += FT) {
      const int qpos = p0 + (r0 + r) % sq;
      const float m_old = row_m[r];
      float mx = m_old;
      for (int t = 0; t < bs; ++t)
        if (visible(m * bs + t, qpos, L, causal, window)) mx = fmaxf(mx, Ps[r * bs + t]);
      float sum = 0.f;
      for (int t = 0; t < bs; ++t) {
        const float p = visible(m * bs + t, qpos, L, causal, window)
                            ? expf(Ps[r * bs + t] - mx) : 0.f;
        Ps[r * bs + t] = p;
        sum += p;
      }
      const float alpha = expf(m_old - mx);
      row_a[r] = alpha;
      row_l[r] = fmaf(row_l[r], alpha, sum);
      row_m[r] = mx;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < MAXACC; ++i) {
      const int e = tid + i * FT;
      if (e < R * hdv) {
        const int r = e / hdv, d = e % hdv;
        float pv = 0.f;
        for (int t = 0; t < bs; ++t) pv = fmaf(Ps[r * bs + t], Vs[t * hdv + d], pv);
        acc[i] = fmaf(acc[i], row_a[r], pv);
      }
    }
  }
  __syncthreads();  // row_l final (also covers n_pages == 0)

#pragma unroll
  for (int i = 0; i < MAXACC; ++i) {
    const int e = tid + i * FT;
    if (e < R * hdv) {
      const int r = e / hdv, d = e % hdv;
      const int j = r0 + r, rep = j / sq, s = j % sq;
      const int h = g * group + rep;
      const float o = __fdiv_rn(acc[i], fmaxf(row_l[r], 1e-30f));
      out[(((long)b * sq + s) * H + h) * hdv + d] = from_f32<QT>(o);
    }
  }
}

size_t smem_bytes(int rows_tile, int hd, int hdv, int bs) {
  return sizeof(float) *
         ((size_t)rows_tile * hd + (size_t)bs * (hd + 1) + (size_t)bs * hdv +
          (size_t)rows_tile * bs + 3 * (size_t)rows_tile);
}

template <typename QT, typename KVT>
int launch(const void* q, const void* k0, const float* ks0, int f0,
           const void* k1, const float* ks1, int f1, const void* v,
           const float* vs, int hdv, const int* tables, const int* pos,
           const int* kv_len, void* out, int B, int sq, int H, int kv, int bs,
           int MB, int rows_tile, float qscale, int causal, int window,
           cudaStream_t stream) {
  const int rows_head = (H / kv) * sq;
  const size_t smem = smem_bytes(rows_tile, f0 + f1, hdv, bs);
  auto kern = flash_paged_kernel<QT, KVT>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(B, kv, (rows_head + rows_tile - 1) / rows_tile);
  kern<<<grid, FT, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k0), ks0,
      static_cast<const KVT*>(k1), ks1, static_cast<const KVT*>(v), vs,
      tables, pos, kv_len, static_cast<QT*>(out), sq, H, kv, f0, f1, hdv, bs,
      MB, rows_tile, qscale, causal, window);
  return 0;
}

template <typename QT>
int dispatch_kv(int kv_dtype, const void* q, const void* k0, const float* ks0, int f0,
                const void* k1, const float* ks1, int f1, const void* v,
                const float* vs, int hdv, const int* tables, const int* pos,
                const int* kv_len, void* out, int B, int sq, int H, int kv, int bs,
                int MB, int rows_tile, float qscale, int causal, int window,
                cudaStream_t s) {
  if (kv_dtype == I8)
    return launch<QT, int8_t>(q, k0, ks0, f0, k1, ks1, f1, v, vs, hdv, tables, pos, kv_len, out,
                              B, sq, H, kv, bs, MB, rows_tile, qscale, causal, window, s);
  if (kv_dtype == F32)
    return launch<QT, float>(q, k0, ks0, f0, k1, ks1, f1, v, vs, hdv, tables, pos, kv_len, out,
                             B, sq, H, kv, bs, MB, rows_tile, qscale, causal, window, s);
  if (kv_dtype == BF16)
    return launch<QT, __nv_bfloat16>(q, k0, ks0, f0, k1, ks1, f1, v, vs, hdv, tables, pos, kv_len,
                                     out, B, sq, H, kv, bs, MB, rows_tile, qscale, causal, window, s);
  return -1;
}

}  // namespace

// Returns 0 on success, -1 for an unsupported dtype, -2 for a row tile
// whose accumulator or shared memory does not fit one block, else a
// cudaError_t.
extern "C" int flash_paged_launch(
    const void* q, int q_dtype, const void* k0, const float* ks0, int f0,
    const void* k1, const float* ks1, int f1, const void* v, const float* vs,
    int hdv, int kv_dtype, const int* tables, const int* pos, const int* kv_len,
    void* out, int B, int sq, int H, int kv, int bs, int MB, int rows_tile,
    float qscale, int causal, int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows_tile < 1 || (long)rows_tile * hdv > (long)MAXACC * FT ||
      smem_bytes(rows_tile, f0 + f1, hdv, bs) > MAX_SMEM)
    return -2;
  int rc;
  if (q_dtype == F32)
    rc = dispatch_kv<float>(kv_dtype, q, k0, ks0, f0, k1, ks1, f1, v, vs, hdv, tables, pos, kv_len,
                            out, B, sq, H, kv, bs, MB, rows_tile, qscale, causal, window, s);
  else if (q_dtype == BF16)
    rc = dispatch_kv<__nv_bfloat16>(kv_dtype, q, k0, ks0, f0, k1, ks1, f1, v, vs, hdv, tables, pos,
                                    kv_len, out, B, sq, H, kv, bs, MB, rows_tile, qscale, causal,
                                    window, s);
  else
    rc = -1;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
