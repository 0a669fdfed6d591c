// Fused dynamic-quant tuGEMM linear layer for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/tugemm_fused.py::tugemm_fused_pallas.
// One launch computes
//
//     Y = clip(round(X / sx)) @ Wq * (sx * sw[n]) + bias[n]
//
// with Wq quantized on load from float W ("quant"), read as stored int8
// ("int8"), or unpacked from int4/int2 planes by shifts ("packed"), plus the
// tuGEMM cycle-model statistics ca[p, k] = max_m |Xq| and rb[k, p] = max_n |Wq|.
//
// What bounds it on the card: on the serving path M is small (max_batch x
// step width, 4..64 rows) and W is a float (K, N) matrix, so the kernel is
// bound by reading W once (bytes), far below the int8 tensor-core rate.
// Design: a grid of (N/BN, M/BM) output tiles with the K loop inside the
// block (the TPU's sequential K grid axis); X and W tiles are quantized on
// load into shared memory as int8 (every load of a step is issued before any
// is used), and products accumulate exactly in int32 registers with __dp4a.
// Neither the int8 carriers nor the int32 (M, N) intermediate ever reach
// device memory. The stats are column maxima of the int8 tiles, merged with
// atomicMax into int32 buffers the caller zeroes (exact: max does not depend
// on order); only the first column of blocks writes ca and only the first
// row writes rb. Ragged M/N/K edges are masked here, so the caller pads
// nothing.
//
// Exactness: the plain PyTorch version (kernels/ref.py::fused_gemm_ref) and
// this kernel agree bit for bit. Quantization is IEEE x / s (__fdiv_rn),
// rounded half to even (rintf); the epilogue is float(acc) * (sx * sw[n])
// with __fmul_rn so nothing contracts into an FMA, then the cast to the
// output type, then the bias added in the output type. Build without
// --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;       // output rows per block
constexpr int BN = 32;       // output columns per block
constexpr int BK = 64;       // K (packed rows in "packed" mode) per step
constexpr int NT = 128;      // threads per block: 8 x 16, each 2 rows x 4 cols
constexpr int XS = BK + 4;   // padded row stride in bytes of the int8 tiles
constexpr int TPT = BM * BK / NT;   // tile elements each thread loads (X and W alike)
static_assert(BM * BK == BK * BN, "X and W tiles have the same element count");

enum { F32 = 0, BF16 = 1, I8 = 2 };
enum { W_QUANT = 0, W_INT8 = 1, W_PACKED = 2 };

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

__device__ __forceinline__ int quant(float v, float s, int lo, int hi) {
  float q = rintf(__fdiv_rn(v, s));
  q = fminf(fmaxf(q, (float)lo), (float)hi);
  return (int)q;
}

template <typename XT, int WMODE, typename WT, typename OT>
__global__ void __launch_bounds__(NT) tugemm_fused_kernel(
    const XT* __restrict__ x, const WT* __restrict__ w,
    const float* __restrict__ sx, const float* __restrict__ sw,
    const OT* __restrict__ bias, OT* __restrict__ y,
    int* __restrict__ ca, int* __restrict__ rb,
    int M, int N, int Kw, int planes, int bits, int per_token, int collect) {
  __shared__ __align__(16) int8_t xs[BM * XS];   // [m][k]
  __shared__ __align__(16) int8_t ws[BN * XS];   // [n][k] (transposed)

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int lo = -(1 << (bits - 1));
  const int hi = (1 << (bits - 1)) - 1;
  const bool do_ca = collect && blockIdx.x == 0;
  const bool do_rb = collect && blockIdx.y == 0;
  const long Kx = (long)planes * Kw;
  const int tx = tid % 8;    // columns tx*4 .. tx*4+3
  const int ty = tid / 8;    // rows ty*2 .. ty*2+1
  const float sx0 = per_token ? 0.f : sx[0];

  int acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < Kw; k0 += BK) {
    for (int p = 0; p < planes; ++p) {
      // issue every global load of this step before quantizing any of them
      float xv[TPT];
      WT wv[TPT];
#pragma unroll
      for (int i = 0; i < TPT; ++i) {
        const int e = tid + i * NT;
        const int m = m0 + e / BK, k = k0 + e % BK;
        xv[i] = (m < M && k < Kw) ? to_f32(x[(long)m * Kx + (long)p * Kw + k]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < TPT; ++i) {
        const int e = tid + i * NT;
        const int k = k0 + e / BN, n = n0 + e % BN;
        wv[i] = (k < Kw && n < N) ? w[(long)k * N + n] : zero_of<WT>();
      }
      __syncthreads();  // tiles of the previous step are consumed

#pragma unroll
      for (int i = 0; i < TPT; ++i) {
        const int e = tid + i * NT;
        const int r = e / BK, c = e % BK;
        const float s = per_token ? (m0 + r < M ? sx[m0 + r] : 1.f) : sx0;
        xs[r * XS + c] = (int8_t)quant(xv[i], s, lo, hi);   // padding: 0 / s = 0
      }
#pragma unroll
      for (int i = 0; i < TPT; ++i) {
        const int e = tid + i * NT;
        const int r = e / BN, c = e % BN;   // r: k, c: n
        int q = 0;
        if constexpr (WMODE == W_QUANT) {
          if (n0 + c < N) q = quant(to_f32(wv[i]), sw[n0 + c], lo, hi);
        } else if constexpr (WMODE == W_INT8) {
          q = (int)wv[i];
        } else {
          // plane p sits in bits [p*bits, (p+1)*bits): shift it to the top
          // of the byte, then arithmetic-shift down to sign-extend
          const int up = 8 - (p + 1) * bits;
          q = (int)(int8_t)(uint8_t)((uint8_t)wv[i] << up) >> (8 - bits);
        }
        ws[c * XS + r] = (int8_t)q;
      }
      __syncthreads();

      // stats: column maxima of this tile, read back from shared memory
      if (tid < BK && k0 + tid < Kw) {
        const int k = k0 + tid;
        if (do_ca) {
          int mx = 0;
          for (int r = 0; r < BM; ++r) mx = max(mx, abs((int)xs[r * XS + tid]));
          if (mx) atomicMax(&ca[(long)p * Kw + k], mx);
        }
        if (do_rb) {
          int mx = 0;
          for (int c = 0; c < BN; ++c) mx = max(mx, abs((int)ws[c * XS + tid]));
          if (mx) atomicMax(&rb[(long)k * planes + p], mx);
        }
      }

#pragma unroll 4
      for (int kk = 0; kk < BK; kk += 4) {
        int a[2], b[4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          a[i] = *reinterpret_cast<const int*>(&xs[(ty * 2 + i) * XS + kk]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          b[j] = *reinterpret_cast<const int*>(&ws[(tx * 4 + j) * XS + kk]);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + ty * 2 + i;
    if (m >= M) continue;
    const float s_m = per_token ? sx[m] : sx0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= N) continue;
      const float v = __fmul_rn(__int2float_rn(acc[i][j]), __fmul_rn(s_m, sw[n]));
      OT o = from_f32<OT>(v);
      if (bias != nullptr) o = add_out(o, bias[n]);
      y[(long)m * N + n] = o;
    }
  }
}

template <typename XT, int WMODE, typename WT, typename OT>
void launch(const void* x, const void* w, const float* sx, const float* sw,
            const void* bias, void* y, int* ca, int* rb, int M, int N, int Kw,
            int planes, int bits, int per_token, int collect, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  tugemm_fused_kernel<XT, WMODE, WT, OT><<<grid, NT, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<const WT*>(w), sx, sw,
      static_cast<const OT*>(bias), static_cast<OT*>(y), ca, rb, M, N, Kw,
      planes, bits, per_token, collect);
}

template <typename XT, typename OT>
int dispatch_w(int w_mode, int w_dtype, const void* x, const void* w,
               const float* sx, const float* sw, const void* bias, void* y,
               int* ca, int* rb, int M, int N, int Kw, int planes, int bits,
               int per_token, int collect, cudaStream_t s) {
  if (w_mode == W_QUANT && w_dtype == F32)
    launch<XT, W_QUANT, float, OT>(x, w, sx, sw, bias, y, ca, rb, M, N, Kw, planes, bits, per_token, collect, s);
  else if (w_mode == W_QUANT && w_dtype == BF16)
    launch<XT, W_QUANT, __nv_bfloat16, OT>(x, w, sx, sw, bias, y, ca, rb, M, N, Kw, planes, bits, per_token, collect, s);
  else if (w_mode == W_INT8 && w_dtype == I8)
    launch<XT, W_INT8, int8_t, OT>(x, w, sx, sw, bias, y, ca, rb, M, N, Kw, planes, bits, per_token, collect, s);
  else if (w_mode == W_PACKED && w_dtype == I8)
    launch<XT, W_PACKED, int8_t, OT>(x, w, sx, sw, bias, y, ca, rb, M, N, Kw, planes, bits, per_token, collect, s);
  else
    return -1;
  return 0;
}

}  // namespace

// Returns 0 on success, -1 for an unsupported dtype combination, else the
// cudaError_t of the launch (cudaGetLastError right after it).
extern "C" int tugemm_fused_launch(
    const void* x, int x_dtype, const void* w, int w_mode, int w_dtype,
    const float* sx, int per_token, const float* sw, const void* bias,
    void* y, int out_dtype, int* ca, int* rb, int M, int N, int Kw,
    int planes, int bits, int collect, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (x_dtype == F32 && out_dtype == F32)
    rc = dispatch_w<float, float>(w_mode, w_dtype, x, w, sx, sw, bias, y, ca, rb, M, N, Kw, planes, bits, per_token, collect, s);
  else if (x_dtype == F32 && out_dtype == BF16)
    rc = dispatch_w<float, __nv_bfloat16>(w_mode, w_dtype, x, w, sx, sw, bias, y, ca, rb, M, N, Kw, planes, bits, per_token, collect, s);
  else if (x_dtype == BF16 && out_dtype == F32)
    rc = dispatch_w<__nv_bfloat16, float>(w_mode, w_dtype, x, w, sx, sw, bias, y, ca, rb, M, N, Kw, planes, bits, per_token, collect, s);
  else if (x_dtype == BF16 && out_dtype == BF16)
    rc = dispatch_w<__nv_bfloat16, __nv_bfloat16>(w_mode, w_dtype, x, w, sx, sw, bias, y, ca, rb, M, N, Kw, planes, bits, per_token, collect, s);
  else
    rc = -1;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
