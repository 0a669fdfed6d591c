// Symmetric w-bit quantization for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/quantize.py::quantize_sym_pallas
// (body _kernel). One launch computes, for x (M, N) f32 or bf16 and a
// per-column reciprocal scale inv (N,) f32,
//
//     q[m, n] = clamp(rint(x[m, n] * inv[n]), -2^(w-1), 2^(w-1) - 1)  as int8
//
// with the product rounded once in f32 (__fmul_rn, never contracted) and
// rint's round-half-to-even, as the plain version (kernels/ref.py::
// quantize_sym_ref) and the reference compute it. A per-tensor scale reaches
// the kernel broadcast to N columns (kernels/ops.py). NaN inputs are outside
// the contract, as they are in the reference.
//
// What bounds it on the card: one read of x and one write of q (bytes); it
// does one multiply per element. Design: an elementwise grid-stride pass in
// which each thread loads 16 bytes of x at a time (4 f32 or 8 bf16 values of
// one row) when N is a multiple of the vector and x is 16-byte aligned, reads
// inv per column (it stays in L1/L2), and stores its 4 or 8 codes in one
// word; otherwise it walks single elements. Ragged shapes need no padding:
// the pass is flat over M*N elements, each of which knows its column.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;   // threads per block

__device__ __forceinline__ float load_f(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float load_f(const uint16_t* p, long i) {
  return __uint_as_float(((unsigned)p[i]) << 16);   // bf16 -> f32, exact
}
__device__ __forceinline__ float bf16_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ unsigned code(float x, float inv, float lo, float hi) {
  const float q = fminf(fmaxf(rintf(__fmul_rn(x, inv)), lo), hi);
  return (unsigned)(uint8_t)(int8_t)(int)q;
}

// One element at a time: any N, any alignment.
template <typename T>
__global__ void __launch_bounds__(NT) quantize_sym_scalar(
    const T* __restrict__ x, const float* __restrict__ inv, int8_t* __restrict__ q,
    long total, int N, float lo, float hi) {
  for (long i = (long)blockIdx.x * NT + threadIdx.x; i < total; i += (long)gridDim.x * NT)
    q[i] = (int8_t)code(load_f(x, i), inv[i % N], lo, hi);
}

// 16 bytes of f32 (4 values) per step; N % 4 == 0 and x 16-byte aligned.
__global__ void __launch_bounds__(NT) quantize_sym_vec_f32(
    const float4* __restrict__ x, const float* __restrict__ inv, uint32_t* __restrict__ q,
    long nvec, int N, float lo, float hi) {
  for (long v = (long)blockIdx.x * NT + threadIdx.x; v < nvec; v += (long)gridDim.x * NT) {
    const float4 a = x[v];
    const int n = (int)((v * 4) % N);
    q[v] = code(a.x, inv[n], lo, hi) | (code(a.y, inv[n + 1], lo, hi) << 8) |
           (code(a.z, inv[n + 2], lo, hi) << 16) | (code(a.w, inv[n + 3], lo, hi) << 24);
  }
}

// 16 bytes of bf16 (8 values) per step; N % 8 == 0 and x 16-byte aligned.
__global__ void __launch_bounds__(NT) quantize_sym_vec_bf16(
    const uint4* __restrict__ x, const float* __restrict__ inv, uint2* __restrict__ q,
    long nvec, int N, float lo, float hi) {
  for (long v = (long)blockIdx.x * NT + threadIdx.x; v < nvec; v += (long)gridDim.x * NT) {
    const uint4 a = x[v];
    const int n = (int)((v * 8) % N);
    uint2 o;
    o.x = code(bf16_lo(a.x), inv[n], lo, hi) | (code(bf16_hi(a.x), inv[n + 1], lo, hi) << 8) |
          (code(bf16_lo(a.y), inv[n + 2], lo, hi) << 16) |
          (code(bf16_hi(a.y), inv[n + 3], lo, hi) << 24);
    o.y = code(bf16_lo(a.z), inv[n + 4], lo, hi) | (code(bf16_hi(a.z), inv[n + 5], lo, hi) << 8) |
          (code(bf16_lo(a.w), inv[n + 6], lo, hi) << 16) |
          (code(bf16_hi(a.w), inv[n + 7], lo, hi) << 24);
    q[v] = o;
  }
}

int blocks_for(long work) {
  const long b = (work + NT - 1) / NT;
  return (int)(b < 132 * 16 ? (b > 0 ? b : 1) : 132 * 16);   // grid-stride past 16 per SM
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (kernels/_launch.py DTYPE_CODE). vec16: the caller
// guarantees N is a multiple of the 16-byte vector (4 f32 / 8 bf16) and x is
// 16-byte aligned. Returns 0 on success, -1 for an unsupported dtype, else the
// cudaError_t of the launch (cudaGetLastError right after it).
extern "C" int quantize_sym_launch(const void* x, const void* inv, void* q, int M, int N,
                                   int bits, int dtype, int vec16, void* stream) {
  const float lo = -(float)(1 << (bits - 1)), hi = (float)((1 << (bits - 1)) - 1);
  const long total = (long)M * N;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* iv = static_cast<const float*>(inv);
  if (dtype == 0 && vec16) {
    quantize_sym_vec_f32<<<blocks_for(total / 4), NT, 0, s>>>(
        static_cast<const float4*>(x), iv, static_cast<uint32_t*>(q), total / 4, N, lo, hi);
  } else if (dtype == 1 && vec16) {
    quantize_sym_vec_bf16<<<blocks_for(total / 8), NT, 0, s>>>(
        static_cast<const uint4*>(x), iv, static_cast<uint2*>(q), total / 8, N, lo, hi);
  } else if (dtype == 0) {
    quantize_sym_scalar<float><<<blocks_for(total), NT, 0, s>>>(
        static_cast<const float*>(x), iv, static_cast<int8_t*>(q), total, N, lo, hi);
  } else if (dtype == 1) {
    quantize_sym_scalar<uint16_t><<<blocks_for(total), NT, 0, s>>>(
        static_cast<const uint16_t*>(x), iv, static_cast<int8_t*>(q), total, N, lo, hi);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}
