// Symmetric w-bit quantization for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/quantize.py::quantize_sym_pallas
// (body _kernel). One launch computes, for x (M, N) f32 or bf16 and a scale
// of one value or one per column,
//
//     q[m, n] = clamp(rint(x[m, n] * inv[n]), -2^(w-1), 2^(w-1) - 1)  as int8
//
// with the product rounded once in f32 (__fmul_rn, never contracted) and
// rint's round-half-to-even, as the plain version (kernels/ref.py::
// quantize_sym_ref) and the reference compute it. The scale arrives as
// given: a tensor of one value or N, whose reciprocal the kernel takes
// rounded once (__fdiv_rn(1, s), IEEE, the same value as PyTorch's
// 1.0 / scale), or, for a number, inv itself, taken on the host and passed
// as an argument. NaN inputs are outside the contract, as in the reference.
//
// What bounds it on the card: bytes, one read of x and of the scale as
// given (one value or N) and one write of q; a multiply, two clamps and an
// add an element. Design (kernels/quantize.py::quantize_plan picks the grid):
// - column-stationary lanes: a thread owns 16 columns of a row (a lane) and
//   walks rows with a stride, so each row costs it two (bf16) or four (f32)
//   16-byte loads of x and one 16-byte store of codes; its 16 inverse scales
//   are read once, into registers. A per-column scale is staged once a block
//   in shared memory (coalesced, each reciprocal taken once), a per-tensor
//   one once a thread, both while the first loads are in flight;
// - U rows in flight: the loads of U rows (1, 2 or 4) are issued before any
//   arithmetic, with streaming hints (x is read once, q written once); the
//   grid is fitted to the card so that every thread takes one batch, in one
//   wave: blocks of at most 128 threads, 128 registers a thread, 4 blocks
//   an SM. The codes round by an add of 1.5 * 2^23, full-rate float work;
// - ragged rows: when N is not a multiple of 16, row m's lanes start at the
//   first column whose code lands 16-byte aligned, c0 = -m*N mod 16 (a mask,
//   no remainder); one more lane a row, the edge lane, takes the head before
//   c0 and the tail after the last full lane (under 16 elements each), with
//   its loads issued together;
// - an x that is not 16-byte aligned keeps the lanes and their 16-byte
//   stores, and loads its 16 values one element at a time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANE = 16;         // columns a lane owns: one 16-byte store of codes
constexpr int MAX_THREADS = 128; // threads a block, at most
constexpr int MIN_BLOCKS = 4;    // blocks of 128 an SM holds at once: 128 registers a thread
constexpr int STAGE = 17;        // staged columns a thread, at most: (16 tx + 16) / (tx ty)

struct Args {
  const void* x;
  int8_t* q;
  const float* s;   // the scale: 1 or N values; null: s_host
  float s_host;     // inv, taken on the host, where s is null
  int M, N, L;      // L = N / 16, the full lanes a row of an aligned N
  int s_cols;       // s holds N values (one per column), else one
  float lo, hi;     // the w-bit range
};

// 32-bit words of x in a lane's 16 values: 8 of bf16, 16 of f32
template <typename T>
constexpr int kWords = 4 * (int)sizeof(T);

// one value of x as f32 (bf16 bits widen exactly)
__device__ __forceinline__ float load1(const float* p) { return __ldcs(p); }
__device__ __forceinline__ float load1(const unsigned short* p) {
  return __uint_as_float((unsigned)__ldcs(p) << 16);
}

// value j of a lane's words
template <typename T>
__device__ __forceinline__ float value(const uint32_t* w, int j) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(w[j]);
  } else {
    return __uint_as_float((j & 1) ? (w[j >> 1] & 0xffff0000u) : (w[j >> 1] << 16));
  }
}

// the lane's 16 values of x at p: 16-byte loads, or one element at a time
// where x is not 16-byte aligned
template <typename T, bool NARROW>
__device__ __forceinline__ void load_lane(uint32_t* w, const T* p) {
  if constexpr (!NARROW) {
    const uint4* v = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < kWords<T> / 4; ++i) {
      const uint4 a = __ldcs(v + i);
      w[4 * i] = a.x;
      w[4 * i + 1] = a.y;
      w[4 * i + 2] = a.z;
      w[4 * i + 3] = a.w;
    }
  } else if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < LANE; ++i) w[i] = __float_as_uint(__ldcs(p + i));
  } else {
#pragma unroll
    for (int i = 0; i < LANE / 2; ++i)
      w[i] = (uint32_t)__ldcs(p + 2 * i) | ((uint32_t)__ldcs(p + 2 * i + 1) << 16);
  }
}

// The code of x·inv as the low byte of the result: clamped to [lo, hi]
// first (the same as clamping the rounded value: lo and hi are integers),
// then rounded half to even by adding 1.5·2^23, whose float has a unit in
// the last place of 1, so the rounded value sits in the low bits. Full-rate
// float operations only (a float-to-int conversion runs at quarter rate).
__device__ __forceinline__ uint32_t code(float x, float inv, float lo, float hi) {
  const float v = fminf(fmaxf(__fmul_rn(x, inv), lo), hi);
  return __float_as_uint(__fadd_rn(v, 12582912.0f));
}

// four codes (their low bytes) packed into a word, the first lowest
__device__ __forceinline__ uint32_t pack4(uint32_t c0, uint32_t c1, uint32_t c2, uint32_t c3) {
  return __byte_perm(__byte_perm(c0, c1, 0x0040), __byte_perm(c2, c3, 0x0040), 0x5410);
}

// the scale as given at column c (raw: the scale, or the host's inv), and
// inv from it
__device__ __forceinline__ float raw_at(const Args& a, long c) {
  return a.s == nullptr ? a.s_host : __ldg(a.s + (a.s_cols ? c : 0));
}
__device__ __forceinline__ float to_inv(const Args& a, float v) {
  return a.s != nullptr ? __fdiv_rn(1.0f, v) : v;
}

// inv of the 16 columns from sinv[i] (a per-column scale, staged in shared
// memory), or the per-tensor inv t
__device__ __forceinline__ void lane_inv(float (&inv)[LANE], const Args& a, const float* sinv,
                                         int i, float t) {
#pragma unroll
  for (int j = 0; j < LANE; ++j) inv[j] = a.s_cols ? sinv[i + j] : t;
}

// first column of row r whose code lands 16-byte aligned: -r*N mod 16
__device__ __forceinline__ int row_c0(int r, int N) {
  return (LANE - (int)(((unsigned)r * (unsigned)N) & (LANE - 1))) & (LANE - 1);
}

// full lanes of a row that starts its lanes at c0
__device__ __forceinline__ int row_lanes(int N, int c0) { return N >= c0 ? (N - c0) / LANE : 0; }

// inv of column c for the edge lane: a per-tensor inv is the thread's t; a
// per-column one comes from the block's staged inv where the block spans
// the row (one block across, the staging holds all N), else from the raw
// scale the lane loaded
__device__ __forceinline__ float edge_inv(const Args& a, const float* sinv, bool staged,
                                          float t, float raw, int c) {
  return !a.s_cols ? t : staged ? sinv[c] : to_inv(a, raw);
}

// the edge lane of ragged rows: columns [0, c0) and those after the row's
// last full lane, each under 16; every load of x, and of a per-column scale
// the block has not staged, is issued (at a clamped column) before any code
// is formed
template <typename T>
__device__ void edge_lane(const Args& a, int r0, int rs, const float* sinv, float t) {
  const T* x = static_cast<const T*>(a.x);
  const bool staged = gridDim.x == 1;
  const bool raw = a.s_cols && !staged;
  for (int r = r0; r < a.M; r += rs) {
    const int c0 = row_c0(r, a.N);
    const int head = min(c0, a.N);
    const int tail = c0 + LANE * row_lanes(a.N, c0);
    const T* row = x + (long)r * a.N;
    float hv[LANE], tv[LANE], hs[LANE], ts[LANE];
#pragma unroll
    for (int j = 0; j < LANE; ++j) {
      const int h = j < head ? j : 0, c = min(tail + j, a.N - 1);
      hv[j] = load1(row + h);
      tv[j] = load1(row + c);
      hs[j] = raw ? raw_at(a, h) : 0.0f;
      ts[j] = raw ? raw_at(a, c) : 0.0f;
    }
    int8_t* q = a.q + (long)r * a.N;
#pragma unroll
    for (int j = 0; j < LANE; ++j) {
      if (j < head)
        q[j] = (int8_t)(code(hv[j], edge_inv(a, sinv, staged, t, hs[j], j), a.lo, a.hi) & 0xffu);
      if (tail + j < a.N)
        q[tail + j] = (int8_t)(
            code(tv[j], edge_inv(a, sinv, staged, t, ts[j], tail + j), a.lo, a.hi) & 0xffu);
    }
  }
}

// one batch of a lane: the x of U rows r + u rs, and which of them it holds
// (rows past M, and ragged rows with fewer full lanes, hold none)
template <typename T, int U>
struct Batch {
  uint32_t w[U][kWords<T>];
  unsigned held;
};

// element offset of lane l's first value in row r
template <bool RAGGED>
__device__ __forceinline__ long lane_at(const Args& a, int l, int r) {
  return (long)r * a.N + (RAGGED ? row_c0(r, a.N) : 0) + LANE * l;
}

template <typename T, bool NARROW, bool RAGGED, int U>
__device__ __forceinline__ void load_batch(Batch<T, U>& b, const Args& a, int l, int r, int rs) {
  const T* x = static_cast<const T*>(a.x);
  b.held = 0;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int ru = r + u * rs;
    if (ru < a.M && (!RAGGED || l < row_lanes(a.N, row_c0(ru, a.N)))) {
      b.held |= 1u << u;
      load_lane<T, NARROW>(b.w[u], x + lane_at<RAGGED>(a, l, ru));
    }
  }
}

template <typename T, bool RAGGED, int U>
__device__ __forceinline__ void store_batch(const Batch<T, U>& b, const Args& a, int l, int r,
                                            int rs, float (&inv)[LANE], const float* sinv,
                                            float t) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (!(b.held >> u & 1)) continue;
    const long e = lane_at<RAGGED>(a, l, r + u * rs);
    if (RAGGED) lane_inv(inv, a, sinv, row_c0(r + u * rs, a.N) + LANE * threadIdx.x, t);
    uint32_t o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[i] = pack4(code(value<T>(b.w[u], 4 * i), inv[4 * i], a.lo, a.hi),
                   code(value<T>(b.w[u], 4 * i + 1), inv[4 * i + 1], a.lo, a.hi),
                   code(value<T>(b.w[u], 4 * i + 2), inv[4 * i + 2], a.lo, a.hi),
                   code(value<T>(b.w[u], 4 * i + 3), inv[4 * i + 3], a.lo, a.hi));
    }
    __stcs(reinterpret_cast<uint4*>(a.q + e), make_uint4(o[0], o[1], o[2], o[3]));
  }
}

// Lane l of rows r0, r0 + rs, r0 + 2 rs, ... (rs = gridDim.y * blockDim.y),
// U rows a batch. Ragged rows: lane L is the edge lane, lanes past a row's
// full lanes skip it. While the first batch's loads are in flight, a
// per-tensor inv is taken once a thread, and a per-column scale is staged
// once a block: the block's 16 * blockDim.x + 16 columns from cb, each inv
// taken once, every load issued before any is stored.
template <typename T, bool NARROW, bool RAGGED, int U>
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS) quantize_lanes(const Args a) {
  extern __shared__ float sinv[];
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  const int r0 = blockIdx.y * blockDim.y + threadIdx.y;
  const int rs = gridDim.y * blockDim.y;
  const bool lane = l < a.L && r0 < a.M;
  Batch<T, U> b;
  if (lane) load_batch<T, NARROW, RAGGED, U>(b, a, l, r0, rs);
  const float t = a.s_cols ? 0.0f : to_inv(a, raw_at(a, 0));
  if (a.s_cols) {
    const long cb = (long)blockIdx.x * blockDim.x * LANE;
    const int n = (int)min((long)blockDim.x * LANE + LANE, (long)a.N - cb);
    const int tid = threadIdx.y * blockDim.x + threadIdx.x, nt = blockDim.x * blockDim.y;
    float v[STAGE];
#pragma unroll
    for (int k = 0; k < STAGE; ++k)
      if (tid + k * nt < n) v[k] = raw_at(a, cb + tid + k * nt);
#pragma unroll
    for (int k = 0; k < STAGE; ++k)
      if (tid + k * nt < n) sinv[tid + k * nt] = to_inv(a, v[k]);
    __syncthreads();
  }
  if (RAGGED && l == a.L && r0 < a.M) {
    edge_lane<T>(a, r0, rs, sinv, t);
    return;
  }
  if (!lane) return;
  float inv[LANE];
  if (!RAGGED) lane_inv(inv, a, sinv, LANE * threadIdx.x, t);
  for (int r = r0;;) {
    store_batch<T, RAGGED, U>(b, a, l, r, rs, inv, sinv, t);
    r += U * rs;
    if (r >= a.M) break;
    load_batch<T, NARROW, RAGGED, U>(b, a, l, r, rs);
  }
}

template <typename T, bool NARROW, bool RAGGED>
int launch_rows(const Args& a, dim3 grid, dim3 block, int u, cudaStream_t s) {
  // the staged per-column inv: 16 columns a lane and 16 more for ragged rows
  const size_t smem = a.s_cols ? (block.x * LANE + LANE) * sizeof(float) : 0;
  switch (u) {
    case 1: quantize_lanes<T, NARROW, RAGGED, 1><<<grid, block, smem, s>>>(a); break;
    case 2: quantize_lanes<T, NARROW, RAGGED, 2><<<grid, block, smem, s>>>(a); break;
    case 4: quantize_lanes<T, NARROW, RAGGED, 4><<<grid, block, smem, s>>>(a); break;
    default: return -2;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_lanes(const Args& a, int narrow, dim3 grid, dim3 block, int u, cudaStream_t s) {
  const bool ragged = (a.N & (LANE - 1)) != 0;
  if (narrow) return ragged ? launch_rows<T, true, true>(a, grid, block, u, s)
                            : launch_rows<T, true, false>(a, grid, block, u, s);
  return ragged ? launch_rows<T, false, true>(a, grid, block, u, s)
                : launch_rows<T, false, false>(a, grid, block, u, s);
}

}  // namespace

// x (M, N) contiguous, dtype 0 = f32, 1 = bf16 (kernels/_launch.py
// DTYPE_CODE); q (M, N) int8, 16-byte aligned. s: the scale, N values
// (s_cols = 1) or one; s null: s_host is inv. narrow: x is not 16-byte
// aligned. The plan (gx, gy, tx, ty, u) is
// kernels/quantize.py::quantize_plan's. Returns 0 on success, -1 for an
// unsupported dtype, -2 for a plan the kernel does not take, else the
// cudaError_t of the launch (cudaGetLastError right after it).
extern "C" int quantize_sym_launch(const void* x, const void* s, float s_host, void* q, int M,
                                   int N, int bits, int dtype, int narrow, int s_cols, int gx,
                                   int gy, int tx, int ty, int u, void* stream) {
  const int lanes = N / LANE + ((N & (LANE - 1)) != 0);
  if (tx < 1 || ty < 1 || tx * ty > MAX_THREADS || gy < 1 || gy > 65535 ||
      (long)gx * tx < lanes || min(LANE * tx + LANE, N) > STAGE * tx * ty)
    return -2;
  Args a{x, static_cast<int8_t*>(q), static_cast<const float*>(s), s_host, M, N, N / LANE,
         s_cols, -(float)(1 << (bits - 1)), (float)((1 << (bits - 1)) - 1)};
  const dim3 grid(gx, gy), block(tx, ty);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_lanes<float>(a, narrow, grid, block, u, st);
  if (dtype == 1) return launch_lanes<unsigned short>(a, narrow, grid, block, u, st);
  return -1;
}
