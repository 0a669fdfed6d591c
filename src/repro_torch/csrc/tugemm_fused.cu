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
// With E > 1 the same launch computes E independent GEMMs of one shape, one
// per MoE expert, Y[e] = clip(round(X[e] / sx[e])) @ Wq[e] * (sx[e] * sw[e, n]),
// each with its own stats: the expert is folded into grid z (see the mainloop).
//
// What bounds it on this card: on the serving path M is small (max_batch x
// step width, 4..64 rows), so the work is reading W once: 0.5-6 MiB per call,
// 0.2-2 us at 3.35 TB/s, against ~0.02-0.3 us of int8 tensor-core work. To
// reach that bound the whole of W must be in flight at once, over every SM.
// The first port (32x32 tiles, one block per tile walking all of K with one
// load stage, scalar loads, __dp4a, serial stats loops) read W twice at M=64,
// packed W `planes` times, and ran at ~1% of the byte bound.
//
// Design (the mainloop lives in tugemm_mainloop.cuh, shared with
// tugemm_int8.cu):
// 1. All rows of a call in one block tile (BM = 64, M tiles over grid z), so
//    W is read and quantized once per call at the serving shapes; bn = 32, 64
//    or 128 columns a block.
// 2. K split across the blocks of a thread block cluster: the S blocks of a
//    cluster take S slices of K for one output tile, each writes its int32
//    partial tile to its own shared memory, and after a cluster barrier each
//    rank sums 1/S of the tile over all S partials through distributed shared
//    memory (cluster.map_shared_rank) and applies the epilogue. No atomics on
//    y, no workspace, one launch. The plan (bn, S, K slice) is a host
//    function of the shapes (kernels/tugemm_fused.py::split_plan, which
//    says how it was chosen for one plane and for packed W).
// 3. A block's whole K slice goes in flight at once: 16-byte cp.async copies
//    of 64-row chunks (adjacent threads, adjacent bytes; 16-byte pieces past
//    a ragged edge are zero-filled) into a ring that holds every chunk of the
//    slice where it fits (96 KiB), one commit group a chunk.
//    Each landed chunk is quantized (X by its row scale, W by its column
//    scale), copied (int8 W) or plane-decoded (packed W: each byte read once,
//    every plane decoded from it by a carry-free byte-wise sign extension) in
//    registers into int8 operand tiles, W transposed K-contiguous by 4x4
//    prmt byte transposes.
// 4. The product on s8 tensor cores, mma.sync.m16n8k32 (hopper_common.cuh):
//    256 threads a block; each of the 8 warps owns bn/4 columns and a pair
//    of m16 fragments, skipping those without rows (M = 4 multiplies in 4
//    warps). All 8 warps quantize: the IEEE divides are latency-bound, so
//    threads, not tensor cores, set the pace (512-thread blocks measured
//    slower on the quantizing modes, PERF.md). wgmma is not used: at
//    M <= 64 the bound is bytes, and mma.sync keeps the quantizer's
//    register tiles and the small-M fragments simple.
// 5. Stats from registers: each thread keeps byte-wise maxima of the codes it
//    wrote, lanes combine them by shuffles, warps through a few shared words,
//    and each block issues one atomicMax per (plane, k) of its slice: ca only
//    from the blocks of the first N tile, rb only from those of the first M
//    tile. ca and rb are one buffer that the launcher zeroes first (one
//    cudaMemsetAsync, the call's only other device operation);
//    unary_stats.cu's tugemm_stats launch assembles TuGemmStats from them.
//
// Exactness: the plain PyTorch version (kernels/ref.py::fused_gemm_ref) and
// this kernel agree bit for bit. Quantization is IEEE x / s (__fdiv_rn),
// rounded half to even (rintf), then clamped; the epilogue is
// float(acc) * (sx * sw[n]) with __fmul_rn so nothing contracts into an FMA,
// then the cast to the output type, then the bias added in the output type.
// Integer partial sums are exact in any order. Build without --use_fast_math.

#include "tugemm_mainloop.cuh"

namespace {

using namespace tugemm;

enum { F32 = 0, BF16 = 1, I8 = 2 };

template <typename XT, typename OT>
int dispatch_w(int w_mode, int w_dtype, const Params& p, int splits, cudaStream_t s) {
  if (w_mode == W_QUANT && w_dtype == F32) return launch<XT, W_QUANT, float, OT>(p, splits, s);
  if (w_mode == W_QUANT && w_dtype == BF16)
    return launch<XT, W_QUANT, __nv_bfloat16, OT>(p, splits, s);
  if (w_mode == W_INT8 && w_dtype == I8) return launch<XT, W_INT8, int8_t, OT>(p, splits, s);
  if (w_mode == W_PACKED && w_dtype == I8) return launch<XT, W_PACKED, int8_t, OT>(p, splits, s);
  return -1;
}

}  // namespace

// stats (collect) is one int32 buffer, ca (E, planes, Kw) then rb (E, Kw,
// planes), zeroed here (one cudaMemsetAsync on the stream) before the kernel merges
// its maxima into it. Returns 0 on success, -1 for an unsupported dtype
// combination, -2 for a plan outside the kernel's range, else the
// cudaError_t of the launch. The plan (bn, splits, chunks) comes from
// kernels/tugemm_fused.py::split_plan.
extern "C" int tugemm_fused_launch(
    const void* x, int x_dtype, const void* w, int w_mode, int w_dtype,
    const float* sx, int per_token, const float* sw, const void* bias,
    void* y, int out_dtype, int* stats, int E, int M, int N, int Kw,
    int planes, int bits, int collect, int bn, int splits, int chunks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params p = {};
  p.x = x; p.w = w; p.sx = sx; p.sw = sw; p.bias = bias; p.c = nullptr; p.y = y;
  p.E = E; p.M = M; p.N = N; p.Kw = Kw; p.planes = planes; p.bits = bits; p.Kx = planes * Kw;
  p.per_token = per_token; p.collect = collect; p.bn = bn; p.chunks = chunks;
  if (collect) {
    p.ca = stats;
    p.rb = stats + (long)E * planes * Kw;
    const cudaError_t e =
        cudaMemsetAsync(stats, 0, 2 * (size_t)E * planes * Kw * sizeof(int), s);
    if (e != cudaSuccess) return (int)e;
  }
  if (x_dtype == F32 && out_dtype == F32)
    return dispatch_w<float, float>(w_mode, w_dtype, p, splits, s);
  if (x_dtype == F32 && out_dtype == BF16)
    return dispatch_w<float, __nv_bfloat16>(w_mode, w_dtype, p, splits, s);
  if (x_dtype == BF16 && out_dtype == F32)
    return dispatch_w<__nv_bfloat16, float>(w_mode, w_dtype, p, splits, s);
  if (x_dtype == BF16 && out_dtype == BF16)
    return dispatch_w<__nv_bfloat16, __nv_bfloat16>(w_mode, w_dtype, p, splits, s);
  return -1;
}
