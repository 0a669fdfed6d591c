// Exact int8 x plane-packed int4/int2 GEMM for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/tugemm_packed.py::matmul_packed_pallas.
// One launch computes
//
//     Y[m, n] = sum_p sum_k A[m, p*Kp + k] * plane_p(PB)[k, n]      (int32)
//
// with PB (Kp, N) int8 holding 8/bits values per byte in plane layout
// (kernels/packing.py): plane p of packed row k sits in bits
// [p*bits, (p+1)*bits) and is logical row k + p*Kp of B. A (M, K) has
// K <= planes*Kp logical columns; columns at or past K read as zeros, the
// TPU wrapper's zero extension of A done by masking instead of a copy.
//
// What bounds it on this card: on the unfused serving path M is small
// (max_batch x step width, 4..64 rows), so the work is reading the packed
// weight once (0.375-1 MiB at the MLP's shapes, 0.1-0.3 us at 3.35 TB/s; 2-4x
// fewer bytes than int8, which is the point of the format) and A once, far
// below the int8 tensor-core rate. The first port (32x32 tiles, one block
// walking all of Kp, byte loads then two barriers a step, __dp4a) read the
// weight twice at M = 64 and gave mlp.down 64 blocks of 12 serial steps on
// 132 SMs, with no copy in flight while a block computed.
//
// Design: the split-K cluster mainloop of the fused and int8 GEMMs
// (tugemm_mainloop.cuh; see tugemm_fused.cu) with int8 A taken as stored
// (as in tugemm_int8.cu) and the packed weight plane-decoded in registers
// (as the fused kernel's prequant mode does): all rows of a 64-row tile
// share one read of the weight; each 64-row chunk of packed rows feeds
// A's columns p*Kp + k of every plane p; the block's whole K slice goes in
// flight at once as 16-byte cp.async copies (A's rows past K, and plane
// columns past K, zero-filled; rows that are not 16-byte multiples through
// plain loads); each packed byte is read once and every plane decoded from
// it by a carry-free byte-wise sign extension, transposed K-contiguous by
// prmt; the product runs on the s8 tensor cores (mma.sync.m16n8k32); K is
// split across a thread block cluster by kernels/tugemm_fused.py::split_plan
// (planes = 8/bits) and the int32 partial tiles are summed exactly through
// distributed shared memory. Ragged M, N, Kp and K are masked, so the caller
// pads nothing.
//
// Experts (E > 1, the unfused prequant MoE expert GEMMs, the TPU kernel under
// the reference's vmap): A (E, M, K), PB (E, Kp, N), Y (E, M, N) in one
// launch, the expert folded into grid z as in the fused kernel.

#include "tugemm_mainloop.cuh"

// Returns 0 on success, -1 for a bitwidth other than 4 or 2, -2 for a plan
// outside the kernel's range, else the cudaError_t of the launch. The plan
// (bn, splits, chunks) comes from kernels/tugemm_fused.py::split_plan.
extern "C" int tugemm_packed_launch(const void* a, const void* pb, void* y, int E, int M,
                                    int N, int K, int Kp, int bits, int bn, int splits,
                                    int chunks, void* stream) {
  using namespace tugemm;
  if (bits != 4 && bits != 2) return -1;
  Params p = {};
  p.x = a; p.w = pb; p.c = nullptr; p.y = y;
  p.E = E; p.M = M; p.N = N; p.Kw = Kp; p.Kx = K; p.planes = 8 / bits; p.bits = bits;
  p.bn = bn; p.chunks = chunks;
  return launch<int8_t, W_PACKED, int8_t, int>(p, splits, static_cast<cudaStream_t>(stream));
}
