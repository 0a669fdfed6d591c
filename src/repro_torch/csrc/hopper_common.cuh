// Device helpers shared by the port's s8 tensor-core kernels (sm_90a):
// byte permutes, 16-byte cp.async copies, the m16n8k32 s8 mma and byte-wise
// absolute values. Included by temporal_unary.cu, unary_stats.cu and
// tugemm_mainloop.cuh (tugemm_fused.cu, tugemm_int8.cu, tugemm_packed.cu);
// kernels/build.py hashes this header into the library name of every source
// that includes it.

#pragma once

#include <stdint.h>

namespace hopper {

__device__ __forceinline__ unsigned prmt(unsigned a, unsigned b, unsigned sel) {
  unsigned d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}
// 0xFF in every byte whose bit 7 is set, else 0
__device__ __forceinline__ unsigned bit7_bytes(unsigned x) { return prmt(x, 0u, 0xBA98u); }

// |b| of each int8 byte as an unsigned byte: |-128| = 0x80 (no carry leaves a byte)
__device__ __forceinline__ unsigned abs_bytes(unsigned x) {
  const unsigned neg = bit7_bytes(x);
  return (x ^ neg) + (neg & 0x01010101u);
}

// 4x4 byte transpose: out[j] byte q = x[q] byte j (rows of 4 bytes in, columns out)
__device__ __forceinline__ void transpose4x4(unsigned x0, unsigned x1, unsigned x2, unsigned x3,
                                             unsigned out[4]) {
  const unsigned lo01 = prmt(x0, x1, 0x5140u), hi01 = prmt(x0, x1, 0x7362u);
  const unsigned lo23 = prmt(x2, x3, 0x5140u), hi23 = prmt(x2, x3, 0x7362u);
  out[0] = prmt(lo01, lo23, 0x5410u);
  out[1] = prmt(lo01, lo23, 0x7632u);
  out[2] = prmt(hi01, hi23, 0x5410u);
  out[3] = prmt(hi01, hi23, 0x7632u);
}

// 16-byte global -> shared copy of which the first src_bytes (0..16) are read
// and the rest zero-filled; src must be 16-byte aligned even when src_bytes is 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// cp_wait with a run-time count of groups that may stay pending (0..7)
__device__ __forceinline__ void cp_wait_upto(int n) {
  switch (n) {
    case 0: cp_wait<0>(); break;
    case 1: cp_wait<1>(); break;
    case 2: cp_wait<2>(); break;
    case 3: cp_wait<3>(); break;
    case 4: cp_wait<4>(); break;
    case 5: cp_wait<5>(); break;
    case 6: cp_wait<6>(); break;
    default: cp_wait<7>(); break;
  }
}

// c += a (16x32, row) * b (32x8, col), s8 x s8 -> s32
__device__ __forceinline__ void mma_s8(int* c, const unsigned* a, unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace hopper
