// The bf16 tensor-core helpers of the fast tier's kernels: ldmatrix loads of
// mma.sync fragments from shared memory, and one m16n8k16 product with bf16
// operands and fp32 sums. K3f's grid recurrence (gru_window_xp_grid.cu) and
// K1f/K2f's projection pass and recurrence (gru_window_fast.cu) share them.
//
// Fragments of m16n8k16 (lane l, g = l / 4, q = l % 4): A (16 x 16, row
// major) in 4 registers of 2 bf16, rows g / g + 8 at k 2q, 2q + 1 and k
// 2q + 8, 2q + 9; B (16 x 8, "col") in 2 registers, k 2q, 2q + 1 and
// 2q + 8, 2q + 9 at column g; C (16 x 8, fp32) c0, c1 at row g, columns 2q,
// 2q + 1, and c2, c3 at row g + 8.

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x2(unsigned (&r)[2], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s));
}

// four 8 x 8 matrices, each transposed on the way: lane l receives elements
// (2 (l % 4), l / 4) and (2 (l % 4) + 1, l / 4) of each stored matrix, so a
// matrix stored k-major ([k][n] or [k][m]) lands as a B or an A fragment
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// c += a b: one m16n8k16 tile, bf16 operands, fp32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace
