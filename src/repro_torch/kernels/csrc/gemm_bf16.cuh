// bf16 products on the tensor cores of an H100, for matmul.cu's bf16 path.
//
// bf16 operands need no split: a product of two bf16 values is exact in
// f32, so one mma.sync.m16n8k16 with f32 accumulation a k step of 16 gives
// the f32 sums of the function (matmul.cu sums each chunk of K in a fresh
// tile and adds it into the running sum on the CUDA cores, as the 3xTF32
// path does: the mma's own accumulation rounds toward zero). That is the
// TPU kernel's arithmetic, jnp.dot(bf16, bf16, preferred_element_type=f32).
// Its ceiling is mma.sync's bf16 rate, below the data sheet's 989 TFLOP/s,
// which only wgmma reaches.
//
// Fragments of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 (PTX ISA),
// lane = 4g + t, each 32-bit register two bf16 (the lower k in the low half):
//   A (16 x 16, row-major): a0 (g, 2t..2t+1), a1 (g + 8, 2t..2t+1),
//                           a2 (g, 2t+8..2t+9), a3 (g + 8, 2t+8..2t+9);
//   B (16 x 8):             b0 (k = 2t..2t+1, n = g), b1 (k = 2t+8..2t+9, n = g);
//   C (16 x 8, f32):        c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//                           c3 (g + 8, 2t + 1).
// Both are read from shared memory by ldmatrix: A's k-contiguous rows as
// they are (four 8 x 8 matrices: rows 0-7 and 8-15, k 0-7 and 8-15, give
// a0..a3), B's n-contiguous rows transposed (.trans: lane (g, t) receives
// stored rows 2t and 2t+1 of column g, the B fragment), two n8 tiles a
// call. Each lane names one 16-byte row of one matrix; rows whose pitch is
// an odd number of 16-byte words put a matrix's 8 rows on 8 bank quads.

#pragma once

#include <stdint.h>

namespace bf16mma {

// Four 8 x 8 b16 matrices; lane l names row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(row))));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(row))));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace bf16mma
