// 3xTF32 products on the tensor cores of an H100, for matmul.cu's f32 path.
//
// A TF32 operand keeps 10 of f32's 23 mantissa bits. Split each f32 value x
// into hi = tf32(x) (rounded to nearest) and lo = tf32(x - hi)
// (x - hi is exact in f32); then x*y = hi_x*hi_y + hi_x*lo_y + lo_x*hi_y +
// lo_x*lo_y, and the last term, about 2^-22 of the product, is dropped.
// Three mma.sync.m16n8k8 TF32 products with f32 accumulation (matmul.cu
// issues them lo*hi, hi*lo, then hi*hi) give about f32's accuracy at a
// third of the TF32 rate: 495 / 3 = 165 TFLOP/s on an H100 SXM by the data
// sheet, against 67 TFLOP/s of f32 FFMA; mma.sync's own TF32 rate is lower
// than the data sheet's, which wgmma reaches (mma_rate.py measures it).
//
// Fragments of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 (PTX ISA),
// lane = 4g + t:
//   A (16 x 8, row-major): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//                          a3 (g + 8, t + 4);
//   B (8 x 8):             b0 (k = t, n = g), b1 (k = t + 4, n = g);
//   C (16 x 8, f32):       c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//                          c3 (g + 8, 2t + 1).

#pragma once

#include <stdint.h>

namespace tf32 {

// x as (hi, lo) TF32 bit patterns, each rounded to nearest (ties away from
// zero, as cvt.rna.tf32.f32) by integer adds and masks on the f32 bits
// (full-rate ALU instructions; the tensor cores read the top 19 bits)
__device__ __forceinline__ uint32_t round_tf32(uint32_t u) { return (u + 0x1000u) & 0xffffe000u; }

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = round_tf32(__float_as_uint(x));
  lo = round_tf32(__float_as_uint(x - __uint_as_float(hi)));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace tf32
