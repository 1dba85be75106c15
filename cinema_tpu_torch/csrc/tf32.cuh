// Split-TF32 products on the tensor cores (mma.sync m16n8k8), shared by the f32 forward and backward.
//
// One TF32 product keeps 10 mantissa bits of each operand, so each f32 operand x is split into hi = x rounded
// to TF32 and the remainder lo = x - hi, and each product is a_lo b_hi + a_hi b_lo + a_hi b_hi: three TF32
// passes, with a_lo b_lo (below 2^-22 of the product) dropped. What the tensor core does with an f32 register
// read as TF32, and how it rounds its sums, is measured by tf32_probe (flash_attention_fwd.cu; chip_smoke.py
// prints it): on an NVIDIA H100 80GB HBM3 it drops the low 13 mantissa bits and rounds sums toward zero.
#pragma once

#include "flash_attention_common.cuh"

namespace {

// One product D (16 x 8) += A (16 x 8) * B (8 x 8), TF32 operands, f32 sums. With g = lane / 4 and
// t = lane % 4: a0 = A[g][t], a1 = A[g + 8][t], a2 = A[g][t + 4], a3 = A[g + 8][t + 4]; b0 = B[t][g],
// b1 = B[t + 4][g]; d0, d1 = D[g][2t, 2t + 1], d2, d3 = D[g + 8][2t, 2t + 1].
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x = hi + lo: hi is x rounded to TF32 (10 mantissa bits; to nearest, ties away, as cvt.rna.tf32 rounds, by
// adding half a TF32 ulp to the bits and masking: three instructions fewer than the cvt, which also sorts out
// NaN, and a NaN or infinite x makes the output NaN either way), lo the exact f32 remainder. lo takes either
// sign, so the tensor core's truncation of it to 11 significant bits (below 2^-22 |x|) is no bias.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// D = A * B, the same product from a zero accumulator
__device__ __forceinline__ void mma_tf32_zero(float* d, const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f), "f"(0.f), "f"(0.f), "f"(0.f));
}

// d (+)= a b for split operands: a_lo b_hi + a_hi b_lo + a_hi b_hi (the small terms first; a_lo b_lo, below
// 2^-22 of the product, is dropped), from zero where kFirst
template <bool kFirst>
__device__ __forceinline__ void mma_tf32x3(float* d, const uint32_t (&a_hi)[4], const uint32_t (&a_lo)[4],
                                           const uint32_t (&b_hi)[2], const uint32_t (&b_lo)[2]) {
  if constexpr (kFirst) {
    mma_tf32_zero(d, a_lo, b_hi);
  } else {
    mma_tf32(d, a_lo, b_hi);
  }
  mma_tf32(d, a_hi, b_lo);
  mma_tf32(d, a_hi, b_hi);
}

// k-steps (of 8) whose products the tensor core sums before the CUDA cores add that sum to the running one.
// The tensor core rounds its sums toward zero (tf32_probe), so a long run of sums in its accumulator shrinks
// them: over a whole key panel (3 products x 8 k-steps a stage) O came out up to ~2e-5 smaller, relative,
// than f32 sums give it, and the f32 backward, which recomputes P from the saved log-sum-exp and takes O as
// it is, turned that into gradients 5e-3 of a parameter's largest off. Fewer k-steps a sum mean less bias,
// more additions and more registers: tools/torch_f32_sums.py measures each setting (PERF.md section 6).
constexpr int kStepsPerSum = 4;

}  // namespace
