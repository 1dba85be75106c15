// Shared pieces of the flash-attention kernels (packed and per-head, forward
// and backward): the block shape of the forwards, their bf16 tensor-core
// product and its register packing, and the row helpers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;  // bf16 elements of row padding in shared memory (bank spread)
constexpr int kTile = kWarps * 16;      // bf16: rows of a block's own tile and of the tiles it loops over

// element strides of one (batch, tokens, heads, head_dim) operand of the per-head kernels; head_dim is contiguous
struct Strides {
  long long b, t, h;
};

// c += a . b on one 16x8 tile, depth 16: a is 16x16 (row-major fragments), b is
// 16x8 (column-major fragments), bf16 in and f32 accumulate. With g = lane / 4
// and t = lane % 4 a thread holds
//   a[0] = A[g][2t..2t+1], a[1] = A[g+8][2t..], a[2] = A[g][2t+8..], a[3] = A[g+8][2t+8..];
//   b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g];
//   c[0..1] = C[g][2t..2t+1], c[2..3] = C[g+8][2t..2t+1].
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* row, int col, bool valid) {
  return valid ? *reinterpret_cast<const uint32_t*>(row + col) : 0u;
}

// The A fragments of a warp's 16 rows (row0 and row1 = row0 + 8 of this thread), one per 16-wide d step
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[D / 16][4], const __nv_bfloat16* r0,
                                             const __nv_bfloat16* r1, bool ok0, bool ok1, int t) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int c = ks * 16 + 2 * t;
    f[ks][0] = load_pair(r0, c, ok0);
    f[ks][1] = load_pair(r1, c, ok1);
    f[ks][2] = load_pair(r0, c + 8, ok0);
    f[ks][3] = load_pair(r1, c + 8, ok1);
  }
}

// sum over the four threads of a row (neighbouring lanes)
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

}  // namespace
