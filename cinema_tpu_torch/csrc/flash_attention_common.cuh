// Shared pieces of the flash-attention kernels (packed and per-head, forward
// and backward): the block shape, the bf16 tensor-core product and its
// register packing, tile staging and the f32 column helpers.
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
constexpr int kRowsF32 = kThreads / 4;  // f32 backward: rows per block (four threads a row) and per looped tile

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

__device__ __forceinline__ float dot_vec(const __nv_bfloat16* a, const __nv_bfloat16* b) {
  const uint4 x = *reinterpret_cast<const uint4*>(a);
  const uint4 y = *reinterpret_cast<const uint4*>(b);
  const __nv_bfloat162* xs = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* ys = reinterpret_cast<const __nv_bfloat162*>(&y);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fx = __bfloat1622float2(xs[i]);
    const float2 fy = __bfloat1622float2(ys[i]);
    acc = fmaf(fx.x, fy.x, acc);
    acc = fmaf(fx.y, fy.y, acc);
  }
  return acc;
}

__device__ __forceinline__ float dot_vec(const float* a, const float* b) {
  const float4 x = *reinterpret_cast<const float4*>(a);
  const float4 y = *reinterpret_cast<const float4*>(b);
  return fmaf(x.x, y.x, fmaf(x.y, y.y, fmaf(x.z, y.z, x.w * y.w)));
}

// Stage a tile of kTile x D bf16 from global memory: row-major into `tile`
// and, when kTransposed, transposed into `tile_t` as well. Rows from n_rows on are zero.
template <int D, bool kTransposed>
__device__ __forceinline__ void stage_tile(const __nv_bfloat16* __restrict__ base, long long row_stride,
                                           int row0, int n_rows, __nv_bfloat16 (*tile)[D + kPad],
                                           __nv_bfloat16 (*tile_t)[kTile + kPad]) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < kTile * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows) x = *reinterpret_cast<const uint4*>(base + (long long)(row0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(&tile[r][c]) = x;
    if constexpr (kTransposed) {
      const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(&x);
#pragma unroll
      for (int i = 0; i < 8; ++i) tile_t[c + i][r] = xs[i];
    }
  }
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

// f32 backward: four threads share a row; thread c of the four owns columns 16m + 4c .. 16m + 4c + 3
// for every m < D / 16, so the four read 64 contiguous bytes of a shared-memory row.
template <int D>
__device__ __forceinline__ void load_cols(float (&x)[D / 4], const float* row, int c, bool valid) {
#pragma unroll
  for (int m = 0; m < D / 16; ++m) {
    const float4 f = valid ? *reinterpret_cast<const float4*>(row + 16 * m + 4 * c) : make_float4(0.f, 0.f, 0.f, 0.f);
    x[4 * m] = f.x;
    x[4 * m + 1] = f.y;
    x[4 * m + 2] = f.z;
    x[4 * m + 3] = f.w;
  }
}

template <int D>
__device__ __forceinline__ void store_cols(float* row, const float (&x)[D / 4], int c, float scale) {
#pragma unroll
  for (int m = 0; m < D / 16; ++m) {
    *reinterpret_cast<float4*>(row + 16 * m + 4 * c) =
        make_float4(x[4 * m] * scale, x[4 * m + 1] * scale, x[4 * m + 2] * scale, x[4 * m + 3] * scale);
  }
}

template <int D>
__device__ __forceinline__ float dot_cols(const float (&x)[D / 4], const float (&y)[D / 4]) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < D / 4; ++i) acc = fmaf(x[i], y[i], acc);
  return acc;
}

// sum over the four threads of a row (neighbouring lanes)
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

template <int D>
__device__ __forceinline__ void stage_tile_f32(const float* __restrict__ base, long long row_stride, int row0,
                                               int n_rows, float (*tile)[D]) {
  constexpr int kChunks = D / 4;
  for (int idx = threadIdx.x; idx < kRowsF32 * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows) x = *reinterpret_cast<const float4*>(base + (long long)(row0 + r) * row_stride + c);
    *reinterpret_cast<float4*>(&tile[r][c]) = x;
  }
}

}  // namespace
