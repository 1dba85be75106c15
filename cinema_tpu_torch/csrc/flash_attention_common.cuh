// Shared pieces of the flash-attention kernels (forward and backward, both
// layouts): operand strides, the thread count of the backward's delta
// pre-pass, and the row helpers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // threads of a block of the backward's delta pre-pass

// element strides of one (batch, tokens, heads, head_dim) operand; head_dim is contiguous. A packed
// (batch, tokens, embed) operand has head stride head_dim.
struct Strides {
  long long b, t, h;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// sum over the four threads of a row (neighbouring lanes)
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

}  // namespace
