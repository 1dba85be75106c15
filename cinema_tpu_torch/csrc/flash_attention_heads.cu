// Per-head flash-attention forward for Hopper (sm_90a).
//
// Replaces cinema_tpu/ops/pallas/flash_attention.py `_flash_forward` (kernel
// `_flash_kernel`, public `flash_attention`): out = softmax(q k^T / sqrt(d)) v
// for every (batch, head) on operands shaped (batch, tokens, heads, head_dim).
// This is the path attention takes when q and k were changed per head before
// the product (qk-norm, rotary embedding), so q and k arrive as fresh
// (batch, tokens, heads, head_dim) tensors while v is still a strided view of
// the fused kv projection.
//
// Design. The TPU kernel transposes to (batch, heads, tokens, head_dim), pads
// both token axes to 128 and holds the whole key panel of one head in fast
// memory. None of that is carried over:
//
// - every operand is addressed through three strides of its own (batch,
//   token, head) with a contiguous head_dim axis, so the (batch, tokens,
//   heads, head_dim) layout, its (batch, heads, tokens, head_dim) transpose and
//   the v half of a fused kv buffer are all read in place, with no copy, no
//   transpose and no padding;
// - blocks run in parallel and in no order, so one block owns a 64-row q tile
//   of one (batch, head) and loops over 64-key tiles itself with an online
//   softmax (f32 running max and sum, log2 domain);
// - bf16: 4 warps of 16 rows; q fragments stay in registers, each key tile of
//   k and v is staged in shared memory (v transposed) and multiplied with
//   mma.sync m16n8k16 (f32 accumulate); the score accumulators are re-packed
//   in registers as the A operand of P.V;
// - f32: one thread per q row over 32-key tiles, FMA on the CUDA cores;
// - the ragged key tail is masked to -inf exactly and rows past n_q are
//   neither loaded nor stored; n_q and n_k may differ;
// - the row log-sum-exp (log2 domain, (batch, heads, n_q) f32) is written only
//   when the caller passes a buffer for it, i.e. when a gradient is needed.
//
// Bound at the fine-tuning shape of ConvViT-base (B=4, Tq=Tk=2305, H=12, D=64,
// bf16): 4*B*Tq*Tk*H*D = 6.5e10 flop -> 0.066 ms at 989 TFLOP/s dense bf16,
// against 0.017 ms for the bytes (q, k, v read once and out written once at
// 3.35 TB/s): bounded by tensor-core operations. This first version uses
// mma.sync without cp.async pipelining, wgmma or TMA; those come later.

#include "flash_attention_common.cuh"

namespace {

constexpr int kBlockKF32 = 32;  // f32 path: keys per tile

template <int D>
__global__ void __launch_bounds__(kThreads)
    heads_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int n_q, int n_k,
                   Strides qs, Strides ks, Strides vs, Strides os, float scale_log2, float* __restrict__ lse) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  __shared__ __align__(16) __nv_bfloat16 k_tile[kTile][D + kPad];   // [key][d]
  __shared__ __align__(16) __nv_bfloat16 vt_tile[D][kTile + kPad];  // [d][key]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // mma group: row within the 8-row half
  const int t = lane & 3;   // thread within the group: column pair
  const int head = blockIdx.y;
  const int batch = blockIdx.z;

  const int row0 = blockIdx.x * kTile + warp * 16 + g;
  const int row1 = row0 + 8;
  const bool ok0 = row0 < n_q;
  const bool ok1 = row1 < n_q;

  const __nv_bfloat16* qb = q + batch * qs.b + head * qs.h;
  const __nv_bfloat16* kb = k + batch * ks.b + head * ks.h;
  const __nv_bfloat16* vb = v + batch * vs.b + head * vs.h;

  uint32_t qf[D / 16][4];
  load_a_frags<D>(qf, qb + (long long)(ok0 ? row0 : 0) * qs.t, qb + (long long)(ok1 ? row1 : 0) * qs.t, ok0, ok1, t);

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;  // running row max (log2 domain)
  float l0 = 0.f, l1 = 0.f;                      // this thread's share of the row sum

  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int k0 = 0; k0 < n_k; k0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < kTile * kChunks; idx += kThreads) {
      const int r = idx / kChunks;
      const int c = (idx % kChunks) * 8;
      uint4 kv4 = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv4 = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < n_k) {
        kv4 = *reinterpret_cast<const uint4*>(kb + (long long)(k0 + r) * ks.t + c);
        vv4 = *reinterpret_cast<const uint4*>(vb + (long long)(k0 + r) * vs.t + c);
      }
      *reinterpret_cast<uint4*>(&k_tile[r][c]) = kv4;
      const __nv_bfloat16* vx = reinterpret_cast<const __nv_bfloat16*>(&vv4);
#pragma unroll
      for (int i = 0; i < 8; ++i) vt_tile[c + i][r] = vx[i];
    }
    __syncthreads();

    // scores: 16 rows x kTile keys per warp, as kTile/8 accumulator tiles
    float s[kTile / 8][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* krow = &k_tile[nt * 8 + g][0];
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 2 * t);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 2 * t + 8);
        mma_bf16_16816(s[nt], qf[kk], b0, b1);
      }
    }

    // scale into the log2 domain, mask the ragged key tail, row max
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + nt * 8 + 2 * t + (j & 1);
        s[nt][j] = key < n_k ? s[nt][j] * scale_log2 : -CUDART_INF_F;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    // the four threads of a group hold one row between them
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // key 0 is in the first tile, so the max is finite from the first tile on
    const float alpha0 = exp2f(m0 - mx0);
    const float alpha1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= alpha0;
    l1 *= alpha1;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= alpha0;
      acc[dt][1] *= alpha0;
      acc[dt][2] *= alpha1;
      acc[dt][3] *= alpha1;
    }
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - m0);
      s[nt][1] = exp2f(s[nt][1] - m0);
      s[nt][2] = exp2f(s[nt][2] - m1);
      s[nt][3] = exp2f(s[nt][3] - m1);
      l0 += s[nt][0] + s[nt][1];
      l1 += s[nt][2] + s[nt][3];
    }

    // out += P V: two score tiles form one 16x16 A fragment of P
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const __nv_bfloat16* vrow = &vt_tile[dt * 8 + g][kk * 16 + 2 * t];
        mma_bf16_16816(acc[dt], pa, *reinterpret_cast<const uint32_t*>(vrow),
                       *reinterpret_cast<const uint32_t*>(vrow + 8));
      }
    }
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float inv0 = 1.f / l0;
  const float inv1 = 1.f / l1;
  if (lse != nullptr && t == 0) {
    // row log-sum-exp of the scaled scores, log2 domain: what the backward recomputes P from
    float* lse_row = lse + ((long long)batch * gridDim.y + head) * n_q;
    if (ok0) lse_row[row0] = m0 + log2f(l0);
    if (ok1) lse_row[row1] = m1 + log2f(l1);
  }
  __nv_bfloat16* ob = o + batch * os.b + head * os.h;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (ok0) {
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row0 * os.t + c) =
          __floats2bfloat162_rn(acc[dt][0] * inv0, acc[dt][1] * inv0);
    }
    if (ok1) {
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row1 * os.t + c) =
          __floats2bfloat162_rn(acc[dt][2] * inv1, acc[dt][3] * inv1);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    heads_fwd_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                  float* __restrict__ o, int n_q, int n_k, Strides qs, Strides ks, Strides vs, Strides os,
                  float scale_log2, float* __restrict__ lse) {
  static_assert(D % 4 == 0, "head_dim must be a multiple of 4");
  __shared__ __align__(16) float k_tile[kBlockKF32][D];
  __shared__ __align__(16) float v_tile[kBlockKF32][D];

  const int tid = threadIdx.x;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int row = blockIdx.x * kThreads + tid;
  const bool ok = row < n_q;

  const float* kb = k + batch * ks.b + head * ks.h;
  const float* vb = v + batch * vs.b + head * vs.h;
  float qr[D];
  float acc[D];
  {
    const float* qrow = q + batch * qs.b + head * qs.h + (long long)(ok ? row : 0) * qs.t;
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      float4 x = ok ? *reinterpret_cast<const float4*>(qrow + d) : make_float4(0.f, 0.f, 0.f, 0.f);
      qr[d] = x.x * scale_log2;
      qr[d + 1] = x.y * scale_log2;
      qr[d + 2] = x.z * scale_log2;
      qr[d + 3] = x.w * scale_log2;
      acc[d] = acc[d + 1] = acc[d + 2] = acc[d + 3] = 0.f;
    }
  }
  float m = -CUDART_INF_F, l = 0.f;

  constexpr int kChunks = D / 4;
  for (int k0 = 0; k0 < n_k; k0 += kBlockKF32) {
    __syncthreads();
    for (int idx = tid; idx < kBlockKF32 * kChunks; idx += kThreads) {
      const int r = idx / kChunks;
      const int c = (idx % kChunks) * 4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vx = kx;
      if (k0 + r < n_k) {
        kx = *reinterpret_cast<const float4*>(kb + (long long)(k0 + r) * ks.t + c);
        vx = *reinterpret_cast<const float4*>(vb + (long long)(k0 + r) * vs.t + c);
      }
      *reinterpret_cast<float4*>(&k_tile[r][c]) = kx;
      *reinterpret_cast<float4*>(&v_tile[r][c]) = vx;
    }
    __syncthreads();

    const int n_valid = n_k - k0;
    float s[kBlockKF32];
    float mx = m;
#pragma unroll
    for (int j = 0; j < kBlockKF32; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], k_tile[j][d], dot);
      s[j] = j < n_valid ? dot : -CUDART_INF_F;
      mx = fmaxf(mx, s[j]);
    }
    const float alpha = exp2f(m - mx);
    m = mx;
    l *= alpha;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kBlockKF32; ++j) {
      const float p = exp2f(s[j] - m);
      l += p;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(p, v_tile[j][d], acc[d]);
    }
  }

  if (ok) {
    if (lse != nullptr) lse[((long long)batch * gridDim.y + head) * n_q + row] = m + log2f(l);
    const float inv = 1.f / l;
    float* orow = o + batch * os.b + head * os.h + (long long)row * os.t;
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      *reinterpret_cast<float4*>(orow + d) =
          make_float4(acc[d] * inv, acc[d + 1] * inv, acc[d + 2] * inv, acc[d + 3] * inv);
    }
  }
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, int batch, int n_q, int n_k, int n_heads,
               const long long* s, float scale_log2, float* lse, cudaStream_t st) {
  const Strides qs{s[0], s[1], s[2]}, ks{s[3], s[4], s[5]}, vs{s[6], s[7], s[8]}, os{s[9], s[10], s[11]};
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
  if constexpr (sizeof(T) == 2) {
    const dim3 grid((n_q + kTile - 1) / kTile, n_heads, batch);
    heads_fwd_bf16<D><<<grid, kThreads, 0, st>>>(qp, kp, vp, op, n_q, n_k, qs, ks, vs, os, scale_log2, lse);
  } else {
    const dim3 grid((n_q + kThreads - 1) / kThreads, n_heads, batch);
    heads_fwd_f32<D><<<grid, kThreads, 0, st>>>(qp, kp, vp, op, n_q, n_k, qs, ks, vs, os, scale_log2, lse);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, bound from Python with ctypes.
//   dtype: 0 = float32, 1 = bfloat16; strides are in elements, (batch, token, head) triples:
//   strides[0..11] = q, k, v, out.
//   lse: null, or (batch, n_heads, n_q) float32 that receives each row's
//   log-sum-exp of the scaled scores in the log2 domain (saved for the backward).
// Returns cudaGetLastError() after the launch, or -1 for an unsupported
// dtype/head_dim combination (the Python wrapper checks before calling).
extern "C" int cinema_flash_attention_heads_fwd(const void* q, const void* k, const void* v, void* o, int dtype,
                                                int batch, int n_q, int n_k, int n_heads, int head_dim,
                                                const long long* strides, float scale_log2, void* lse,
                                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lp = static_cast<float*>(lse);
  if (n_q <= 0 || n_k <= 0 || batch <= 0 || n_heads <= 0) return -1;
  if (dtype == 1 && head_dim == 64) {
    return launch_fwd<__nv_bfloat16, 64>(q, k, v, o, batch, n_q, n_k, n_heads, strides, scale_log2, lp, st);
  }
  if (dtype == 1 && head_dim == 32) {
    return launch_fwd<__nv_bfloat16, 32>(q, k, v, o, batch, n_q, n_k, n_heads, strides, scale_log2, lp, st);
  }
  if (dtype == 0 && head_dim == 64) {
    return launch_fwd<float, 64>(q, k, v, o, batch, n_q, n_k, n_heads, strides, scale_log2, lp, st);
  }
  if (dtype == 0 && head_dim == 32) {
    return launch_fwd<float, 32>(q, k, v, o, batch, n_q, n_k, n_heads, strides, scale_log2, lp, st);
  }
  return -1;
}
