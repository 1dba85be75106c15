// Packed multi-head flash-attention forward for Hopper (sm_90a).
//
// Replaces cinema_tpu/ops/pallas/flash_attention.py `_packed_forward`
// (kernel `_packed_fwd_kernel`): out = softmax(q k^T / sqrt(d)) v per head on
// packed (batch, tokens, embed) operands, embed = n_heads * head_dim, with the
// heads split inside the kernel. k and v may be column slices of the fused kv
// projection (row stride 2 * embed): every operand is addressed through its
// own batch and row strides, so nothing is copied before the launch.
//
// Design (Hopper blocks run in parallel and in no order, so nothing carries
// between blocks; the TPU kernel's sequential q-block grid becomes one block
// per (q-tile, head, batch) that loops over key tiles itself):
//
// - bf16: 4 warps, 16 query rows each (64 per block). q fragments stay in
//   registers; each 64-key tile of k and v is staged in shared memory (v
//   transposed) and multiplied with mma.sync m16n8k16 (bf16 in, f32
//   accumulate). The score accumulator's register layout is reused as the
//   A operand of the P.V product, so probabilities never leave registers.
// - f32: one thread per query row over 32-key tiles in shared memory, FMA on
//   the CUDA cores (no tensor-core format keeps f32 exact).
// - online softmax in the log2 domain with f32 running max and sum; ragged
//   key tails are masked to -inf exactly (the TPU kernel's closed-form
//   pad-mass correction is not needed here), ragged query rows are neither
//   loaded nor stored.
//
// Bound at the serving shape (B=8, Tq=Tk=2305, E=768, H=12, D=64, bf16):
// 4*B*Tq*Tk*E = 1.31e11 flop -> 0.13 ms at 989 TFLOP/s dense bf16, while the
// bytes (q, k, v read once, out written once) take 0.034 ms at 3.35 TB/s, so
// the kernel is bounded by tensor-core operations. This first version uses
// mma.sync without cp.async pipelining, wgmma or TMA; those come later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQ = kWarps * 16;  // bf16 path: query rows per block
constexpr int kBlockK = 64;           // bf16 path: keys per tile
constexpr int kPad = 8;               // bf16 elements of row padding (bank spread)
constexpr int kBlockKF32 = 32;        // f32 path: keys per tile

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

template <int D>
__global__ void __launch_bounds__(kThreads)
    packed_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int n_q,
                    int n_k, long long q_sb, long long q_st, long long k_sb, long long k_st,
                    long long v_sb, long long v_st, long long o_sb, long long o_st,
                    float scale_log2) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  __shared__ __align__(16) __nv_bfloat16 k_tile[kBlockK][D + kPad];   // [key][d]
  __shared__ __align__(16) __nv_bfloat16 vt_tile[D][kBlockK + kPad];  // [d][key]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // mma group: row within the 8-row half
  const int t = lane & 3;   // thread within the group: column pair
  const int head = blockIdx.y;
  const int batch = blockIdx.z;

  const int row0 = blockIdx.x * kBlockQ + warp * 16 + g;
  const int row1 = row0 + 8;
  const bool ok0 = row0 < n_q;
  const bool ok1 = row1 < n_q;

  const __nv_bfloat16* qb = q + batch * q_sb + head * D;
  const __nv_bfloat16* kb = k + batch * k_sb + head * D;
  const __nv_bfloat16* vb = v + batch * v_sb + head * D;
  const __nv_bfloat16* q0 = qb + (long long)(ok0 ? row0 : 0) * q_st;
  const __nv_bfloat16* q1 = qb + (long long)(ok1 ? row1 : 0) * q_st;

  // A fragments of this warp's 16 query rows, one per 16-wide d step
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int c = ks * 16 + 2 * t;
    qf[ks][0] = load_pair(q0, c, ok0);
    qf[ks][1] = load_pair(q1, c, ok1);
    qf[ks][2] = load_pair(q0, c + 8, ok0);
    qf[ks][3] = load_pair(q1, c + 8, ok1);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  }
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;  // running row max (log2 domain)
  float l0 = 0.f, l1 = 0.f;                      // this thread's share of the row sum

  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int k0 = 0; k0 < n_k; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < kBlockK * kChunks; idx += kThreads) {
      const int r = idx / kChunks;
      const int c = (idx % kChunks) * 8;
      uint4 kv4 = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv4 = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < n_k) {
        kv4 = *reinterpret_cast<const uint4*>(kb + (long long)(k0 + r) * k_st + c);
        vv4 = *reinterpret_cast<const uint4*>(vb + (long long)(k0 + r) * v_st + c);
      }
      *reinterpret_cast<uint4*>(&k_tile[r][c]) = kv4;
      const __nv_bfloat16* vs = reinterpret_cast<const __nv_bfloat16*>(&vv4);
#pragma unroll
      for (int i = 0; i < 8; ++i) vt_tile[c + i][r] = vs[i];
    }
    __syncthreads();

    // scores: 16 rows x kBlockK keys per warp, as kBlockK/8 accumulator tiles
    float s[kBlockK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* krow = &k_tile[nt * 8 + g][0];
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + ks * 16 + 2 * t);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + ks * 16 + 2 * t + 8);
        mma_bf16_16816(s[nt], qf[ks], b0, b1);
      }
    }

    // scale into the log2 domain, mask the ragged key tail, row max
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
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
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - m0);
      s[nt][1] = exp2f(s[nt][1] - m0);
      s[nt][2] = exp2f(s[nt][2] - m1);
      s[nt][3] = exp2f(s[nt][3] - m1);
      l0 += s[nt][0] + s[nt][1];
      l1 += s[nt][2] + s[nt][3];
    }

    // out += P V: two score tiles form one 16x16 A fragment of P
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const __nv_bfloat16* vrow = &vt_tile[dt * 8 + g][kk * 16 + 2 * t];
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(vrow);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(vrow + 8);
        mma_bf16_16816(acc[dt], pa, b0, b1);
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0;
  const float inv1 = 1.f / l1;
  __nv_bfloat16* ob = o + batch * o_sb + head * D;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (ok0) {
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row0 * o_st + c) =
          __floats2bfloat162_rn(acc[dt][0] * inv0, acc[dt][1] * inv0);
    }
    if (ok1) {
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row1 * o_st + c) =
          __floats2bfloat162_rn(acc[dt][2] * inv1, acc[dt][3] * inv1);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    packed_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o, int n_q, int n_k,
                   long long q_sb, long long q_st, long long k_sb, long long k_st, long long v_sb,
                   long long v_st, long long o_sb, long long o_st, float scale_log2) {
  static_assert(D % 4 == 0, "head_dim must be a multiple of 4");
  __shared__ __align__(16) float k_tile[kBlockKF32][D];
  __shared__ __align__(16) float v_tile[kBlockKF32][D];

  const int tid = threadIdx.x;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int row = blockIdx.x * kThreads + tid;
  const bool ok = row < n_q;

  const float* kb = k + batch * k_sb + head * D;
  const float* vb = v + batch * v_sb + head * D;
  float qr[D];
  float acc[D];
  {
    const float* qrow = q + batch * q_sb + head * D + (long long)(ok ? row : 0) * q_st;
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
        kx = *reinterpret_cast<const float4*>(kb + (long long)(k0 + r) * k_st + c);
        vx = *reinterpret_cast<const float4*>(vb + (long long)(k0 + r) * v_st + c);
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
    const float inv = 1.f / l;
    float* orow = o + batch * o_sb + head * D + (long long)row * o_st;
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      *reinterpret_cast<float4*>(orow + d) =
          make_float4(acc[d] * inv, acc[d + 1] * inv, acc[d + 2] * inv, acc[d + 3] * inv);
    }
  }
}

}  // namespace

// Plain C entry point, bound from Python with ctypes.
//   dtype: 0 = float32, 1 = bfloat16; strides are in elements:
//   strides[0..7] = q batch, q row, k batch, k row, v batch, v row, out batch, out row.
// Returns cudaGetLastError() after the launch, or -1 for an unsupported
// dtype/head_dim combination (the Python wrapper checks before calling).
extern "C" int cinema_flash_attention_packed_fwd(const void* q, const void* k, const void* v,
                                                 void* o, int dtype, int batch, int n_q, int n_k,
                                                 int n_heads, int head_dim,
                                                 const long long* strides, float scale_log2,
                                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* s = strides;
  if (n_q <= 0 || n_k <= 0 || batch <= 0 || n_heads <= 0) return -1;
  if (dtype == 1) {
    const dim3 grid((n_q + kBlockQ - 1) / kBlockQ, n_heads, batch);
    const auto* qp = static_cast<const __nv_bfloat16*>(q);
    const auto* kp = static_cast<const __nv_bfloat16*>(k);
    const auto* vp = static_cast<const __nv_bfloat16*>(v);
    auto* op = static_cast<__nv_bfloat16*>(o);
    if (head_dim == 64) {
      packed_fwd_bf16<64><<<grid, kThreads, 0, st>>>(qp, kp, vp, op, n_q, n_k, s[0], s[1], s[2],
                                                     s[3], s[4], s[5], s[6], s[7], scale_log2);
    } else if (head_dim == 32) {
      packed_fwd_bf16<32><<<grid, kThreads, 0, st>>>(qp, kp, vp, op, n_q, n_k, s[0], s[1], s[2],
                                                     s[3], s[4], s[5], s[6], s[7], scale_log2);
    } else {
      return -1;
    }
  } else if (dtype == 0) {
    const dim3 grid((n_q + kThreads - 1) / kThreads, n_heads, batch);
    const auto* qp = static_cast<const float*>(q);
    const auto* kp = static_cast<const float*>(k);
    const auto* vp = static_cast<const float*>(v);
    auto* op = static_cast<float*>(o);
    if (head_dim == 64) {
      packed_fwd_f32<64><<<grid, kThreads, 0, st>>>(qp, kp, vp, op, n_q, n_k, s[0], s[1], s[2],
                                                    s[3], s[4], s[5], s[6], s[7], scale_log2);
    } else if (head_dim == 32) {
      packed_fwd_f32<32><<<grid, kThreads, 0, st>>>(qp, kp, vp, op, n_q, n_k, s[0], s[1], s[2],
                                                    s[3], s[4], s[5], s[6], s[7], scale_log2);
    } else {
      return -1;
    }
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
