// Per-head flash-attention backward for Hopper (sm_90a).
//
// Replaces cinema_tpu/ops/pallas/flash_attention.py `_bwd` (kernel
// `_flash_bwd_kernel`): given q, k, v, the forward's output o and the output
// gradient g, all shaped (batch, tokens, heads, head_dim), per (batch, head)
//
//   P  = softmax(q k^T / sqrt(d))          recomputed from the saved row log-sum-exp
//   dP = g v^T,  delta = rowsum(g * o),  dS = P * (dP - delta)
//   dq = dS k / sqrt(d),  dk = dS^T q / sqrt(d),  dv = P^T g
//
// dq in q's dtype; dk and dv accumulated in f32 and cast once. Every operand
// and every gradient is addressed through its own (batch, token, head)
// strides, so v is read in place from the fused kv projection and dv is
// written straight into the v half of a buffer shaped like it.
//
// Design. The TPU kernel walks the q-blocks of one (batch, head) in grid
// order and adds into one dk/dv block that stays resident over the innermost
// grid axis. Blocks here run in parallel and in no order, so that sum across
// q-blocks needs either atomics or a second pass. This kernel takes the
// second pass, as the packed backward does: three launches, each output
// element owned by exactly one thread, so gradients are bit-equal from run to
// run at the price of recomputing S and dP in both passes:
//
// 1. delta: one thread per (batch, head, row);
// 2. dk/dv: one block per (64-key tile, head, batch) loops over q tiles; its k
//    and v rows stay in registers as tensor-core A fragments, so S^T = k q^T
//    and dP^T = v g^T come out as 16 keys x 64 rows per warp and are re-packed
//    in registers as the A operand of dv += P^T g and dk += dS^T q;
// 3. dq: one block per (64-row q tile, head, batch) loops over key tiles.
//
// bf16 products use mma.sync m16n8k16 with f32 accumulation; f32 inputs stay
// on the CUDA cores, four threads per row. Rows past n_q load zeros for q and
// g and +inf for the log-sum-exp (P = 0 exactly); keys past n_k get P = 0 in
// the dq pass and are never stored by the dk/dv pass.
//
// Bound at the fine-tuning shape of ConvViT-base (B=4, Tq=Tk=2305, H=12, D=64,
// bf16): five products, 10*B*Tq*Tk*H*D = 1.6e11 flop -> 0.165 ms at 989
// TFLOP/s, against 0.034 ms for the bytes (q, k, v, o, g read and dq, dk, dv
// written once at 3.35 TB/s): bounded by tensor-core operations. This first
// version does 14 products' worth of mma.sync without cp.async pipelining,
// wgmma or TMA; those come later.

#include "flash_attention_common.cuh"

namespace {

// delta[batch][head][row] = sum over head_dim of g * o
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    heads_bwd_delta(const T* __restrict__ g, const T* __restrict__ o, float* __restrict__ delta, int batch,
                    int n_q, int n_heads, Strides gs, Strides os) {
  constexpr int kVec = 16 / sizeof(T);
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (long long)batch * n_heads * n_q) return;
  const int row = idx % n_q;
  const int head = (idx / n_q) % n_heads;
  const int b = idx / ((long long)n_q * n_heads);
  const T* gr = g + b * gs.b + row * gs.t + head * gs.h;
  const T* orow = o + b * os.b + row * os.t + head * os.h;
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < D; d += kVec) acc += dot_vec(gr + d, orow + d);
  delta[idx] = acc;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    heads_bwd_dq_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ g,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dq, int n_q, int n_k, Strides qs, Strides ks, Strides vs,
                      Strides gs, Strides dqs, float scale_log2, float scale) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  __shared__ __align__(16) __nv_bfloat16 k_tile[kTile][D + kPad];   // [key][d]
  __shared__ __align__(16) __nv_bfloat16 kt_tile[D][kTile + kPad];  // [d][key]
  __shared__ __align__(16) __nv_bfloat16 v_tile[kTile][D + kPad];   // [key][d]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gi = lane >> 2;
  const int t = lane & 3;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int row0 = blockIdx.x * kTile + warp * 16 + gi;
  const int row1 = row0 + 8;
  const bool ok0 = row0 < n_q;
  const bool ok1 = row1 < n_q;

  const __nv_bfloat16* qb = q + batch * qs.b + head * qs.h;
  const __nv_bfloat16* gb = g + batch * gs.b + head * gs.h;
  const __nv_bfloat16* kb = k + batch * ks.b + head * ks.h;
  const __nv_bfloat16* vb = v + batch * vs.b + head * vs.h;
  uint32_t qf[D / 16][4];
  uint32_t gf[D / 16][4];
  load_a_frags<D>(qf, qb + (long long)(ok0 ? row0 : 0) * qs.t, qb + (long long)(ok1 ? row1 : 0) * qs.t, ok0, ok1, t);
  load_a_frags<D>(gf, gb + (long long)(ok0 ? row0 : 0) * gs.t, gb + (long long)(ok1 ? row1 : 0) * gs.t, ok0, ok1, t);
  const long long stat = ((long long)batch * gridDim.y + head) * n_q;
  // +inf for a row past n_q: its P is exp2(s - inf) = 0 exactly
  const float lse_r[2] = {ok0 ? lse[stat + row0] : CUDART_INF_F, ok1 ? lse[stat + row1] : CUDART_INF_F};
  const float delta_r[2] = {ok0 ? delta[stat + row0] : 0.f, ok1 ? delta[stat + row1] : 0.f};

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  for (int k0 = 0; k0 < n_k; k0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    stage_tile<D, true>(kb, ks.t, k0, n_k, k_tile, kt_tile);
    stage_tile<D, false>(vb, vs.t, k0, n_k, v_tile, nullptr);
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {  // 16 keys at a time: two 8-key accumulator tiles
      float s[2][4], dp[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        s[h][0] = s[h][1] = s[h][2] = s[h][3] = 0.f;
        dp[h][0] = dp[h][1] = dp[h][2] = dp[h][3] = 0.f;
        const __nv_bfloat16* krow = &k_tile[kk * 16 + h * 8 + gi][0];
        const __nv_bfloat16* vrow = &v_tile[kk * 16 + h * 8 + gi][0];
#pragma unroll
        for (int ds = 0; ds < D / 16; ++ds) {
          const int c = ds * 16 + 2 * t;
          mma_bf16_16816(s[h], qf[ds], *reinterpret_cast<const uint32_t*>(krow + c),
                         *reinterpret_cast<const uint32_t*>(krow + c + 8));
          mma_bf16_16816(dp[h], gf[ds], *reinterpret_cast<const uint32_t*>(vrow + c),
                         *reinterpret_cast<const uint32_t*>(vrow + c + 8));
        }
      }
      // dS = P * (dP - delta); P is exactly 0 on the ragged key tail
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = k0 + kk * 16 + h * 8 + 2 * t + (j & 1);
          const float p = key < n_k ? exp2f(s[h][j] * scale_log2 - lse_r[j >> 1]) : 0.f;
          s[h][j] = p * (dp[h][j] - delta_r[j >> 1]);
        }
      }
      uint32_t da[4];
      da[0] = pack_bf16(s[0][0], s[0][1]);
      da[1] = pack_bf16(s[0][2], s[0][3]);
      da[2] = pack_bf16(s[1][0], s[1][1]);
      da[3] = pack_bf16(s[1][2], s[1][3]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const __nv_bfloat16* krow = &kt_tile[dt * 8 + gi][kk * 16 + 2 * t];
        mma_bf16_16816(acc[dt], da, *reinterpret_cast<const uint32_t*>(krow),
                       *reinterpret_cast<const uint32_t*>(krow + 8));
      }
    }
  }

  __nv_bfloat16* ob = dq + batch * dqs.b + head * dqs.h;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (ok0) {
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row0 * dqs.t + c) =
          __floats2bfloat162_rn(acc[dt][0] * scale, acc[dt][1] * scale);
    }
    if (ok1) {
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row1 * dqs.t + c) =
          __floats2bfloat162_rn(acc[dt][2] * scale, acc[dt][3] * scale);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    heads_bwd_dkdv_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ g,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int n_q, int n_k,
                        Strides qs, Strides ks, Strides vs, Strides gs, Strides dks, Strides dvs,
                        float scale_log2, float scale) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  __shared__ __align__(16) __nv_bfloat16 q_tile[kTile][D + kPad];   // [row][d]
  __shared__ __align__(16) __nv_bfloat16 qt_tile[D][kTile + kPad];  // [d][row]
  __shared__ __align__(16) __nv_bfloat16 g_tile[kTile][D + kPad];
  __shared__ __align__(16) __nv_bfloat16 gt_tile[D][kTile + kPad];
  __shared__ float lse_s[kTile];
  __shared__ float delta_s[kTile];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gi = lane >> 2;
  const int t = lane & 3;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int key0 = blockIdx.x * kTile + warp * 16 + gi;
  const int key1 = key0 + 8;
  const bool ok0 = key0 < n_k;
  const bool ok1 = key1 < n_k;

  const __nv_bfloat16* qb = q + batch * qs.b + head * qs.h;
  const __nv_bfloat16* gb = g + batch * gs.b + head * gs.h;
  const __nv_bfloat16* kb = k + batch * ks.b + head * ks.h;
  const __nv_bfloat16* vb = v + batch * vs.b + head * vs.h;
  uint32_t kf[D / 16][4];
  uint32_t vf[D / 16][4];
  load_a_frags<D>(kf, kb + (long long)(ok0 ? key0 : 0) * ks.t, kb + (long long)(ok1 ? key1 : 0) * ks.t, ok0, ok1, t);
  load_a_frags<D>(vf, vb + (long long)(ok0 ? key0 : 0) * vs.t, vb + (long long)(ok1 ? key1 : 0) * vs.t, ok0, ok1, t);
  const long long stat = ((long long)batch * gridDim.y + head) * n_q;

  float dk_acc[D / 8][4];
  float dv_acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    dk_acc[dt][0] = dk_acc[dt][1] = dk_acc[dt][2] = dk_acc[dt][3] = 0.f;
    dv_acc[dt][0] = dv_acc[dt][1] = dv_acc[dt][2] = dv_acc[dt][3] = 0.f;
  }

  for (int i0 = 0; i0 < n_q; i0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    stage_tile<D, true>(qb, qs.t, i0, n_q, q_tile, qt_tile);
    stage_tile<D, true>(gb, gs.t, i0, n_q, g_tile, gt_tile);
    if (threadIdx.x < kTile) {
      const int row = i0 + threadIdx.x;
      // +inf for a row past n_q: its P is exp2(s - inf) = 0 exactly, so it adds nothing to dk and dv
      lse_s[threadIdx.x] = row < n_q ? lse[stat + row] : CUDART_INF_F;
      delta_s[threadIdx.x] = row < n_q ? delta[stat + row] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {  // 16 q rows at a time: two 8-row accumulator tiles
      float s[2][4], dp[2][4];  // S^T and dP^T: this warp's 16 keys x 8 q rows each
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        s[h][0] = s[h][1] = s[h][2] = s[h][3] = 0.f;
        dp[h][0] = dp[h][1] = dp[h][2] = dp[h][3] = 0.f;
        const __nv_bfloat16* qrow = &q_tile[kk * 16 + h * 8 + gi][0];
        const __nv_bfloat16* grow = &g_tile[kk * 16 + h * 8 + gi][0];
#pragma unroll
        for (int ds = 0; ds < D / 16; ++ds) {
          const int c = ds * 16 + 2 * t;
          mma_bf16_16816(s[h], kf[ds], *reinterpret_cast<const uint32_t*>(qrow + c),
                         *reinterpret_cast<const uint32_t*>(qrow + c + 8));
          mma_bf16_16816(dp[h], vf[ds], *reinterpret_cast<const uint32_t*>(grow + c),
                         *reinterpret_cast<const uint32_t*>(grow + c + 8));
        }
      }
      // P^T into s, dS^T into dp; the q row is the accumulator's column
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = kk * 16 + h * 8 + 2 * t + (j & 1);
          const float p = exp2f(s[h][j] * scale_log2 - lse_s[r]);
          s[h][j] = p;
          dp[h][j] = p * (dp[h][j] - delta_s[r]);
        }
      }
      uint32_t pa[4], da[4];
      pa[0] = pack_bf16(s[0][0], s[0][1]);
      pa[1] = pack_bf16(s[0][2], s[0][3]);
      pa[2] = pack_bf16(s[1][0], s[1][1]);
      pa[3] = pack_bf16(s[1][2], s[1][3]);
      da[0] = pack_bf16(dp[0][0], dp[0][1]);
      da[1] = pack_bf16(dp[0][2], dp[0][3]);
      da[2] = pack_bf16(dp[1][0], dp[1][1]);
      da[3] = pack_bf16(dp[1][2], dp[1][3]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const __nv_bfloat16* grow = &gt_tile[dt * 8 + gi][kk * 16 + 2 * t];
        mma_bf16_16816(dv_acc[dt], pa, *reinterpret_cast<const uint32_t*>(grow),
                       *reinterpret_cast<const uint32_t*>(grow + 8));
        const __nv_bfloat16* qrow = &qt_tile[dt * 8 + gi][kk * 16 + 2 * t];
        mma_bf16_16816(dk_acc[dt], da, *reinterpret_cast<const uint32_t*>(qrow),
                       *reinterpret_cast<const uint32_t*>(qrow + 8));
      }
    }
  }

  __nv_bfloat16* dkb = dk + batch * dks.b + head * dks.h;
  __nv_bfloat16* dvb = dv + batch * dvs.b + head * dvs.h;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (ok0) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + (long long)key0 * dks.t + c) =
          __floats2bfloat162_rn(dk_acc[dt][0] * scale, dk_acc[dt][1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + (long long)key0 * dvs.t + c) =
          __floats2bfloat162_rn(dv_acc[dt][0], dv_acc[dt][1]);
    }
    if (ok1) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + (long long)key1 * dks.t + c) =
          __floats2bfloat162_rn(dk_acc[dt][2] * scale, dk_acc[dt][3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + (long long)key1 * dvs.t + c) =
          __floats2bfloat162_rn(dv_acc[dt][2], dv_acc[dt][3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    heads_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     const float* __restrict__ g, const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dq, int n_q, int n_k, Strides qs, Strides ks, Strides vs, Strides gs,
                     Strides dqs, float scale_log2, float scale) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  __shared__ __align__(16) float k_tile[kRowsF32][D];
  __shared__ __align__(16) float v_tile[kRowsF32][D];

  const int r = threadIdx.x >> 2;
  const int c = threadIdx.x & 3;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int row = blockIdx.x * kRowsF32 + r;
  const bool ok = row < n_q;
  const long long safe_row = ok ? row : 0;

  float qr[D / 4], gr[D / 4], acc[D / 4];
  load_cols<D>(qr, q + batch * qs.b + head * qs.h + safe_row * qs.t, c, ok);
  load_cols<D>(gr, g + batch * gs.b + head * gs.h + safe_row * gs.t, c, ok);
#pragma unroll
  for (int i = 0; i < D / 4; ++i) acc[i] = 0.f;
  const long long stat = ((long long)batch * gridDim.y + head) * n_q;
  const float lse_r = ok ? lse[stat + row] : CUDART_INF_F;
  const float delta_r = ok ? delta[stat + row] : 0.f;
  const float* kb = k + batch * ks.b + head * ks.h;
  const float* vb = v + batch * vs.b + head * vs.h;

  for (int k0 = 0; k0 < n_k; k0 += kRowsF32) {
    __syncthreads();
    stage_tile_f32<D>(kb, ks.t, k0, n_k, k_tile);
    stage_tile_f32<D>(vb, vs.t, k0, n_k, v_tile);
    __syncthreads();
    const int n_valid = n_k - k0;
    for (int j = 0; j < kRowsF32; ++j) {
      float kc[D / 4], vc[D / 4];
      load_cols<D>(kc, &k_tile[j][0], c, true);
      load_cols<D>(vc, &v_tile[j][0], c, true);
      const float s = quad_sum(dot_cols<D>(qr, kc));
      const float dp = quad_sum(dot_cols<D>(gr, vc));
      const float p = j < n_valid ? exp2f(s * scale_log2 - lse_r) : 0.f;
      const float ds = p * (dp - delta_r);
#pragma unroll
      for (int i = 0; i < D / 4; ++i) acc[i] = fmaf(ds, kc[i], acc[i]);
    }
  }
  if (ok) store_cols<D>(dq + batch * dqs.b + head * dqs.h + (long long)row * dqs.t, acc, c, scale);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    heads_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                       const float* __restrict__ g, const float* __restrict__ lse,
                       const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int n_q,
                       int n_k, Strides qs, Strides ks, Strides vs, Strides gs, Strides dks, Strides dvs,
                       float scale_log2, float scale) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  __shared__ __align__(16) float q_tile[kRowsF32][D];
  __shared__ __align__(16) float g_tile[kRowsF32][D];
  __shared__ float lse_s[kRowsF32];
  __shared__ float delta_s[kRowsF32];

  const int r = threadIdx.x >> 2;
  const int c = threadIdx.x & 3;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int key = blockIdx.x * kRowsF32 + r;
  const bool ok = key < n_k;
  const long long safe_key = ok ? key : 0;

  float kr[D / 4], vr[D / 4], dk_acc[D / 4], dv_acc[D / 4];
  load_cols<D>(kr, k + batch * ks.b + head * ks.h + safe_key * ks.t, c, ok);
  load_cols<D>(vr, v + batch * vs.b + head * vs.h + safe_key * vs.t, c, ok);
#pragma unroll
  for (int i = 0; i < D / 4; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const long long stat = ((long long)batch * gridDim.y + head) * n_q;
  const float* qb = q + batch * qs.b + head * qs.h;
  const float* gb = g + batch * gs.b + head * gs.h;

  for (int i0 = 0; i0 < n_q; i0 += kRowsF32) {
    __syncthreads();
    stage_tile_f32<D>(qb, qs.t, i0, n_q, q_tile);
    stage_tile_f32<D>(gb, gs.t, i0, n_q, g_tile);
    if (threadIdx.x < kRowsF32) {
      const int row = i0 + threadIdx.x;
      // +inf for a row past n_q: its P is exactly 0, so it adds nothing to dk and dv
      lse_s[threadIdx.x] = row < n_q ? lse[stat + row] : CUDART_INF_F;
      delta_s[threadIdx.x] = row < n_q ? delta[stat + row] : 0.f;
    }
    __syncthreads();
    for (int i = 0; i < kRowsF32; ++i) {
      float qc[D / 4], gc[D / 4];
      load_cols<D>(qc, &q_tile[i][0], c, true);
      load_cols<D>(gc, &g_tile[i][0], c, true);
      const float s = quad_sum(dot_cols<D>(kr, qc));
      const float dp = quad_sum(dot_cols<D>(vr, gc));
      const float p = exp2f(s * scale_log2 - lse_s[i]);
      const float ds = p * (dp - delta_s[i]);
#pragma unroll
      for (int x = 0; x < D / 4; ++x) {
        dv_acc[x] = fmaf(p, gc[x], dv_acc[x]);
        dk_acc[x] = fmaf(ds, qc[x], dk_acc[x]);
      }
    }
  }
  if (ok) {
    store_cols<D>(dk + batch * dks.b + head * dks.h + (long long)key * dks.t, dk_acc, c, scale);
    store_cols<D>(dv + batch * dvs.b + head * dvs.h + (long long)key * dvs.t, dv_acc, c, 1.f);
  }
}

template <typename T, int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* g, const float* lse,
               float* delta, void* dq, void* dk, void* dv, int batch, int n_q, int n_k, int n_heads,
               const long long* s, float scale_log2, float scale, cudaStream_t st) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* gp = static_cast<const T*>(g);
  Strides x[8];  // q, k, v, o, g, dq, dk, dv
  for (int i = 0; i < 8; ++i) x[i] = Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kRows = kBf16 ? kTile : kRowsF32;

  const long long n_stats = (long long)batch * n_heads * n_q;
  heads_bwd_delta<T, D><<<(unsigned)((n_stats + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      gp, static_cast<const T*>(o), delta, batch, n_q, n_heads, x[4], x[3]);
  if (dk != nullptr) {
    const dim3 grid((n_k + kRows - 1) / kRows, n_heads, batch);
    if constexpr (kBf16) {
      heads_bwd_dkdv_bf16<D><<<grid, kThreads, 0, st>>>(qp, kp, vp, gp, lse, delta, static_cast<T*>(dk),
                                                        static_cast<T*>(dv), n_q, n_k, x[0], x[1], x[2], x[4],
                                                        x[6], x[7], scale_log2, scale);
    } else {
      heads_bwd_dkdv_f32<D><<<grid, kThreads, 0, st>>>(qp, kp, vp, gp, lse, delta, static_cast<T*>(dk),
                                                       static_cast<T*>(dv), n_q, n_k, x[0], x[1], x[2], x[4],
                                                       x[6], x[7], scale_log2, scale);
    }
  }
  if (dq != nullptr) {
    const dim3 grid((n_q + kRows - 1) / kRows, n_heads, batch);
    if constexpr (kBf16) {
      heads_bwd_dq_bf16<D><<<grid, kThreads, 0, st>>>(qp, kp, vp, gp, lse, delta, static_cast<T*>(dq), n_q, n_k,
                                                      x[0], x[1], x[2], x[4], x[5], scale_log2, scale);
    } else {
      heads_bwd_dq_f32<D><<<grid, kThreads, 0, st>>>(qp, kp, vp, gp, lse, delta, static_cast<T*>(dq), n_q, n_k,
                                                     x[0], x[1], x[2], x[4], x[5], scale_log2, scale);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, bound from Python with ctypes.
//   dtype: 0 = float32, 1 = bfloat16; strides are in elements, (batch, token, head) triples:
//   strides[0..23] = q, k, v, o, g, dq, dk, dv.
//   lse: (batch, n_heads, n_q) float32, the forward's row log-sum-exp in the log2 domain;
//   delta: scratch of the same shape, filled here.
//   dq may be null (dq is not computed); dk and dv may both be null (neither is computed).
// Returns cudaGetLastError() after the launches, or -1 for an unsupported
// dtype/head_dim combination (the Python wrapper checks before calling).
extern "C" int cinema_flash_attention_heads_bwd(const void* q, const void* k, const void* v, const void* o,
                                                const void* g, const void* lse, void* delta, void* dq, void* dk,
                                                void* dv, int dtype, int batch, int n_q, int n_k, int n_heads,
                                                int head_dim, const long long* strides, float scale_log2,
                                                float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_q <= 0 || n_k <= 0 || batch <= 0 || n_heads <= 0) return -1;
  if ((dk == nullptr) != (dv == nullptr)) return -1;
  const float* lp = static_cast<const float*>(lse);
  float* dp = static_cast<float*>(delta);
  if (dtype == 1 && head_dim == 64) {
    return launch_bwd<__nv_bfloat16, 64>(q, k, v, o, g, lp, dp, dq, dk, dv, batch, n_q, n_k, n_heads, strides,
                                         scale_log2, scale, st);
  }
  if (dtype == 1 && head_dim == 32) {
    return launch_bwd<__nv_bfloat16, 32>(q, k, v, o, g, lp, dp, dq, dk, dv, batch, n_q, n_k, n_heads, strides,
                                         scale_log2, scale, st);
  }
  if (dtype == 0 && head_dim == 64) {
    return launch_bwd<float, 64>(q, k, v, o, g, lp, dp, dq, dk, dv, batch, n_q, n_k, n_heads, strides,
                                 scale_log2, scale, st);
  }
  if (dtype == 0 && head_dim == 32) {
    return launch_bwd<float, 32>(q, k, v, o, g, lp, dp, dq, dk, dv, batch, n_q, n_k, n_heads, strides,
                                 scale_log2, scale, st);
  }
  return -1;
}
