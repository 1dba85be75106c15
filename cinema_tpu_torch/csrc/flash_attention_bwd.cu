// Flash-attention backward for Hopper (sm_90a), packed and per-head layouts in one implementation.
//
// Replaces two kernels of cinema_tpu/ops/pallas/flash_attention.py: `_bwd`
// (kernel `_flash_bwd_kernel`, per-head (batch, tokens, heads, head_dim)
// operands) and `_packed_bwd_rule` (kernel `_packed_bwd_kernel`, packed
// (batch, tokens, embed) operands with the heads split inside the kernel).
// The packed layout is the per-head one with head stride head_dim, so both
// C entry points hand (batch, token, head) element strides to the same
// kernels. Given q, k, v, the forward's output o, the output gradient g and
// the forward's row log-sum-exp, per (batch, head):
//
//   P  = softmax(q k^T / sqrt(d))          recomputed from the saved row log-sum-exp
//   dP = g v^T,  delta = rowsum(g * o),  dS = P * (dP - delta)
//   dq = dS k / sqrt(d),  dk = dS^T q / sqrt(d),  dv = P^T g
//
// Every operand and gradient has its own strides, so v may be the strided v
// half of a fused kv projection and dv is written into the v half of a buffer
// shaped like it; (batch, heads, tokens, head_dim) transposes are read in place.
//
// Design. The TPU kernel walks the q blocks in grid order and adds into one
// dk/dv block that stays resident over the sequential grid axis. Blocks here
// run in parallel and in no order, so the backward is three launches with no
// atomics: every output element is written once, and gradients are bit-equal
// from run to run, at the price of computing S and dP in both passes (14
// products' worth against the bound's 10):
//
// 1. delta: one thread per (batch, head, row) sums g * o and copies the row's
//    log-sum-exp; both go to scratch padded to whole 128-row tiles, the pad
//    rows holding delta = 0 and lse = +inf (P = exp2(s - inf) = 0 exactly);
// 2. dk/dv: one block per (128-key tile, head, batch), two warpgroups of 64
//    keys each. The k and v tiles are copied once and each warpgroup keeps its
//    rows in registers as wgmma A fragments; q, g, lse and delta of each 64-row
//    stage stream through a ring of kStages slots in shared memory. Per stage
//    each warpgroup runs S^T = k q^T and dP^T = v g^T on wgmma (q and g read
//    K-major from shared memory), forms P^T and dS^T in registers, re-packs
//    them from the accumulator layout as wgmma A fragments and runs dv += P^T g and
//    dk += dS^T q with g and q read through the transposed (MN-major) B
//    descriptor: no tile is ever transposed in shared memory;
// 3. dq: one block per (128-row q tile, head, batch), mirrored: q and g
//    resident (read by wgmma from shared memory), k and v streamed,
//    S = q k^T, dP = g v^T, dq += dS k (k MN-major).
//    Keys past n_k get P = 0 on the last stage.
//
// Copies are cp.async (16 bytes a thread, zero-filled past the tokens' end)
// into the 128-byte (head_dim 64) or 64-byte (head_dim 32) swizzle that the
// wgmma descriptors name; every thread copies its share of the stage kAhead
// stages ahead of the one it multiplies. The ring is synchronised with
// mbarriers, not block-wide barriers: a slot's "full" barrier completes when
// every thread's copies into it have landed (cp.async.mbarrier.arrive), its
// "empty" barrier when every warp is done reading it, so the two warpgroups
// drift out of step and one's products overlap the other's softmax. The
// block has no producer warp: 256 threads leave each thread 255 registers,
// and a dk/dv thread holds four 64 x 64 f32 accumulators (128 registers) and
// the k and v fragments (32). TMA is not used: cp.async needs no tensor map
// (no cuTensorMapEncodeTiled, so no libcuda link for a library with a plain C
// interface) and zero-fills each operand's ragged token tail by the row,
// whatever its strides.
//
// bf16 products accumulate in f32; P and dS are rounded to bf16 before their
// second product, as the forward rounds P.
//
// Bound at the fine-tuning shape of ConvViT-base (B=4, Tq=Tk=2305, H=12, D=64,
// bf16): five products, 10*B*Tq*Tk*H*D = 1.6e11 flop -> 0.165 ms at 989
// TFLOP/s, against 0.034 ms for the bytes (q, k, v, o, g read and dq, dk, dv
// written once at 3.35 TB/s): bounded by tensor-core operations.
//
// f32 operands run on the tensor cores in split TF32, as the f32 forward does
// (tf32.cuh): each operand x is split into a TF32 hi (rounded by hand) and the
// f32 remainder lo, each product is a_lo b_hi + a_hi b_lo + a_hi b_hi, and the
// tensor core sums only kBwdStepsPerSum k-steps from zero before the CUDA cores
// add that sum to the running one (it rounds its sums toward zero). Bound at
// (4, 2305^2, 768): 3 * 10*B*Tq*Tk*E = 4.9e11 flop -> 0.99 ms at 495 TFLOP/s
// dense TF32, against 0.068 ms for the bytes (the CUDA cores' 67 TFLOP/s would
// take 2.44 ms for the single f32 pass). They run in the f32 check steps and in
// any f32 fine-tune (the float32 evaluation runs the f32 forward alone).
// TF32 wgmma reads only K-major operands from shared memory, and dv += P^T g,
// dk += dS^T q and dq += dS k would need g, q and k transposed there, so the
// products run on mma.sync.m16n8k8, whose operands all come from registers.
// The passes keep the bf16 ones' shape: a block of 128 keys (dk/dv) or q rows
// (dq) of one (batch, head) is eight warps of 16 rows (256 threads), one block
// an SM. The resident operands (k and v, or q and g) are read once into
// registers as A fragments, k or q scaled into the log2 domain, and split at
// each use. The streamed ones arrive in 64-row cp.async stages through
// hopper.cuh's mbarrier ring and are split where their B fragments are read,
// as the f32 forward splits k and v. Per stage a warp forms S^T = k q^T and
// dP^T = v g^T (or S = q k^T and dP = g v^T), P and dS in registers, and adds
// P^T g and dS^T q (or dS k) from the same tiles, P and dS being A fragments
// as they stand: a depth is a sum, so k-step kk takes rows 8kk + 2t and + 1 as
// its columns t and t + 4, the thread's own entries. A pitch of D + 4 floats keeps
// both ways of reading a tile free of bank conflicts (F32Tile). ~138 KB of
// shared memory at head_dim 64 (four slots of two tiles, lse and delta) and
// 255 registers: the dk/dv pass spills (ptxas, PERF.md section 6).

#include "hopper.cuh"
#include "tf32.cuh"

namespace {

// The A fragments of this thread's rows of a warpgroup's 64-row slice of a swizzled tile (the left
// operand of products whose depth is D), read once: warp w holds rows 16w + g and 16w + g + 8.
template <int D>
__device__ __forceinline__ void a_frags_from_tile(uint32_t (&f)[D / 16][4], const uint8_t* slice, int warp, int gi,
                                                  int t) {
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = warp * 16 + gi + (i & 1) * 8;
      const int c = 16 * kd + 2 * t + (i >> 1) * 8;
      f[kd][i] = *reinterpret_cast<const uint32_t*>(slice + TileLayout<D>::offset(r, c / 8) + (c % 8) * 2);
    }
  }
}

// ---------------------------------------------------------------------------
// 16 bytes of g times 16 bytes of o, summed in f32
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

// 1. delta = rowsum(g * o) and the row log-sum-exp, both padded to n_pad rows per (batch, head)
//    (n_pad: n_q rounded up to whole kBlockRows tiles): pad rows get delta 0 and lse +inf.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_delta(const T* __restrict__ g, const T* __restrict__ o, const float* __restrict__ lse,
                    float* __restrict__ lse_pad, float* __restrict__ delta_pad, int batch, int n_q, int n_pad,
                    int n_heads, Strides gs, Strides os) {
  constexpr int kVec = 16 / sizeof(T);
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (long long)batch * n_heads * n_pad) return;
  const int row = idx % n_pad;
  const int head = (idx / n_pad) % n_heads;
  const int b = idx / ((long long)n_pad * n_heads);
  if (row >= n_q) {
    lse_pad[idx] = CUDART_INF_F;
    delta_pad[idx] = 0.f;
    return;
  }
  const T* gr = g + b * gs.b + row * gs.t + head * gs.h;
  const T* orow = o + b * os.b + row * os.t + head * os.h;
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < D; d += kVec) acc += dot_vec(gr + d, orow + d);
  lse_pad[idx] = lse[((long long)b * n_heads + head) * n_q + row];
  delta_pad[idx] = acc;
}

// Shared memory of the two bf16 passes, from a 1024-byte aligned base: 2 * kStages streamed 64-row
// tiles (two operands a stage), four resident ones (two operands of kBlockRows rows), the dk/dv
// pass's lse and delta per stage, and the ring's barriers.
template <int D>
struct Smem {
  static constexpr int kTile = kStageRows * TileLayout<D>::kPitch;
  static constexpr int kResident = 2 * kStages * kTile;        // first resident tile
  static constexpr int kStats = kResident + 4 * kTile;          // kStages x (lse, delta) of 64 floats
  static constexpr int kBars = kStats + kStages * 2 * kStageRows * 4;
  static constexpr int kBytes = kBars + 2 * kStages * 8 + 1024;  // + slack to align the base
};

// ---------------------------------------------------------------------------
// 2. dk, dv: one block per (kBlockRows keys, head, batch), warpgroup wg owning keys wg * 64 .. + 63.
//    k and v are copied once and kept as wgmma A fragments; q, g, lse and delta stream through the ring.
template <int D>
__global__ void __launch_bounds__(kBlockThreads, 1)
    flash_bwd_dkdv(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ g,
                   const float* __restrict__ lse_pad, const float* __restrict__ delta_pad,
                   __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int n_q, int n_k, int n_pad,
                   Strides qs, Strides ks, Strides vs, Strides gs, Strides dks, Strides dvs, float scale_log2,
                   float scale) {
  using L = TileLayout<D>;
  using S = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = aligned_smem_base(smem_raw);
  uint8_t* base_ptr = smem_raw + (base - smem_addr(smem_raw));
  float* stats = reinterpret_cast<float*>(base_ptr + S::kStats);
  const Ring ring(base_ptr + S::kBars);

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int gi = lane / 4;
  const int t = lane % 4;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int key_base = blockIdx.x * kBlockRows;
  const __nv_bfloat16* qb = q + batch * qs.b + head * qs.h;
  const __nv_bfloat16* gb = g + batch * gs.b + head * gs.h;
  const __nv_bfloat16* kb = k + batch * ks.b + head * ks.h;
  const __nv_bfloat16* vb = v + batch * vs.b + head * vs.h;
  const long long stat = ((long long)batch * gridDim.y + head) * n_pad;
  const int n_iters = (n_q + kStageRows - 1) / kStageRows;

  auto load_stage = [&](int it) {  // this thread's share of stage it
    if (it >= n_iters) return;
    ring.wait_free(it);
    const int dst = it % kStages;
    load_tile<D, kStageRows>(base + (2 * dst) * S::kTile, qb, qs.t, it * kStageRows, n_q);
    load_tile<D, kStageRows>(base + (2 * dst + 1) * S::kTile, gb, gs.t, it * kStageRows, n_q);
    if (threadIdx.x < 32) {  // 64 lse + 64 delta: 32 chunks of 16 bytes, rows padded so never past the end
      const float* src = (threadIdx.x < 16 ? lse_pad : delta_pad) + stat + it * kStageRows + (threadIdx.x % 16) * 4;
      cp_async_16(smem_addr(stats + dst * 2 * kStageRows + threadIdx.x * 4), src, true);
    }
    ring.copied(it);
  };

  load_tile<D, kBlockRows>(base + S::kResident, kb, ks.t, key_base, n_k);
  load_tile<D, kBlockRows>(base + S::kResident + 2 * S::kTile, vb, vs.t, key_base, n_k);
  for (int it = 0; it < kAhead; ++it) load_stage(it);  // stage 0's arrival also covers k and v
  const bool active = key_base + wg * kStageRows < n_k;
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  // this warpgroup's k and v rows stay in registers as the A operand of S^T and dP^T
  uint32_t kf[D / 16][4], vf[D / 16][4];
  ring.wait_full(0);
  a_frags_from_tile<D>(kf, base_ptr + S::kResident + wg * S::kTile, warp, gi, t);
  a_frags_from_tile<D>(vf, base_ptr + S::kResident + (2 + wg) * S::kTile, warp, gi, t);

  for (int it = 0; it < n_iters; ++it) {
    load_stage(it + kAhead);
    const int slot = it % kStages;
    ring.wait_full(it);
    if (active) {  // a tail block's warpgroup with no key only copies and releases
      const uint32_t q_st = base + (2 * slot) * S::kTile;
      const uint32_t g_st = q_st + S::kTile;

      // S^T and dP^T (64 keys x 64 q rows of this warpgroup) as two groups, so that P^T is formed
      // while dP^T runs and dS^T while dv's product runs
      float s[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) mma_rs<64, 0>(s, kf[kd], desc_k_major<D>(q_st + kd * 32), kd);
      wgmma_commit();
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) mma_rs<64, 0>(dp, vf[kd], desc_k_major<D>(g_st + kd * 32), kd);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);

      // P^T into s; the q row is the accumulator's column
      const float* lse_s = stats + slot * 2 * kStageRows;
      const float* delta_s = lse_s + kStageRows;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t);
#pragma unroll
        for (int i = 4 * j; i < 4 * j + 4; ++i) s[i] = exp2_ftz(s[i] * scale_log2 - (i & 1 ? l2.y : l2.x));
      }
      uint32_t pa[4][4];
      pack_a(pa, s);
      fence_regs(dv_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // 16 q rows of the stage per step
        mma_rs<D, 1>(dv_acc, pa[kk], desc_mn_major<D>(g_st + kk * 16 * L::kPitch));
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(dp);

      // dS^T into dp
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 d2 = *reinterpret_cast<const float2*>(delta_s + 8 * j + 2 * t);
#pragma unroll
        for (int i = 4 * j; i < 4 * j + 4; ++i) dp[i] = s[i] * (dp[i] - (i & 1 ? d2.y : d2.x));
      }
      uint32_t da[4][4];
      pack_a(da, dp);
      fence_regs(dk_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) mma_rs<D, 1>(dk_acc, da[kk], desc_mn_major<D>(q_st + kk * 16 * L::kPitch));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
    }
    ring.release(it);
  }
  cp_async_wait_all();

  const int key = key_base + wg * 64 + warp * 16 + gi;
  __nv_bfloat16* dkb = dk + batch * dks.b + head * dks.h;
  __nv_bfloat16* dvb = dv + batch * dvs.b + head * dvs.h;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key + 8 * h >= n_k) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = 8 * j + 2 * t;
      const int i = 4 * j + 2 * h;
      *reinterpret_cast<__nv_bfloat162*>(dkb + (long long)(key + 8 * h) * dks.t + c) =
          __floats2bfloat162_rn(dk_acc[i] * scale, dk_acc[i + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + (long long)(key + 8 * h) * dvs.t + c) =
          __floats2bfloat162_rn(dv_acc[i], dv_acc[i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dq: one block per (kBlockRows q rows, head, batch), warpgroup wg owning rows wg * 64 .. + 63.
//    q and g are copied once; k and v stream through the ring.
template <int D>
__global__ void __launch_bounds__(kBlockThreads, 1)
    flash_bwd_dq(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ g,
                 const float* __restrict__ lse_pad, const float* __restrict__ delta_pad,
                 __nv_bfloat16* __restrict__ dq, int n_q, int n_k, int n_pad, Strides qs, Strides ks, Strides vs,
                 Strides gs, Strides dqs, float scale_log2, float scale) {
  using L = TileLayout<D>;
  using S = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = aligned_smem_base(smem_raw);
  uint8_t* base_ptr = smem_raw + (base - smem_addr(smem_raw));
  const Ring ring(base_ptr + S::kBars);

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int gi = lane / 4;
  const int t = lane % 4;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int row_base = blockIdx.x * kBlockRows;
  const __nv_bfloat16* qb = q + batch * qs.b + head * qs.h;
  const __nv_bfloat16* gb = g + batch * gs.b + head * gs.h;
  const __nv_bfloat16* kb = k + batch * ks.b + head * ks.h;
  const __nv_bfloat16* vb = v + batch * vs.b + head * vs.h;
  const int n_iters = (n_k + kStageRows - 1) / kStageRows;

  auto load_stage = [&](int it) {  // this thread's share of stage it
    if (it >= n_iters) return;
    ring.wait_free(it);
    const int dst = it % kStages;
    load_tile<D, kStageRows>(base + (2 * dst) * S::kTile, kb, ks.t, it * kStageRows, n_k);
    load_tile<D, kStageRows>(base + (2 * dst + 1) * S::kTile, vb, vs.t, it * kStageRows, n_k);
    ring.copied(it);
  };

  load_tile<D, kBlockRows>(base + S::kResident, qb, qs.t, row_base, n_q);
  load_tile<D, kBlockRows>(base + S::kResident + 2 * S::kTile, gb, gs.t, row_base, n_q);
  for (int it = 0; it < kAhead; ++it) load_stage(it);  // stage 0's arrival also covers q and g

  // this thread's accumulator rows: row and row + 8 (padded statistics: never past the end)
  const int row = row_base + wg * 64 + warp * 16 + gi;
  const long long stat = ((long long)batch * gridDim.y + head) * n_pad + row;
  const float lse_r[2] = {lse_pad[stat], lse_pad[stat + 8]};
  const float delta_r[2] = {delta_pad[stat], delta_pad[stat + 8]};
  const bool active = row_base + wg * kStageRows < n_q;
  float dq_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
  // this warpgroup's q and g rows: the A operand of S and dP, read from shared memory (held in
  // registers as in the dk/dv pass, they gave wrong dq at head_dim 64 once both warpgroups had rows)
  const uint32_t q_rows = base + S::kResident + wg * S::kTile;
  const uint32_t g_rows = q_rows + 2 * S::kTile;

  for (int it = 0; it < n_iters; ++it) {
    load_stage(it + kAhead);
    const int slot = it % kStages;
    ring.wait_full(it);
    if (active) {  // a tail block's warpgroup with no row only copies and releases
      const uint32_t k_st = base + (2 * slot) * S::kTile;
      const uint32_t v_st = k_st + S::kTile;

      // S and dP (64 q rows x 64 keys of this warpgroup) as two groups: P is formed while dP runs
      float s[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        mma_ss_n64(s, desc_k_major<D>(q_rows + kd * 32), desc_k_major<D>(k_st + kd * 32), kd);
      }
      wgmma_commit();
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        mma_ss_n64(dp, desc_k_major<D>(g_rows + kd * 32), desc_k_major<D>(v_st + kd * 32), kd);
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);

      // P into s; keys past n_k (zero rows of k and v) only on the last stage
      const int k0 = it * kStageRows;
      const bool ragged = k0 + kStageRows > n_k;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
        float p = exp2_ftz(s[i] * scale_log2 - lse_r[(i >> 1) & 1]);
        if (ragged) p = key < n_k ? p : 0.f;
        s[i] = p;
      }
      wgmma_wait<0>();
      fence_regs(dp);
      // dS = P * (dP - delta) into s
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = s[i] * (dp[i] - delta_r[(i >> 1) & 1]);
      uint32_t da[4][4];
      pack_a(da, s);
      fence_regs(dq_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) mma_rs<D, 1>(dq_acc, da[kk], desc_mn_major<D>(k_st + kk * 16 * L::kPitch));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq_acc);
    }
    ring.release(it);
  }
  cp_async_wait_all();

  __nv_bfloat16* ob = dq + batch * dqs.b + head * dqs.h;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row + 8 * h >= n_q) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int i = 4 * j + 2 * h;
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)(row + 8 * h) * dqs.t + 8 * j + 2 * t) =
          __floats2bfloat162_rn(dq_acc[i] * scale, dq_acc[i + 1] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// f32 operands on the tensor cores in split TF32 (tf32.cuh): eight warps of 16 rows a block, mma.sync m16n8k8
// products of hi and lo parts.

// k-steps (of 8) whose products the tensor core sums from zero before the CUDA cores add that sum to the running
// one, for the reason of the forward's kStepsPerSum (tf32.cuh): dk, dv and dq add a product over every q row or
// key of the panel, and no running sum may sit in the tensor core's accumulator over it. 8 is one 64-row stage
// (and all of head_dim for S and dP): it biased the gradients toward zero by 1.3e-6 of their size (4: 5.4e-7;
// the f32 MAE step stayed at 1.1e-5 of a parameter's largest, against a gate of 1e-3) and took 12 % less time
// than 4 at (4, 2305^2): tools/torch_f32_sums.py measures each setting (PERF.md section 6).
constexpr int kBwdStepsPerSum = 8;
static_assert(kBwdStepsPerSum <= 8 && 8 % kBwdStepsPerSum == 0, "whole sums of k-steps in a stage");

// A streamed f32 tile: kStageRows rows of D floats, read in two patterns: the B fragments of S^T = k q^T,
// dP^T = v g^T, S = q k^T and dP = g v^T at (row 8j + g, columns 8kk + t and 8kk + t + 4), and those of
// dv += P^T g, dk += dS^T q and dq += dS k at (rows 8kk + 2t and + 1, column 8jd + g). A pitch of D + 4 floats puts
// a warp's 32 reads of either pattern in 32 banks, and every address is a constant from one register.
template <int D>
struct F32Tile {
  static constexpr int kPitch = D + 4;  // floats a row
  static constexpr int kBytes = kStageRows * kPitch * 4;
};

// Shared memory of the two f32 passes, from a 1024-byte aligned base: kStages ring slots of two streamed
// tiles (q and g, or k and v) and, for the dk/dv pass, the stage's 64 lse and 64 delta; then the ring's barriers.
template <int D>
struct BwdF32Smem {
  static constexpr int kTile = F32Tile<D>::kBytes;
  static constexpr int kStats = 2 * kTile;  // in a slot
  static constexpr int kSlot = kStats + 2 * kStageRows * 4;
  static constexpr int kBars = kStages * kSlot;
  static constexpr int kBytes = kBars + 2 * kStages * 8 + 1024;  // + slack to align the base
  static_assert(kBytes <= 232448, "more shared memory than a block can have");
};

// Copy rows [row0, row0 + kStageRows) of one (batch, head)'s D f32 columns into a tile; rows from n_rows on are
// zero. Every thread of the block takes its share.
template <int D>
__device__ __forceinline__ void load_f32_tile(uint32_t tile, const float* __restrict__ base, long long row_stride,
                                              int row0, int n_rows) {
  constexpr int kChunks = D / 4;
  static_assert(kStageRows * kChunks % kBlockThreads == 0, "whole copies per thread");
#pragma unroll
  for (int i = 0; i < kStageRows * kChunks / kBlockThreads; ++i) {
    const int idx = threadIdx.x + i * kBlockThreads;
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    const bool valid = row0 + r < n_rows;
    const float* src = base + (valid ? (long long)(row0 + r) * row_stride + c * 4 : 0);
    cp_async_16(tile + (r * F32Tile<D>::kPitch + c * 4) * 4, src, valid);
  }
}

// The hi and lo parts of element (r, c) of a stage tile, as the tensor core reads them
template <int D>
__device__ __forceinline__ void tile_split(const float* tile, int r, int c, uint32_t& hi, uint32_t& lo) {
  split_tf32(tile[r * F32Tile<D>::kPitch + c], hi, lo);
}

// This thread's A fragments of rows row and row + 8 (zero from n_rows on) of one (batch, head)'s D f32 columns,
// times `scale`, read once from device memory. The depth (head_dim) is a sum, so its order is free: k-step kk
// takes columns 8kk + t and 8kk + t + 4 as its columns t and t + 4, as the tiles' B fragments are read.
template <int D>
__device__ __forceinline__ void a_frags_f32(float (&f)[D / 8][4], const float* __restrict__ base,
                                            long long row_stride, int row, int n_rows, int t, float scale) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool ok = row + 8 * h < n_rows;
    const float* p = base + (long long)(ok ? row + 8 * h : 0) * row_stride + t;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      f[kk][h] = ok ? p[8 * kk] * scale : 0.f;
      f[kk][2 + h] = ok ? p[8 * kk + 4] * scale : 0.f;
    }
  }
}

// The two products below step through their depth k-step by k-step and, inside a k-step, through the output's
// 8-column blocks: consecutive mma.sync go to different accumulators, so a warp keeps several in flight, and
// each k-step's A fragments are split once for all of them. The tensor core sums kSteps k-steps from zero in
// `part`; the CUDA cores add `part` to the running sums.

// s = a b^T over the D columns, for this warp's 16 rows and the 64 rows of a stage tile b: s[4j + 2h + e] is
// the warp's row g + 8h against tile row 8j + 2t + e. a: this thread's A fragments (a_frags_f32), split here.
template <int D>
__device__ __forceinline__ void product_rows(float (&s)[32], const float (&a)[D / 8][4], const float* tile, int gi,
                                             int t) {
  constexpr int kSteps = kBwdStepsPerSum < D / 8 ? kBwdStepsPerSum : D / 8;
#pragma unroll
  for (int k0 = 0; k0 < D / 8; k0 += kSteps) {
    float part[8][4];
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const int kk = k0 + u;
      uint32_t a_hi[4], a_lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(a[kk][i], a_hi[i], a_lo[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t b_hi[2], b_lo[2];
        tile_split<D>(tile, 8 * j + gi, 8 * kk + t, b_hi[0], b_lo[0]);
        tile_split<D>(tile, 8 * j + gi, 8 * kk + t + 4, b_hi[1], b_lo[1]);
        float* d = k0 == 0 ? &s[4 * j] : part[j];  // the first sum is the running one
        if (u == 0) {
          mma_tf32x3<true>(d, a_hi, a_lo, b_hi, b_lo);
        } else {
          mma_tf32x3<false>(d, a_hi, a_lo, b_hi, b_lo);
        }
      }
    }
    if (k0 > 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[4 * j + i] += part[j][i];
      }
    }
  }
}

// acc += p b over the 64 rows of a stage tile b, for this warp's 16 rows and the D columns: acc[4jd + 2h + e] is
// the warp's row g + 8h, column 8jd + 2t + e. p: this thread's entries of a product_rows result as A fragments
// (the tile rows are the depth, and k-step kk takes rows 8kk + 2t and + 1 as its columns t and t + 4, so these
// are the thread's own entries: no shuffle); b's B fragments are read at (rows 8kk + 2t and + 1, column 8jd + g)
// of the (rows, D) tile as it landed: no tile is transposed.
template <int D>
__device__ __forceinline__ void product_cols(float (&acc)[D / 2], const float (&p)[32], const float* tile, int gi,
                                             int t) {
#pragma unroll
  for (int k0 = 0; k0 < 8; k0 += kBwdStepsPerSum) {
    float part[D / 8][4];
#pragma unroll
    for (int u = 0; u < kBwdStepsPerSum; ++u) {
      const int kk = k0 + u;
      uint32_t p_hi[4], p_lo[4];
      split_tf32(p[4 * kk], p_hi[0], p_lo[0]);
      split_tf32(p[4 * kk + 2], p_hi[1], p_lo[1]);
      split_tf32(p[4 * kk + 1], p_hi[2], p_lo[2]);
      split_tf32(p[4 * kk + 3], p_hi[3], p_lo[3]);
#pragma unroll
      for (int jd = 0; jd < D / 8; ++jd) {
        uint32_t b_hi[2], b_lo[2];
        tile_split<D>(tile, 8 * kk + 2 * t, 8 * jd + gi, b_hi[0], b_lo[0]);
        tile_split<D>(tile, 8 * kk + 2 * t + 1, 8 * jd + gi, b_hi[1], b_lo[1]);
        if (u == 0) {
          mma_tf32x3<true>(part[jd], p_hi, p_lo, b_hi, b_lo);
        } else {
          mma_tf32x3<false>(part[jd], p_hi, p_lo, b_hi, b_lo);
        }
      }
    }
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[4 * jd + i] += part[jd][i];
    }
  }
}

// 2. dk, dv: one block per (kBlockRows keys, head, batch), warp w owning keys w * 16 .. + 15. k (scaled into the
//    log2 domain) and v stay in registers as A fragments; q, g, lse and delta stream through the ring.
template <int D>
__global__ void __launch_bounds__(kBlockThreads, 1)
    flash_bwd_dkdv_tf32x3(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                          const float* __restrict__ g, const float* __restrict__ lse_pad,
                          const float* __restrict__ delta_pad, float* __restrict__ dk, float* __restrict__ dv,
                          int n_q, int n_k, int n_pad, Strides qs, Strides ks, Strides vs, Strides gs, Strides dks,
                          Strides dvs, float scale_log2, float scale) {
  using S = BwdF32Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = aligned_smem_base(smem_raw);
  uint8_t* base_ptr = smem_raw + (base - smem_addr(smem_raw));
  const Ring ring(base_ptr + S::kBars);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gi = lane / 4;
  const int t = lane % 4;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int key0 = (int)blockIdx.x * kBlockRows + warp * 16;  // this warp's first key
  const int key = key0 + gi;                                   // this thread's keys: key and key + 8
  const float* qb = q + batch * qs.b + head * qs.h;
  const float* gb = g + batch * gs.b + head * gs.h;
  const long long stat = ((long long)batch * gridDim.y + head) * n_pad;
  const int n_iters = (n_q - 1) / kStageRows + 1;  // n_q >= 1

  auto load_stage = [&](int it) {  // this thread's share of stage it
    if (it >= n_iters) return;
    ring.wait_free(it);
    const uint32_t dst = base + (it % kStages) * S::kSlot;
    load_f32_tile<D>(dst, qb, qs.t, it * kStageRows, n_q);
    load_f32_tile<D>(dst + S::kTile, gb, gs.t, it * kStageRows, n_q);
    if (threadIdx.x < 32) {  // 64 lse + 64 delta: 32 chunks of 16 bytes, rows padded so never past the end
      const float* src = (threadIdx.x < 16 ? lse_pad : delta_pad) + stat + it * kStageRows + (threadIdx.x % 16) * 4;
      cp_async_16(dst + S::kStats + threadIdx.x * 16, src, true);
    }
    ring.copied(it);
  };
  for (int it = 0; it < kAhead; ++it) load_stage(it);

  const bool active = key0 < n_k;  // a warp with no key only copies and releases
  float kf[D / 8][4], vf[D / 8][4];
  a_frags_f32<D>(kf, k + batch * ks.b + head * ks.h, ks.t, key, n_k, t, scale_log2);
  a_frags_f32<D>(vf, v + batch * vs.b + head * vs.h, vs.t, key, n_k, t, 1.f);
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int it = 0; it < n_iters; ++it) {
    load_stage(it + kAhead);
    const uint8_t* slot = base_ptr + (it % kStages) * S::kSlot;
    ring.wait_full(it);
    if (active) {
      const float* q_st = reinterpret_cast<const float*>(slot);
      const float* g_st = reinterpret_cast<const float*>(slot + S::kTile);
      const float* lse_s = reinterpret_cast<const float*>(slot + S::kStats);
      const float* delta_s = lse_s + kStageRows;

      // P^T = exp2(S^T - lse), the q row being the accumulator's column. Rows past n_q have lse +inf (P = 0) and
      // delta 0, with q and g zero-filled, so they add nothing.
      float s[32], dp[32];
      product_rows<D>(s, kf, q_st, gi, t);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t);
#pragma unroll
        for (int i = 4 * j; i < 4 * j + 4; ++i) s[i] = exp2_ftz(s[i] - (i & 1 ? l2.y : l2.x));
      }
      // dS^T = P^T (dP^T - delta) into dp
      product_rows<D>(dp, vf, g_st, gi, t);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 d2 = *reinterpret_cast<const float2*>(delta_s + 8 * j + 2 * t);
#pragma unroll
        for (int i = 4 * j; i < 4 * j + 4; ++i) dp[i] = (dp[i] - (i & 1 ? d2.y : d2.x)) * s[i];
      }
      product_cols<D>(dv_acc, s, g_st, gi, t);
      product_cols<D>(dk_acc, dp, q_st, gi, t);
    }
    ring.release(it);
  }
  cp_async_wait_all();

  float* dkb = dk + batch * dks.b + head * dks.h;
  float* dvb = dv + batch * dvs.b + head * dvs.h;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key + 8 * h >= n_k) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = 8 * j + 2 * t;
      const int i = 4 * j + 2 * h;
      *reinterpret_cast<float2*>(dkb + (long long)(key + 8 * h) * dks.t + c) =
          make_float2(dk_acc[i] * scale, dk_acc[i + 1] * scale);
      *reinterpret_cast<float2*>(dvb + (long long)(key + 8 * h) * dvs.t + c) = make_float2(dv_acc[i], dv_acc[i + 1]);
    }
  }
}

// 3. dq: one block per (kBlockRows q rows, head, batch), warp w owning rows w * 16 .. + 15, mirrored: q (scaled
//    into the log2 domain) and g stay in registers as A fragments; k and v stream through the ring.
template <int D>
__global__ void __launch_bounds__(kBlockThreads, 1)
    flash_bwd_dq_tf32x3(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                        const float* __restrict__ g, const float* __restrict__ lse_pad,
                        const float* __restrict__ delta_pad, float* __restrict__ dq, int n_q, int n_k, int n_pad,
                        Strides qs, Strides ks, Strides vs, Strides gs, Strides dqs, float scale_log2, float scale) {
  using S = BwdF32Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = aligned_smem_base(smem_raw);
  uint8_t* base_ptr = smem_raw + (base - smem_addr(smem_raw));
  const Ring ring(base_ptr + S::kBars);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gi = lane / 4;
  const int t = lane % 4;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int row0 = (int)blockIdx.x * kBlockRows + warp * 16;  // this warp's first row
  const int row = row0 + gi;                                   // this thread's rows: row and row + 8
  const float* kb = k + batch * ks.b + head * ks.h;
  const float* vb = v + batch * vs.b + head * vs.h;
  const int n_iters = (n_k - 1) / kStageRows + 1;  // n_k >= 1

  auto load_stage = [&](int it) {  // this thread's share of stage it
    if (it >= n_iters) return;
    ring.wait_free(it);
    const uint32_t dst = base + (it % kStages) * S::kSlot;
    load_f32_tile<D>(dst, kb, ks.t, it * kStageRows, n_k);
    load_f32_tile<D>(dst + S::kTile, vb, vs.t, it * kStageRows, n_k);
    ring.copied(it);
  };
  for (int it = 0; it < kAhead; ++it) load_stage(it);

  const bool active = row0 < n_q;  // a warp with no row only copies and releases
  float qf[D / 8][4], gf[D / 8][4];
  a_frags_f32<D>(qf, q + batch * qs.b + head * qs.h, qs.t, row, n_q, t, scale_log2);
  a_frags_f32<D>(gf, g + batch * gs.b + head * gs.h, gs.t, row, n_q, t, 1.f);
  // rows row and row + 8 (padded statistics: never past the end; a row past n_q has lse +inf and delta 0)
  const long long stat = ((long long)batch * gridDim.y + head) * n_pad + row;
  const float lse_r[2] = {lse_pad[stat], lse_pad[stat + 8]};
  const float delta_r[2] = {delta_pad[stat], delta_pad[stat + 8]};
  float dq_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;

  for (int it = 0; it < n_iters; ++it) {
    load_stage(it + kAhead);
    const uint8_t* slot = base_ptr + (it % kStages) * S::kSlot;
    ring.wait_full(it);
    if (active) {
      const float* k_st = reinterpret_cast<const float*>(slot);
      const float* v_st = reinterpret_cast<const float*>(slot + S::kTile);

      // P = exp2(S - lse); keys past n_k (zero rows of k and v) only on the last stage
      float s[32], dp[32];
      product_rows<D>(s, qf, k_st, gi, t);
      const bool ragged = (it + 1) * kStageRows > n_k;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = it * kStageRows + 8 * (i >> 2) + 2 * t + (i & 1);
        s[i] = ragged && key >= n_k ? 0.f : exp2_ftz(s[i] - lse_r[(i >> 1) & 1]);
      }
      // dS = P (dP - delta) into s
      product_rows<D>(dp, gf, v_st, gi, t);
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = (dp[i] - delta_r[(i >> 1) & 1]) * s[i];
      product_cols<D>(dq_acc, s, k_st, gi, t);
    }
    ring.release(it);
  }
  cp_async_wait_all();

  float* ob = dq + batch * dqs.b + head * dqs.h;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row + 8 * h >= n_q) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int i = 4 * j + 2 * h;
      *reinterpret_cast<float2*>(ob + (long long)(row + 8 * h) * dqs.t + 8 * j + 2 * t) =
          make_float2(dq_acc[i] * scale, dq_acc[i + 1] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
template <typename T, int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* g, const float* lse,
               float* scratch, void* dq, void* dk, void* dv, int batch, int n_q, int n_k, int n_heads,
               const long long* s, float scale_log2, float scale, cudaStream_t st) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* gp = static_cast<const T*>(g);
  Strides x[8];  // q, k, v, o, g, dq, dk, dv
  for (int i = 0; i < 8; ++i) x[i] = Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
  const int n_pad = (n_q + kBlockRows - 1) / kBlockRows * kBlockRows;
  const long long n_stats = (long long)batch * n_heads * n_pad;
  float* lse_pad = scratch;
  float* delta_pad = scratch + n_stats;

  flash_bwd_delta<T, D><<<(unsigned)((n_stats + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      gp, static_cast<const T*>(o), lse, lse_pad, delta_pad, batch, n_q, n_pad, n_heads, x[4], x[3]);
  if constexpr (sizeof(T) == 2) {
    constexpr int kSmem = Smem<D>::kBytes;
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(flash_bwd_dq<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dk != nullptr) {
      const dim3 grid((n_k + kBlockRows - 1) / kBlockRows, n_heads, batch);
      flash_bwd_dkdv<D><<<grid, kBlockThreads, kSmem, st>>>(
          qp, kp, vp, gp, lse_pad, delta_pad, static_cast<T*>(dk), static_cast<T*>(dv), n_q, n_k, n_pad, x[0],
          x[1], x[2], x[4], x[6], x[7], scale_log2, scale);
    }
    if (dq != nullptr) {
      const dim3 grid((n_q + kBlockRows - 1) / kBlockRows, n_heads, batch);
      flash_bwd_dq<D><<<grid, kBlockThreads, kSmem, st>>>(qp, kp, vp, gp, lse_pad, delta_pad,
                                                             static_cast<T*>(dq), n_q, n_k, n_pad, x[0], x[1],
                                                             x[2], x[4], x[5], scale_log2, scale);
    }
  } else {
    constexpr int kSmem = BwdF32Smem<D>::kBytes;
    cudaError_t err =
        cudaFuncSetAttribute(flash_bwd_dkdv_tf32x3<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(flash_bwd_dq_tf32x3<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dk != nullptr) {
      const dim3 grid((n_k + kBlockRows - 1) / kBlockRows, n_heads, batch);
      flash_bwd_dkdv_tf32x3<D><<<grid, kBlockThreads, kSmem, st>>>(
          qp, kp, vp, gp, lse_pad, delta_pad, static_cast<T*>(dk), static_cast<T*>(dv), n_q, n_k, n_pad, x[0],
          x[1], x[2], x[4], x[6], x[7], scale_log2, scale);
    }
    if (dq != nullptr) {
      const dim3 grid((n_q + kBlockRows - 1) / kBlockRows, n_heads, batch);
      flash_bwd_dq_tf32x3<D><<<grid, kBlockThreads, kSmem, st>>>(qp, kp, vp, gp, lse_pad, delta_pad,
                                                                  static_cast<T*>(dq), n_q, n_k, n_pad, x[0], x[1],
                                                                  x[2], x[4], x[5], scale_log2, scale);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point of both layouts, bound from Python with ctypes.
//   dtype: 0 = float32, 1 = bfloat16; strides are in elements, (batch, token, head) triples:
//   strides[0..23] = q, k, v, o, g, dq, dk, dv (a packed (batch, tokens, embed) operand passes
//   head stride head_dim). Every row start must be 16-byte aligned (the Python wrapper checks).
//   lse: (batch, n_heads, n_q) float32, the forward's row log-sum-exp in the log2 domain.
//   scratch: 2 * batch * n_heads * n_pad float32, n_pad = n_q rounded up to a multiple of 128;
//   filled here with the padded log-sum-exp and delta.
//   dq may be null (dq is not computed); dk and dv may both be null (neither is computed).
// Returns cudaGetLastError() after the launches (or the error of setting a kernel's shared
// memory size), or -1 for an unsupported dtype/head_dim combination.
extern "C" int cinema_flash_attention_bwd(const void* q, const void* k, const void* v, const void* o, const void* g,
                                          const void* lse, void* scratch, void* dq, void* dk, void* dv, int dtype,
                                          int batch, int n_q, int n_k, int n_heads, int head_dim,
                                          const long long* strides, float scale_log2, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_q <= 0 || n_k <= 0 || batch <= 0 || n_heads <= 0) return -1;
  if ((dk == nullptr) != (dv == nullptr)) return -1;
  const float* lp = static_cast<const float*>(lse);
  float* sp = static_cast<float*>(scratch);
  if (dtype == 1 && head_dim == 64) {
    return launch_bwd<__nv_bfloat16, 64>(q, k, v, o, g, lp, sp, dq, dk, dv, batch, n_q, n_k, n_heads, strides,
                                         scale_log2, scale, st);
  }
  if (dtype == 1 && head_dim == 32) {
    return launch_bwd<__nv_bfloat16, 32>(q, k, v, o, g, lp, sp, dq, dk, dv, batch, n_q, n_k, n_heads, strides,
                                         scale_log2, scale, st);
  }
  if (dtype == 0 && head_dim == 64) {
    return launch_bwd<float, 64>(q, k, v, o, g, lp, sp, dq, dk, dv, batch, n_q, n_k, n_heads, strides, scale_log2,
                                 scale, st);
  }
  if (dtype == 0 && head_dim == 32) {
    return launch_bwd<float, 32>(q, k, v, o, g, lp, sp, dq, dk, dv, batch, n_q, n_k, n_heads, strides, scale_log2,
                                 scale, st);
  }
  return -1;
}
