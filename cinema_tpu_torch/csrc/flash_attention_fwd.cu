// Flash-attention forward for Hopper (sm_90a), packed and per-head layouts in one implementation.
//
// Replaces two kernels of cinema_tpu/ops/pallas/flash_attention.py:
// `_flash_forward` (kernel `_flash_kernel`, per-head (batch, tokens, heads,
// head_dim) operands) and `_packed_forward` (kernel `_packed_fwd_kernel`,
// packed (batch, tokens, embed) operands with the heads split inside the
// kernel). The packed layout is the per-head one with head stride head_dim,
// so both C entry points hand (batch, token, head) element strides of q, k, v
// and out to the same kernels. Per (batch, head):
//
//   out = softmax(q k^T / sqrt(d)) v
//
// and, when the caller passes a buffer for it (a gradient is needed), each
// row's log-sum-exp of the scaled scores in the log2 domain, (batch, heads,
// n_q) f32, which the backward recomputes the probabilities from. k and v may
// be the column halves of a fused kv projection (row stride 2 * embed), v the
// strided v half of it in the per-head layout, and (batch, heads, tokens,
// head_dim) transposes are read in place: nothing is copied before the launch.
// n_q and n_k may differ (the MAE decoder's cross-attention).
//
// Bound at the serving shape of ConvUNetR-base (B=8, Tq=Tk=2305, H=12, D=64,
// bf16): two products, 4*B*Tq*Tk*H*D = 1.31e11 flop -> 0.132 ms at 989
// TFLOP/s, against 0.034 ms for the bytes (q, k, v read once and out written
// once at 3.35 TB/s): bounded by tensor-core operations, so the design keeps
// the tensor cores fed and everything between the two products in registers.
//
// Design. The TPU kernel walks q blocks in grid order with the whole key panel
// in VMEM (padded to 128, head groups, `_auto_block_q_fwd`); none of that is
// carried over. Here one block owns 128 q rows of one (batch, head), two
// warpgroups of 64 rows (256 threads), and loops over the keys itself with an
// online softmax (f32 running max and sum, log2 domain):
//
// - the block's q tile is copied once; each warpgroup reads its 64 rows from
//   shared memory as the A operand of S = q k^T (wgmma, both operands K-major);
// - k and v stream through the ring of hopper.cuh, 64 keys a stage, every
//   thread copying its share kAhead stages ahead, so copies overlap products
//   and the warpgroups drift apart (one's softmax under the other's products);
// - S (64 x 64 f32) stays in registers, four neighbouring threads a row, so
//   the row max and sum are quad shuffles; P is rounded to bf16 and re-packed
//   in registers as wgmma A fragments, and O += P v reads v through the
//   MN-major (transposed) descriptor: no tile is ever transposed;
// - ~83 KB of shared memory at head_dim 64 (q 16 KB, four stages of k and v
//   64 KB) and at most 128 registers a thread, so two blocks share an SM.
//
// Ragged edges are exact: keys past n_k are zero-filled by cp.async and get
// s = -inf on the last stage (a zero score is not a masked one); rows past n_q
// are zero-filled and neither stored nor given a log-sum-exp, and a
// warpgroup with no row only copies and releases. Tail tiles cost a whole
// block: 2305 = 18 * 128 + 1 and 769 = 6 * 128 + 1 rows leave one q block of
// 19 (resp. 7) with a single row, streaming every key for it.
//
// f32 operands run on the tensor cores in split TF32 (flash_fwd_tf32x3). They
// run in the f32 check steps and on a main path: the float32 evaluation of run
// folders (tasks/evaluate.py) and of Kaggle cines, (8, 2305^2, 768) a cine
// chunk. One TF32 product keeps 10 mantissa bits of each operand (about three
// decimal digits), so each operand x is split into hi = x rounded to TF32 and
// the remainder lo = x - hi, and each product is a_lo b_hi + a_hi b_lo +
// a_hi b_hi: three TF32 passes, with a_lo b_lo (below 2^-22 of the product)
// dropped. Bound at (8, 2305^2, 768): 3 * 4*B*Tq*Tk*E = 3.92e11 flop -> 0.79
// ms at 495 TFLOP/s dense TF32, against 0.068 ms for the bytes: bounded by
// tensor-core operations (the CUDA cores' 67 TFLOP/s would take 1.95 ms for
// the single f32 pass).
//
// What the tensor core does with an f32 register read as TF32, and how it
// rounds its sums, is measured by tf32_probe (chip_smoke.py prints it): on an
// NVIDIA H100 80GB HBM3 it drops the low 13 mantissa bits (1 + 2^-11 + 2^-12
// and 1 + 2^-10 - 2^-23 read as 1, -(1 + 2^-11 + 2^-12) as -1), and it rounds
// sums toward zero (1 + 0.75 ulp sums to 1, -1 - 0.75 ulp to -1). x passed as
// hi would therefore be read as trunc(x), and lo would have to be x - trunc(x),
// always of x's sign; hi is instead rounded by hand (to nearest), so that lo
// = x - hi is the residual of what the tensor core reads, and takes either
// sign. lo is passed as it is: it has at most 13 significant bits, of which
// the tensor core keeps 11, dropping less than 2^-22 |x|. Sums toward zero do
// bias: the tensor core sums only kStepsPerSum k-steps' products at a time,
// and the CUDA cores add those sums, rounding to nearest.
//
// Design. TF32 wgmma takes only K-major operands from shared memory (the
// transpose bits exist for 16-bit types only), and P v would need v staged
// transposed, with hi and lo copies of k and v in shared memory beside it. The
// products run on mma.sync.m16n8k8 instead, whose operands all come from
// registers: a block is eight warps of 16 q rows each (128 rows, 256 threads,
// the bf16 kernel's ring and 64-key stages); q is read once into registers,
// scaled into the log2 domain; each warp reads its B fragments of k and v
// straight from the (keys, D) tiles as cp.async landed them (padded pitches
// keep those reads free of bank conflicts) and splits every operand in
// registers. The depth of each product is a sum, so its order is free: S's
// k-steps take head_dim columns 2t and 2t + 1 as their columns t and t + 4
// (one 8-byte read), and P v's take keys 2t and 2t + 1, so P's A fragments are
// the thread's own entries of S. The online softmax is the bf16 kernel's
// (ex2.approx.ftz: relative error ~2^-22, far inside the f32 gate). ~140 KB of
// shared memory at head_dim 64 (four stages of a k and a v tile) and 255
// registers, no spills (ptxas): one block an SM. The split and the sums take
// more issue slots than the 384 mma.sync a warp issues per stage (cuobjdump).

#include "hopper.cuh"
#include "tf32.cuh"

namespace {

// Shared memory of the bf16 kernel, from a 1024-byte aligned base: the block's q tile (kBlockRows
// rows), kStages ring slots of a k and a v tile (kStageRows rows each), and the ring's barriers.
template <int D>
struct FwdSmem {
  static constexpr int kTile = kStageRows * TileLayout<D>::kPitch;  // one 64-row tile
  static constexpr int kRing = kGroups * kTile;                      // first ring slot
  static constexpr int kBars = kRing + 2 * kStages * kTile;
  static constexpr int kBytes = kBars + 2 * kStages * 8 + 1024;  // + slack to align the base
};

// one block per (kBlockRows q rows, head, batch), warpgroup wg owning rows wg * 64 .. + 63
template <int D>
__global__ void __launch_bounds__(kBlockThreads, 2)
    flash_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int n_q, int n_k,
                   Strides qs, Strides ks, Strides vs, Strides os, float scale_log2, float* __restrict__ lse) {
  using L = TileLayout<D>;
  using S = FwdSmem<D>;
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
  const __nv_bfloat16* kb = k + batch * ks.b + head * ks.h;
  const __nv_bfloat16* vb = v + batch * vs.b + head * vs.h;
  const int n_iters = (n_k + kStageRows - 1) / kStageRows;

  auto load_stage = [&](int it) {  // this thread's share of stage it
    if (it >= n_iters) return;
    ring.wait_free(it);
    const uint32_t dst = base + S::kRing + 2 * (it % kStages) * S::kTile;
    load_tile<D, kStageRows>(dst, kb, ks.t, it * kStageRows, n_k);
    load_tile<D, kStageRows>(dst + S::kTile, vb, vs.t, it * kStageRows, n_k);
    ring.copied(it);
  };

  load_tile<D, kBlockRows>(base, qb, qs.t, row_base, n_q);
  for (int it = 0; it < kAhead; ++it) load_stage(it);  // stage 0's arrival also covers q

  const bool active = row_base + wg * kStageRows < n_q;
  const uint32_t q_rows = base + wg * S::kTile;  // this warpgroup's rows: the A operand of S
  float o_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;
  // running max (log2 domain) and this thread's share of the sum of rows row and row + 8
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};

  for (int it = 0; it < n_iters; ++it) {
    load_stage(it + kAhead);
    const int slot = it % kStages;
    ring.wait_full(it);
    if (active) {  // a tail block's warpgroup with no row only copies and releases
      const uint32_t k_st = base + S::kRing + 2 * slot * S::kTile;
      const uint32_t v_st = k_st + S::kTile;

      // S: 64 q rows x 64 keys of this warpgroup
      float s[32];
      wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        mma_ss_n64(s, desc_k_major<D>(q_rows + kd * 32), desc_k_major<D>(k_st + kd * 32), kd);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // into the log2 domain; keys past n_k (zero rows of k and v) only on the last stage
      const int k0 = it * kStageRows;
      const bool ragged = k0 + kStageRows > n_k;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
        float x = s[i] * scale_log2;
        if (ragged) x = key < n_k ? x : -CUDART_INF_F;
        s[i] = x;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
      }
      // the four threads of a quad hold a row between them; key 0 is in the first stage, so
      // the max is finite from the first stage on (and alpha = 2^-inf = 0 there)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float alpha = exp2_ftz(m[h] - mx[h]);
        m[h] = mx[h];
        l[h] *= alpha;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o_acc[4 * j + 2 * h] *= alpha;
          o_acc[4 * j + 2 * h + 1] *= alpha;
        }
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[i] = exp2_ftz(s[i] - m[(i >> 1) & 1]);
        l[(i >> 1) & 1] += s[i];
      }

      // O += P v, P as bf16 A fragments, v read MN-major: 16 keys of the stage a step
      uint32_t pa[4][4];
      pack_a(pa, s);
      fence_regs(o_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) mma_rs<D, 1>(o_acc, pa[kk], desc_mn_major<D>(v_st + kk * 16 * L::kPitch));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o_acc);
    }
    ring.release(it);
  }
  cp_async_wait_all();

  // this thread's rows: row and row + 8
  const int row = row_base + wg * 64 + warp * 16 + gi;
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = quad_sum(l[h]);
  if (lse != nullptr && t == 0) {
    float* lse_row = lse + ((long long)batch * gridDim.y + head) * n_q;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (row + 8 * h < n_q) lse_row[row + 8 * h] = m[h] + log2f(l[h]);
    }
  }
  __nv_bfloat16* ob = o + batch * os.b + head * os.h;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row + 8 * h >= n_q) continue;
    const float inv = 1.f / l[h];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int i = 4 * j + 2 * h;
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)(row + 8 * h) * os.t + 8 * j + 2 * t) =
          __floats2bfloat162_rn(o_acc[i] * inv, o_acc[i + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// f32 operands on the tensor cores in split TF32 (see the note at the top; the products are in tf32.cuh):
// eight warps of 16 q rows, mma.sync m16n8k8 products with every operand split into hi + lo in registers.

// Shared memory of the f32 kernel, from a 1024-byte aligned base: kStages ring slots of a k and a v tile
// (kStageRows rows of D floats at a padded pitch), and the ring's barriers. The pitches keep the fragment
// reads free of bank conflicts: k's (D + 8 floats) for the 8-byte reads of S's B fragments, rows g at
// columns 2t; v's (D + 4 floats) for the 4-byte reads of P v's B fragments, rows 2t at columns g.
template <int D>
struct FwdF32Smem {
  static constexpr int kKPitch = D + 8;  // floats
  static constexpr int kVPitch = D + 4;
  static constexpr int kKTile = kStageRows * kKPitch * 4;  // bytes
  static constexpr int kSlot = kKTile + kStageRows * kVPitch * 4;
  static constexpr int kBars = kStages * kSlot;
  static constexpr int kBytes = kBars + 2 * kStages * 8 + 1024;  // + slack to align the base
};

// Copy rows [row0, row0 + kStageRows) of one (batch, head)'s D f32 columns into a tile of kPitch floats a
// row; rows from n_rows on are zero. Every thread of the block takes its share.
template <int D, int kPitch>
__device__ __forceinline__ void load_tile_f32(uint32_t tile, const float* __restrict__ base, long long row_stride,
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
    cp_async_16(tile + (r * kPitch + c * 4) * 4, src, valid);
  }
}

// one block per (kBlockRows q rows, head, batch), warp w owning rows w * 16 .. + 15
template <int D>
__global__ void __launch_bounds__(kBlockThreads, 1)
    flash_fwd_tf32x3(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     float* __restrict__ o, int n_q, int n_k, Strides qs, Strides ks, Strides vs, Strides os,
                     float scale_log2, float* __restrict__ lse) {
  using S = FwdF32Smem<D>;
  static_assert((D / 8) % kStepsPerSum == 0 && 8 % kStepsPerSum == 0, "whole sums of k-steps");
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
  const int row = row0 + gi;  // this thread's rows: row and row + 8
  const float* kb = k + batch * ks.b + head * ks.h;
  const float* vb = v + batch * vs.b + head * vs.h;
  const int n_iters = (n_k - 1) / kStageRows + 1;  // n_k >= 1

  auto load_stage = [&](int it) {  // this thread's share of stage it
    if (it >= n_iters) return;
    ring.wait_free(it);
    const uint32_t dst = base + (it % kStages) * S::kSlot;
    load_tile_f32<D, S::kKPitch>(dst, kb, ks.t, it * kStageRows, n_k);
    load_tile_f32<D, S::kVPitch>(dst + S::kKTile, vb, vs.t, it * kStageRows, n_k);
    ring.copied(it);
  };
  for (int it = 0; it < kAhead; ++it) load_stage(it);

  // q, scaled into the log2 domain, as the A fragments of S = q k^T (split at each use: registers are
  // scarcer than the two operations). The depth (head_dim) is a sum, so its order is free: k-step kk takes
  // columns 8kk + 2t and 8kk + 2t + 1 as its columns t and t + 4, one 8-byte read a row, and k's B
  // fragments are read in the same order.
  const bool active = row0 < n_q;  // a warp with no row only copies and releases
  float qf[D / 8][4];
  {
    const float* qb = q + batch * qs.b + head * qs.h;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool ok = row + 8 * h < n_q;
      const float* qrow = qb + (long long)(ok ? row + 8 * h : 0) * qs.t + 2 * t;
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const float2 x = ok ? *reinterpret_cast<const float2*>(qrow + 8 * kk) : make_float2(0.f, 0.f);
        qf[kk][h] = x.x * scale_log2;
        qf[kk][2 + h] = x.y * scale_log2;
      }
    }
  }
  float o_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;
  // running max (log2 domain) and this thread's share of the sum of rows row and row + 8
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};

  for (int it = 0; it < n_iters; ++it) {
    load_stage(it + kAhead);
    ring.wait_full(it);
    if (active) {
      const float* k_st = reinterpret_cast<const float*>(base_ptr + (it % kStages) * S::kSlot);
      const float* v_st = reinterpret_cast<const float*>(base_ptr + (it % kStages) * S::kSlot + S::kKTile);

      // S: 16 q rows x 64 keys of this warp; s[4j + 2h + e] is row row + 8h, key 8j + 2t + e of the stage
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
      for (int k0 = 0; k0 < D / 8; k0 += kStepsPerSum) {
        uint32_t q_hi[kStepsPerSum][4], q_lo[kStepsPerSum][4];
#pragma unroll
        for (int u = 0; u < kStepsPerSum; ++u) {
#pragma unroll
          for (int i = 0; i < 4; ++i) split_tf32(qf[k0 + u][i], q_hi[u][i], q_lo[u][i]);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float part[4];
#pragma unroll
          for (int u = 0; u < kStepsPerSum; ++u) {
            const float2 x =
                *reinterpret_cast<const float2*>(k_st + (8 * j + gi) * S::kKPitch + 8 * (k0 + u) + 2 * t);
            uint32_t b_hi[2], b_lo[2];
            split_tf32(x.x, b_hi[0], b_lo[0]);
            split_tf32(x.y, b_hi[1], b_lo[1]);
            if (u == 0) {
              mma_tf32x3<true>(part, q_hi[u], q_lo[u], b_hi, b_lo);
            } else {
              mma_tf32x3<false>(part, q_hi[u], q_lo[u], b_hi, b_lo);
            }
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) s[4 * j + i] += part[i];
        }
      }

      // keys past n_k (zero rows of k and v) only on the last stage
      const int k0 = it * kStageRows;
      const bool ragged = k0 + kStageRows > n_k;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
        if (ragged) s[i] = key < n_k ? s[i] : -CUDART_INF_F;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
      // the four threads of a quad hold a row between them; key 0 is in the first stage, so the max is
      // finite from the first stage on (and alpha = 2^-inf = 0 there)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float alpha = exp2_ftz(m[h] - mx[h]);
        m[h] = mx[h];
        l[h] *= alpha;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o_acc[4 * j + 2 * h] *= alpha;
          o_acc[4 * j + 2 * h + 1] *= alpha;
        }
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[i] = exp2_ftz(s[i] - m[(i >> 1) & 1]);
        l[(i >> 1) & 1] += s[i];
      }

      // O += P v. The keys are the depth: k-step kk takes keys 8kk + 2t and 8kk + 2t + 1 as its columns t
      // and t + 4, so P's A fragments are this thread's own entries of S (no shuffle), and v's B fragments
      // are read from rows 8kk + 2t and + 1 of the (keys, D) tile as it landed: no tile is transposed.
#pragma unroll
      for (int k0 = 0; k0 < 8; k0 += kStepsPerSum) {
        uint32_t p_hi[kStepsPerSum][4], p_lo[kStepsPerSum][4];
#pragma unroll
        for (int u = 0; u < kStepsPerSum; ++u) {
          const int kk = k0 + u;
          split_tf32(s[4 * kk], p_hi[u][0], p_lo[u][0]);
          split_tf32(s[4 * kk + 2], p_hi[u][1], p_lo[u][1]);
          split_tf32(s[4 * kk + 1], p_hi[u][2], p_lo[u][2]);
          split_tf32(s[4 * kk + 3], p_hi[u][3], p_lo[u][3]);
        }
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          float part[4];
#pragma unroll
          for (int u = 0; u < kStepsPerSum; ++u) {
            const float* v_row = v_st + (8 * (k0 + u) + 2 * t) * S::kVPitch + gi;
            uint32_t b_hi[2], b_lo[2];
            split_tf32(v_row[8 * j], b_hi[0], b_lo[0]);
            split_tf32(v_row[S::kVPitch + 8 * j], b_hi[1], b_lo[1]);
            if (u == 0) {
              mma_tf32x3<true>(part, p_hi[u], p_lo[u], b_hi, b_lo);
            } else {
              mma_tf32x3<false>(part, p_hi[u], p_lo[u], b_hi, b_lo);
            }
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) o_acc[4 * j + i] += part[i];
        }
      }
    }
    ring.release(it);
  }
  cp_async_wait_all();

#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = quad_sum(l[h]);
  if (lse != nullptr && t == 0) {
    float* lse_row = lse + ((long long)batch * gridDim.y + head) * n_q;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (row + 8 * h < n_q) lse_row[row + 8 * h] = log2f(l[h]) + m[h];
    }
  }
  float* ob = o + batch * os.b + head * os.h;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row + 8 * h >= n_q) continue;
    const float inv = 1.f / l[h];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int i = 4 * j + 2 * h;
      *reinterpret_cast<float2*>(ob + (long long)(row + 8 * h) * os.t + 8 * j + 2 * t) =
          make_float2(o_acc[i] * inv, o_acc[i + 1] * inv);
    }
  }
}

// One TF32 product that shows what the tensor core does with the low 13 mantissa bits of an f32 operand and
// how it rounds a sum: y[r] = c[r] + x[r] * 1 for 16 rows r, x passed as it is (A's column 0; B's row 0 is
// 1, the rest 0) and c as the accumulator's column 0
__global__ void tf32_probe(const float* __restrict__ x, const float* __restrict__ c, float* __restrict__ y) {
  const int gi = threadIdx.x / 4;
  const int t = threadIdx.x % 4;
  const uint32_t a[4] = {t == 0 ? __float_as_uint(x[gi]) : 0u, t == 0 ? __float_as_uint(x[gi + 8]) : 0u, 0u, 0u};
  const uint32_t b[2] = {t == 0 ? __float_as_uint(1.f) : 0u, 0u};
  float d[4] = {t == 0 ? c[gi] : 0.f, 0.f, t == 0 ? c[gi + 8] : 0.f, 0.f};
  mma_tf32(d, a, b);
  if (t == 0) {
    y[gi] = d[0];
    y[gi + 8] = d[2];
  }
}

// ---------------------------------------------------------------------------
template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, int batch, int n_q, int n_k, int n_heads,
               const long long* s, float scale_log2, float* lse, cudaStream_t st) {
  const Strides qs{s[0], s[1], s[2]}, ks{s[3], s[4], s[5]}, vs{s[6], s[7], s[8]}, os{s[9], s[10], s[11]};
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
  if constexpr (sizeof(T) == 2) {
    constexpr int kSmem = FwdSmem<D>::kBytes;
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err == cudaSuccess) {  // a hint: room for two blocks an SM
      err = cudaFuncSetAttribute(flash_fwd_bf16<D>, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((n_q + kBlockRows - 1) / kBlockRows, n_heads, batch);
    flash_fwd_bf16<D><<<grid, kBlockThreads, kSmem, st>>>(qp, kp, vp, op, n_q, n_k, qs, ks, vs, os, scale_log2, lse);
  } else {
    constexpr int kSmem = FwdF32Smem<D>::kBytes;
    const cudaError_t err =
        cudaFuncSetAttribute(flash_fwd_tf32x3<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((n_q + kBlockRows - 1) / kBlockRows, n_heads, batch);
    flash_fwd_tf32x3<D><<<grid, kBlockThreads, kSmem, st>>>(qp, kp, vp, op, n_q, n_k, qs, ks, vs, os, scale_log2,
                                                             lse);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point of both layouts, bound from Python with ctypes.
//   dtype: 0 = float32, 1 = bfloat16; strides are in elements, (batch, token, head) triples:
//   strides[0..11] = q, k, v, out (a packed (batch, tokens, embed) operand passes head stride
//   head_dim). Every row start must be 16-byte aligned (the Python wrapper checks).
//   lse: null, or (batch, n_heads, n_q) float32 that receives each row's log-sum-exp of the
//   scaled scores in the log2 domain (saved for the backward).
// Returns cudaGetLastError() after the launch (or the error of setting the kernel's shared
// memory size), or -1 for an unsupported dtype/head_dim combination.
extern "C" int cinema_flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int dtype, int batch,
                                          int n_q, int n_k, int n_heads, int head_dim, const long long* strides,
                                          float scale_log2, void* lse, void* stream) {
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

// The TF32 probe: y[r] = c[r] + x[r] as one product on the tensor cores computes it, r < 16 (see
// tf32_probe). Returns cudaGetLastError() after the launch.
extern "C" int cinema_tf32_probe(const float* x, const float* c, float* y, void* stream) {
  tf32_probe<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(x, c, y);
  return static_cast<int>(cudaGetLastError());
}
