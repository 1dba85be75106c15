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
// f32 operands stay on the CUDA cores, one thread per q row over 32-key
// tiles, as no tensor-core format keeps f32 exact; they run in the f32 check
// steps and on a main path: the float32 evaluation of run folders
// (tasks/evaluate.py) and of Kaggle cines.

#include "hopper.cuh"

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
// f32 operands, on the CUDA cores: one thread per q row, kThreads rows a block, over tiles of
// kBlockKF32 keys staged in shared memory.
constexpr int kBlockKF32 = 32;

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
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
    const dim3 grid((n_q + kThreads - 1) / kThreads, n_heads, batch);
    flash_fwd_f32<D><<<grid, kThreads, 0, st>>>(qp, kp, vp, op, n_q, n_k, qs, ks, vs, os, scale_log2, lse);
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
