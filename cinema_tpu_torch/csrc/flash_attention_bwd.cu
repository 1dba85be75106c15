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
// second product, as the forward rounds P. f32 inputs stay on the CUDA cores
// (four threads per row), as no tensor-core format keeps f32 exact; they run
// only in the f32 check steps.
//
// Bound at the fine-tuning shape of ConvViT-base (B=4, Tq=Tk=2305, H=12, D=64,
// bf16): five products, 10*B*Tq*Tk*H*D = 1.6e11 flop -> 0.165 ms at 989
// TFLOP/s, against 0.034 ms for the bytes (q, k, v, o, g read and dq, dk, dv
// written once at 3.35 TB/s): bounded by tensor-core operations.

#include "flash_attention_common.cuh"

namespace {

constexpr int kStageRows = 64;  // rows of a streamed stage, and of one warpgroup's share of a block's tile
constexpr int kGroups = 2;      // consumer warpgroups per block
constexpr int kBlockRows = kGroups * kStageRows;  // keys (dk/dv) or q rows (dq) a block owns
constexpr int kBlockThreads = kGroups * 128;  // two warps on each SM sub-partition: up to 255 registers a thread
constexpr int kStages = 4;  // depth of the ring

// ---------------------------------------------------------------------------
// Shared-memory tiles: rows of D bf16 (D * 2 bytes), 16-byte chunks swizzled as
// wgmma's 128-byte (D = 64) or 64-byte (D = 32) mode reads them: byte address
// bits [4, 7) (resp. [4, 6)) are XORed with bits [7, 10) (resp. [7, 9)). Tiles
// start on 1024-byte boundaries, so the swizzle of the absolute address is
// that of the offset in the tile.

template <int D>
struct TileLayout {
  static_assert(D == 32 || D == 64, "head_dim must be 32 or 64");
  static constexpr int kPitch = D * 2;                          // bytes per row
  static constexpr uint32_t kMask = D == 64 ? 7u : 3u;          // chunk bits XORed
  static constexpr uint64_t kSwizzle = D == 64 ? 1ull : 2ull;   // descriptor layout type: 1 = 128B, 2 = 64B
  static constexpr int kGroupBytes = 8 * kPitch;                // eight rows: one swizzle atom

  __device__ static __forceinline__ uint32_t offset(int row, int chunk) {
    const uint32_t o = row * kPitch + chunk * 16;
    return o ^ (((o >> 7) & kMask) << 4);
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid (nothing is read then)
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// mbarriers in shared memory
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// one arrival on the barrier once every cp.async this thread has issued so far has landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the completion of the barrier's phase of this parity. A phase that does not complete
// within ~10 s (2^34 cycles) can only be a fault: the launch then ends with an error, not a hang.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_addr(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(addr, parity)) {
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

// cp.async writes shared memory through the generic proxy and wgmma reads it through the
// async proxy: a consumer fences after the barrier wait that shows it the landed copies
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t aligned_smem_base(uint8_t* raw) { return (smem_addr(raw) + 1023) & ~1023u; }

// Copy rows [row0, row0 + kRows) of one (batch, head)'s D columns into a swizzled tile;
// rows from n_rows on are zero. Every thread of the block takes its share.
template <int D, int kRows>
__device__ __forceinline__ void load_tile(uint32_t tile, const __nv_bfloat16* __restrict__ base, long long row_stride,
                                          int row0, int n_rows) {
  constexpr int kChunks = D / 8;
  static_assert(kRows * kChunks % kBlockThreads == 0, "whole copies per thread");
#pragma unroll
  for (int i = 0; i < kRows * kChunks / kBlockThreads; ++i) {
    const int idx = threadIdx.x + i * kBlockThreads;
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    const bool valid = row0 + r < n_rows;
    const __nv_bfloat16* src = base + (valid ? (long long)(row0 + r) * row_stride + c * 8 : 0);
    cp_async_16(tile + TileLayout<D>::offset(r, c), src, valid);
  }
}

// ---------------------------------------------------------------------------
// wgmma. A shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle mode. For a K-major operand
// (rows of the M or N dimension, D contiguous) the stride offset steps eight
// rows and the leading offset is unused by the swizzled modes. For an MN-major
// operand (rows of the K dimension, the N dimension contiguous in one swizzle
// atom's width) the stride offset steps eight K rows; N never leaves the atom
// here (N = D), so the leading offset is given the same value.

template <int D>
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  using L = TileLayout<D>;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(L::kGroupBytes >> 4) << 32) |
         (L::kSwizzle << 62);
}

template <int D>
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr) {
  using L = TileLayout<D>;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(L::kGroupBytes >> 4) << 16) |
         ((uint64_t)(L::kGroupBytes >> 4) << 32) | (L::kSwizzle << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
// wait until at most N committed groups of this warpgroup are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins accumulator registers at this point of the program: wgmma writes them asynchronously,
// so no use may be moved above the wait, and no write below the fence, by the compiler
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The accumulator of m64nNk16, f32: warp w of the warpgroup holds rows 16w .. 16w + 15; with
// g = lane / 4 and t = lane % 4, d[4j + 2h + e] is row 16w + g + 8h, column 8j + 2t + e.

#define WG_ACC8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
                   "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 64) (+)= A (64 x 16, shared, K-major) * B (16 x 64, shared, K-major)
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC8(0), WG_ACC8(8), WG_ACC8(16), WG_ACC8(24)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x N) (+)= A (64 x 16, registers) * B (16 x N, shared); kTransB = 1 reads B MN-major
template <int N, int kTransB>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b, int accumulate = 1) {
  static_assert(N == 32 || N == 64, "N is head_dim");
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : WG_ACC8(0), WG_ACC8(8), WG_ACC8(16), WG_ACC8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate), "n"(kTransB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : WG_ACC8(0), WG_ACC8(8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate), "n"(kTransB));
  }
}

#undef WG_ACC8

// 2^x on the special-function unit, subnormal results flushed to 0 (P below 2^-126 is 0 in bf16 anyway)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

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

// The A fragments of a 64 x 64 accumulator as the left operand of the next product (its columns
// become the depth): k-slice kk takes columns 16kk .. 16kk + 15, rounded to bf16.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4], const float (&d)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack_bf16(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
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

// The ring. Every thread copies its share of each stage, kAhead stages ahead of the one it
// multiplies. full[s] completes when every thread's copies into slot s have landed (one
// cp.async-tracked arrival per thread), empty[s] when every warp is done reading it. A thread
// refills a slot only after both warpgroups released it, so a warpgroup may run up to kAhead
// stages ahead of the other, but is never held in step with it by a block-wide barrier.
constexpr int kAhead = kStages - 2;

struct Ring {
  uint64_t* full;
  uint64_t* empty;

  __device__ explicit Ring(uint8_t* bars) {
    full = reinterpret_cast<uint64_t*>(bars);
    empty = full + kStages;
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) {
        mbar_init(full + s, kBlockThreads);
        mbar_init(empty + s, kBlockThreads / 32);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }

  // before this thread's copies of stage `it` (into slot it % kStages): its previous use, stage
  // it - kStages, must be released by every warp
  __device__ void wait_free(int it) const {
    if (it >= kStages) mbar_wait(empty + it % kStages, ((it / kStages) & 1) ^ 1);
  }
  __device__ void copied(int it) const { cp_async_arrive(full + it % kStages); }
  __device__ void wait_full(int it) const {
    mbar_wait(full + it % kStages, (it / kStages) & 1);
    fence_async_shared();
  }
  __device__ void release(int it) const {
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(empty + it % kStages);
  }
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
// f32 operands, on the CUDA cores: four threads per row, each owning a quarter of the head's columns.
constexpr int kRowsF32 = kThreads / 4;  // rows per block (four threads a row) and per looped tile

// thread c of a row's four owns columns 16m + 4c .. 16m + 4c + 3 for every m < D / 16, so the four
// read 64 contiguous bytes of a shared-memory row
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

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     const float* __restrict__ g, const float* __restrict__ lse_pad,
                     const float* __restrict__ delta_pad, float* __restrict__ dq, int n_q, int n_k, int n_pad,
                     Strides qs, Strides ks, Strides vs, Strides gs, Strides dqs, float scale_log2, float scale) {
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
  const long long stat = ((long long)batch * gridDim.y + head) * n_pad + row;  // padded: row < n_pad
  const float lse_r = lse_pad[stat];
  const float delta_r = delta_pad[stat];
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
    flash_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                       const float* __restrict__ g, const float* __restrict__ lse_pad,
                       const float* __restrict__ delta_pad, float* __restrict__ dk, float* __restrict__ dv, int n_q,
                       int n_k, int n_pad, Strides qs, Strides ks, Strides vs, Strides gs, Strides dks, Strides dvs,
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
  const long long stat = ((long long)batch * gridDim.y + head) * n_pad;
  const float* qb = q + batch * qs.b + head * qs.h;
  const float* gb = g + batch * gs.b + head * gs.h;

  for (int i0 = 0; i0 < n_q; i0 += kRowsF32) {
    __syncthreads();
    stage_tile_f32<D>(qb, qs.t, i0, n_q, q_tile);
    stage_tile_f32<D>(gb, gs.t, i0, n_q, g_tile);
    if (threadIdx.x < kRowsF32) {  // padded statistics: a row past n_q has lse +inf (P = 0) and delta 0
      lse_s[threadIdx.x] = lse_pad[stat + i0 + threadIdx.x];
      delta_s[threadIdx.x] = delta_pad[stat + i0 + threadIdx.x];
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
    if (dk != nullptr) {
      const dim3 grid((n_k + kRowsF32 - 1) / kRowsF32, n_heads, batch);
      flash_bwd_dkdv_f32<D><<<grid, kThreads, 0, st>>>(qp, kp, vp, gp, lse_pad, delta_pad, static_cast<T*>(dk),
                                                       static_cast<T*>(dv), n_q, n_k, n_pad, x[0], x[1], x[2],
                                                       x[4], x[6], x[7], scale_log2, scale);
    }
    if (dq != nullptr) {
      const dim3 grid((n_q + kRowsF32 - 1) / kRowsF32, n_heads, batch);
      flash_bwd_dq_f32<D><<<grid, kThreads, 0, st>>>(qp, kp, vp, gp, lse_pad, delta_pad, static_cast<T*>(dq), n_q,
                                                     n_k, n_pad, x[0], x[1], x[2], x[4], x[5], scale_log2, scale);
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
