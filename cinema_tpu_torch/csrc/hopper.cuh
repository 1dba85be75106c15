// Hopper (sm_90a) building blocks of the bf16 flash-attention kernels, forward
// and backward: the block shape, swizzled shared-memory tiles, cp.async copies,
// the mbarrier ring that streams tiles, and the wgmma products.
//
// A block is two consumer warpgroups of 64 rows (256 threads) and no producer
// warp: every thread copies its share of each streamed stage kAhead stages
// ahead of the one it multiplies. TMA is not used: cp.async needs no tensor
// map (no cuTensorMapEncodeTiled, so no libcuda link for a library with a
// plain C interface) and zero-fills each operand's ragged token tail by the
// row, whatever its strides.
#pragma once

#include "flash_attention_common.cuh"

namespace {

constexpr int kStageRows = 64;  // rows of a streamed stage, and of one warpgroup's share of a block's tile
constexpr int kGroups = 2;      // consumer warpgroups per block
constexpr int kBlockRows = kGroups * kStageRows;  // rows a block owns
constexpr int kBlockThreads = kGroups * 128;
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

// The A fragments of a 64 x 64 accumulator as the left operand of the next product (its columns
// become the depth): k-slice kk takes columns 16kk .. 16kk + 15, rounded to bf16.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4], const float (&d)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack_bf16(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
  }
}

}  // namespace
