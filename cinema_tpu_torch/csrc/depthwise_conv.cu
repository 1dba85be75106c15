// Depthwise 5^nd convolution of MaskedConvBlock for Hopper (sm_90a): forward, data gradient and weight
// gradient of `dw_conv` (groups == channels, kernel 5, stride 1, "same" padding), in 2-D and 3-D.
//
// It replaces no TPU kernel: the JAX package leaves this convolution to XLA. It replaces cuDNN's depthwise
// convolution, which ran it on generic fallback kernels (implicit_convolveNd_sgemm for the forward,
// convolveNd_wgrad_engine and the indexed xmma kernels for the gradients) at about 1 % of the card's bound.
//
//   out[b, p, c] = bias[c] + sum_k w[c, k] * x[b, p + k - 2, c]        (zeros outside the image)
//   dx[b, p, c]  = sum_k w[c, 4 - k] * g[b, p + k - 2, c]              (the forward with the filter flipped)
//   dw[c, k]     = sum_{b, p} g[b, p, c] * x[b, p + k - 2, c],   dbias[c] = sum_{b, p} g[b, p, c]
//
// Layout. Every operand has its channels innermost (stride 1) and any (batch, x, y, z) strides: the port's
// convolutions keep PyTorch's channels_last memory format, and the sparse MAE stem hands its densified image
// over as a strided view. A 2-D image (H, W) is the 3-D one (1, H, W) with a kernel of extent 1 along x.
// Inputs and outputs are bf16 or f32; weights, bias and every sum are f32 (no bf16 sums, no TF32).
//
// Bound on an H100 SXM. A depthwise convolution cannot use the tensor cores (each output is a 125-term dot
// product of one channel), so its bound is the CUDA cores' f32 FMA rate (67 TFLOP/s) or the bytes at
// 3.35 TB/s. 3-D: 125 FMAs an output against 4 bytes of bf16 in and out, 62 flop a byte, far above the
// card's 20: bound by FMAs. One SAX frame of CineMA-base (64 ch x 48x48x16 and 128 ch x 24x24x16, two blocks
// each) is 1.77 GFLOP a pass, 26.4 us. 2-D: 25 FMAs an output, 12.5 flop a byte: bound by bytes.
//
// Design, for the FMA bound. One block owns 32 channels (one a lane, so a warp's shared-memory reads are 64
// contiguous bytes and free of bank conflicts) and a tile of outputs: 4 x 4 x 16 (x, y, z) in 3-D, 1 x 16 x 16 in
// 2-D. The tile's input box with its halo (8 x 8 x 20 voxels in 3-D) is copied once into shared memory by cp.async,
// 16 bytes a copy where the strides allow it and all of a thread's copies in flight at once (one load after another
// left a block waiting ~20 memory latencies), zeros outside the image. Each thread keeps two rows of 16 outputs
// along z in f32 registers; for each tap (dx, input row) it reads a column of 20 inputs into registers once and
// slides the 5 z-taps over it, so one shared-memory read feeds 4 to 8 FMAs and the issue slots go to FMAs (~75 % of
// the instructions), not to loads. Weights sit in shared memory, one row of 32 channels a tap. Bias is added in the
// epilogue and the output rounded once. The data gradient is the same kernel on the output gradient with the
// filter's taps read in reverse. The box (80 KB bf16, 160 KB f32) and the weights (16 KB) leave room for two bf16 blocks an SM. On
// an H100 SXM at 700 W the forward, data gradient and weight gradient take 0.13 ms each at (4, 64, 48, 48, 16)
// bf16, 27-36 % of this bound at the main shapes, where cuDNN took 7.1, 1.7 and 51 ms.
//
// Design, for the bytes in 2-D. The same kernel: the box of a 16 x 16 tile is 20 x 20 voxels, 1.56 times the
// tile, and several blocks an SM overlap one block's copy with another's FMAs.
//
// Weight gradient. One block owns 32 channels, the same output tile and a run of samples; per sample the
// input box and the output gradient's tile are copied to shared memory. Its warps are (set, dx) pairs: each
// thread keeps the 25 (dy, dz) sums of its channel and dx in registers, reads the gradient's two z-columns
// of a column pair once, and for each of the 6 input rows one input column of 20, sliding 5 z-taps over it
// (800 FMAs for 152 shared-memory reads). The sets split the tile's column pairs and are added in shared
// memory in a fixed order; the block writes one f32 partial per (tile, run of samples, channel, tap), the
// bias gradient beside it, and a second kernel sums the partials in a fixed order. No atomics: the gradient
// is the same from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;  // channels a block owns, one a lane
constexpr int kTaps = 5;    // kernel extent along y and z (and x in 3-D)
constexpr int kPad = 2;     // "same" padding of the 5-tap axes
constexpr int kTZ = 16;     // outputs along z a thread keeps in registers
constexpr int kRY = 2;      // output rows along y a thread keeps in registers
constexpr int kWPitch = kLanes + 1;  // floats a row of per-tap sums in shared memory: no bank conflicts

// Sizes and (batch, x, y, z) element strides of one call; a 2-D image is (1, H, W).
struct Geometry {
  int batch, chans;
  int size[3];
  int tiles[3];               // output tiles along x, y, z
  long long in_stride[4];     // the input (forward: x or, for the data gradient, g; weight gradient: x)
  long long out_stride[4];    // the output (forward), or the output gradient g (weight gradient)
  int in_vec, out_vec;        // 1: the operand's voxels may be copied 16 bytes at a time
};

// The tile of one block and its input box. K0 is the kernel's extent along x: 5 in 3-D, 1 in 2-D.
template <int K0>
struct Tile {
  static constexpr int kWX = K0 == 1 ? 1 : 4;           // warps along x (forward)
  static constexpr int kWY = 8 / kWX;                    // warps along y, kRY rows each (forward)
  static constexpr int kTX = kWX, kTY = kWY * kRY;       // outputs of a tile: kTX x kTY x kTZ
  static constexpr int kEX = kTX + K0 - 1, kEY = kTY + kTaps - 1, kEZ = kTZ + kTaps - 1;  // its input box
  static constexpr int kTapCount = K0 * kTaps * kTaps;
  static constexpr int kPairs = kTX * kTY / kRY;         // output column pairs of a tile
  static constexpr int kFwdThreads = 256;
  static constexpr int kSets = K0 == 1 ? 8 : 2;          // weight gradient: warps per dx
  static constexpr int kGradThreads = kLanes * K0 * kSets;
};

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

// an f32 parameter as the input's dtype holds it: the filter and bias are rounded to it, as the port's other
// convolutions round theirs
template <typename T>
__device__ __forceinline__ float rounded(float v) { return to_f32(from_f32<T>(v)); }

// cp.async: a copy to shared memory that needs no register and does not block the thread, so all of a
// thread's copies are in flight at once; valid == false writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

template <typename T, int K0>
struct Smem {
  using L = Tile<K0>;
  static constexpr int kBox = L::kEX * L::kEY * L::kEZ * kLanes * (int)sizeof(T);
  static constexpr int kWeights = L::kTapCount * kWPitch * 4;
  static constexpr int kFwd = kBox + kWeights;
  static constexpr int kGradTile = L::kTX * L::kTY * kTZ * kLanes * (int)sizeof(T);
  static constexpr int kSums = L::kSets * (L::kTapCount + 1) * kWPitch * 4;  // the sets' sums, then reused
  static constexpr int kGrad = (kBox + kGradTile > kSums ? kBox + kGradTile : kSums);
};

// Starts copying the box of EX x EY x EZ voxels from (x0, y0, z0) of sample b, channels c0 .. c0 + 31, into
// dst as [voxel][32 channels]: zeros outside the image and past the last channel. With vec the copies are
// cp.async of 16 bytes, all in flight at once; cp_async_wait_all() then __syncthreads() before reading dst.
template <typename T, int EX, int EY, int EZ, int kThreads>
__device__ __forceinline__ void copy_box(T* dst, const T* __restrict__ src, const long long* stride,
                                         const Geometry& g, int b, int x0, int y0, int z0, int c0, int vec) {
  constexpr int kVec = 16 / (int)sizeof(T);
  constexpr int kChunks = kLanes / kVec;
  constexpr int kItems = EX * EY * EZ * kChunks;
#pragma unroll 4
  for (int i = threadIdx.x; i < kItems; i += kThreads) {
    const int chunk = i % kChunks;
    const int v = i / kChunks;
    const int vz = v % EZ, vy = (v / EZ) % EY, vx = v / (EZ * EY);
    const int x = x0 + vx, y = y0 + vy, z = z0 + vz, c = c0 + chunk * kVec;
    T* d = dst + v * kLanes + chunk * kVec;
    const bool inside = x >= 0 && x < g.size[0] && y >= 0 && y < g.size[1] && z >= 0 && z < g.size[2] &&
                        c < g.chans;
    const T* s = inside ? src + b * stride[0] + x * stride[1] + y * stride[2] + z * stride[3] + c : src;
    if (vec && (!inside || c + kVec <= g.chans)) {
      cp_async16(d, s, inside);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) d[j] = inside && c + j < g.chans ? s[j] : from_f32<T>(0.f);
    }
  }
}

// Block (tile, channel group, sample) -> its tile's first output (x, y, z).
__device__ __forceinline__ void tile_origin(const Geometry& g, int tile, int tx, int ty, int& x0, int& y0,
                                            int& z0) {
  const int iz = tile % g.tiles[2];
  const int iy = (tile / g.tiles[2]) % g.tiles[1];
  const int ix = tile / (g.tiles[2] * g.tiles[1]);
  x0 = ix * tx;
  y0 = iy * ty;
  z0 = iz * kTZ;
}

// Forward (and data gradient: flip reads the filter's taps in reverse, and no bias). One block per (tile,
// 32 channels, sample); warp w owns the outputs x = w / kWY, y = (w % kWY) * kRY + (0, 1), z = 0 .. 15 of the
// tile.
template <typename T, int K0>
__global__ void __launch_bounds__(Tile<K0>::kFwdThreads, 2)
    depthwise_conv_fwd(const T* __restrict__ in, const float* __restrict__ weight, const float* __restrict__ bias,
                       T* __restrict__ out, Geometry g, int flip) {
  using L = Tile<K0>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* box = reinterpret_cast<T*>(smem_raw);
  float* wsm = reinterpret_cast<float*>(smem_raw + Smem<T, K0>::kBox);  // [tap][kWPitch]
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int c0 = blockIdx.y * kLanes, b = blockIdx.z;
  int x0, y0, z0;
  tile_origin(g, blockIdx.x, L::kTX, L::kTY, x0, y0, z0);

  // the 32 channels' f32 filters, [channel][tap] in device memory, to [tap][channel] here (tap reversed when
  // flip), then rounded to T by the thread that copied them
#pragma unroll 4
  for (int i = threadIdx.x; i < kLanes * L::kTapCount; i += L::kFwdThreads) {
    const int l = i / L::kTapCount, k = i % L::kTapCount;
    const int src = flip ? L::kTapCount - 1 - k : k;
    if (c0 + l < g.chans) {
      cp_async4(wsm + k * kWPitch + l, weight + (long long)(c0 + l) * L::kTapCount + src);
    } else {
      wsm[k * kWPitch + l] = 0.f;
    }
  }
  copy_box<T, L::kEX, L::kEY, L::kEZ, L::kFwdThreads>(box, in, g.in_stride, g, b, x0 - (K0 - 1) / 2, y0 - kPad,
                                                      z0 - kPad, c0, g.in_vec);
  cp_async_wait_all();
  for (int i = threadIdx.x; i < kLanes * L::kTapCount; i += L::kFwdThreads) {
    float& w = wsm[(i % L::kTapCount) * kWPitch + i / L::kTapCount];
    w = rounded<T>(w);
  }
  __syncthreads();

  const int ox = warp / L::kWY, oy = (warp % L::kWY) * kRY;  // this warp's outputs in the tile
  float acc[kRY][kTZ];
#pragma unroll
  for (int r = 0; r < kRY; ++r) {
#pragma unroll
    for (int z = 0; z < kTZ; ++z) acc[r][z] = 0.f;
  }
#pragma unroll 1
  for (int dx = 0; dx < K0; ++dx) {
    const T* rows = box + ((ox + dx) * L::kEY + oy) * L::kEZ * kLanes + lane;
    const float* wdx = wsm + dx * kTaps * kTaps * kWPitch + lane;
#pragma unroll
    for (int r = 0; r < kRY + kTaps - 1; ++r) {  // input rows oy .. oy + kRY + 3
      float col[kTZ + kTaps - 1];
#pragma unroll
      for (int z = 0; z < kTZ + kTaps - 1; ++z) col[z] = to_f32(rows[(r * L::kEZ + z) * kLanes]);
#pragma unroll
      for (int ry = 0; ry < kRY; ++ry) {
        const int dy = r - ry;
        if (dy < 0 || dy >= kTaps) continue;
#pragma unroll
        for (int dz = 0; dz < kTaps; ++dz) {
          const float w = wdx[(dy * kTaps + dz) * kWPitch];
#pragma unroll
          for (int z = 0; z < kTZ; ++z) acc[ry][z] = fmaf(col[z + dz], w, acc[ry][z]);
        }
      }
    }
  }

  const int c = c0 + lane, x = x0 + ox;
  if (c >= g.chans || x >= g.size[0]) return;
  const float bc = bias != nullptr ? rounded<T>(bias[c]) : 0.f;
  T* o = out + b * g.out_stride[0] + x * g.out_stride[1] + c;
#pragma unroll
  for (int ry = 0; ry < kRY; ++ry) {
    const int y = y0 + oy + ry;
    if (y >= g.size[1]) continue;
#pragma unroll
    for (int z = 0; z < kTZ; ++z) {
      if (z0 + z < g.size[2]) o[y * g.out_stride[2] + (z0 + z) * g.out_stride[3]] = from_f32<T>(acc[ry][z] + bc);
    }
  }
}

// Weight gradient, first pass. One block per (tile, 32 channels, run of samples); warp w is set w / K0 with
// dx = w % K0 and keeps the (dy, dz) sums of its lane's channel; the sets split the tile's column pairs.
// Writes partial[(tile * runs + run) * chans + c][tap] and bias_partial[(tile * runs + run) * chans + c].
template <typename T, int K0>
__global__ void __launch_bounds__(Tile<K0>::kGradThreads, 2)
    depthwise_conv_wgrad(const T* __restrict__ in, const T* __restrict__ grad, float* __restrict__ partial,
                         float* __restrict__ bias_partial, Geometry g, int samples_per_block) {
  using L = Tile<K0>;
  using S = Smem<T, K0>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* box = reinterpret_cast<T*>(smem_raw);
  T* gtile = reinterpret_cast<T*>(smem_raw + S::kBox);  // [voxel of the tile][32 channels]
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int set = warp / K0, dx = warp % K0;
  const int c0 = blockIdx.y * kLanes;
  const int b_begin = blockIdx.z * samples_per_block;
  const int b_end = min(b_begin + samples_per_block, g.batch);
  int x0, y0, z0;
  tile_origin(g, blockIdx.x, L::kTX, L::kTY, x0, y0, z0);

  float acc[kTaps][kTaps];
#pragma unroll
  for (int i = 0; i < kTaps; ++i) {
#pragma unroll
    for (int j = 0; j < kTaps; ++j) acc[i][j] = 0.f;
  }
  float bias_acc = 0.f;
  for (int b = b_begin; b < b_end; ++b) {
    __syncthreads();  // the last sample's reads are done
    copy_box<T, L::kEX, L::kEY, L::kEZ, L::kGradThreads>(box, in, g.in_stride, g, b, x0 - (K0 - 1) / 2,
                                                         y0 - kPad, z0 - kPad, c0, g.in_vec);
    copy_box<T, L::kTX, L::kTY, kTZ, L::kGradThreads>(gtile, grad, g.out_stride, g, b, x0, y0, z0, c0,
                                                      g.out_vec);
    cp_async_wait_all();
    __syncthreads();
#pragma unroll 1
    for (int p = set; p < L::kPairs; p += L::kSets) {
      const int px = p / (L::kTY / kRY), py = (p % (L::kTY / kRY)) * kRY;
      float gcol[kRY][kTZ];
#pragma unroll
      for (int ry = 0; ry < kRY; ++ry) {
#pragma unroll
        for (int z = 0; z < kTZ; ++z) gcol[ry][z] = to_f32(gtile[((px * L::kTY + py + ry) * kTZ + z) * kLanes + lane]);
      }
      if (dx == 0) {
#pragma unroll
        for (int ry = 0; ry < kRY; ++ry) {
#pragma unroll
          for (int z = 0; z < kTZ; ++z) bias_acc += gcol[ry][z];
        }
      }
      const T* rows = box + ((px + dx) * L::kEY + py) * L::kEZ * kLanes + lane;
#pragma unroll
      for (int r = 0; r < kRY + kTaps - 1; ++r) {
        float col[kTZ + kTaps - 1];
#pragma unroll
        for (int z = 0; z < kTZ + kTaps - 1; ++z) col[z] = to_f32(rows[(r * L::kEZ + z) * kLanes]);
#pragma unroll
        for (int ry = 0; ry < kRY; ++ry) {
          const int dy = r - ry;
          if (dy < 0 || dy >= kTaps) continue;
#pragma unroll
          for (int dz = 0; dz < kTaps; ++dz) {
#pragma unroll
            for (int z = 0; z < kTZ; ++z) acc[dy][dz] = fmaf(gcol[ry][z], col[z + dz], acc[dy][dz]);
          }
        }
      }
    }
  }

  // the sets' sums, added in set order: [set][tap, then the bias][kWPitch]
  __syncthreads();
  float* sums = reinterpret_cast<float*>(smem_raw);
  float* mine = sums + set * (L::kTapCount + 1) * kWPitch + lane;
#pragma unroll
  for (int dy = 0; dy < kTaps; ++dy) {
#pragma unroll
    for (int dz = 0; dz < kTaps; ++dz) mine[((dx * kTaps + dy) * kTaps + dz) * kWPitch] = acc[dy][dz];
  }
  if (dx == 0) mine[L::kTapCount * kWPitch] = bias_acc;
  __syncthreads();
  const long long part = (long long)blockIdx.x * gridDim.z + blockIdx.z;
  for (int i = threadIdx.x; i < kLanes * (L::kTapCount + 1); i += L::kGradThreads) {
    const int l = i / (L::kTapCount + 1), k = i % (L::kTapCount + 1);
    const int c = c0 + l;
    if (c >= g.chans) continue;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < L::kSets; ++j) s += sums[(j * (L::kTapCount + 1) + k) * kWPitch + l];
    if (k < L::kTapCount) {
      partial[(part * g.chans + c) * L::kTapCount + k] = s;
    } else {
      bias_partial[part * g.chans + c] = s;
    }
  }
}

// Weight gradient, second pass: dw[c][tap] and dbias[c] (when given) as sums over the partials in order.
__global__ void depthwise_conv_wgrad_sum(const float* __restrict__ partial, const float* __restrict__ bias_partial,
                                         float* __restrict__ dw, float* __restrict__ dbias, int parts, int chans,
                                         int taps) {
  const long long n = (long long)chans * taps;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    float s = 0.f;
    for (int p = 0; p < parts; ++p) s += partial[p * n + i];
    dw[i] = s;
  } else if (dbias != nullptr && i < n + chans) {
    const long long c = i - n;
    float s = 0.f;
    for (int p = 0; p < parts; ++p) s += bias_partial[p * (long long)chans + c];
    dbias[c] = s;
  }
}

// The geometry of a call, or false for sizes it refuses.
template <int K0>
bool geometry(Geometry& g, int batch, int chans, const int* size, const long long* in_stride,
              const long long* out_stride, int in_vec, int out_vec) {
  using L = Tile<K0>;
  if (batch <= 0 || chans <= 0 || size[0] <= 0 || size[1] <= 0 || size[2] <= 0) return false;
  if (K0 == 1 && size[0] != 1) return false;
  const int tile[3] = {L::kTX, L::kTY, kTZ};
  g.batch = batch;
  g.chans = chans;
  for (int i = 0; i < 3; ++i) {
    g.size[i] = size[i];
    g.tiles[i] = (size[i] + tile[i] - 1) / tile[i];
  }
  for (int i = 0; i < 4; ++i) {
    g.in_stride[i] = in_stride[i];
    g.out_stride[i] = out_stride[i];
  }
  g.in_vec = in_vec;
  g.out_vec = out_vec;
  return true;
}

template <typename T, int K0>
int launch_fwd(const void* in, const float* weight, const float* bias, void* out, int batch, int chans,
               const int* size, const long long* in_stride, const long long* out_stride, int in_vec,
               int flip, cudaStream_t st) {
  Geometry g;
  if (!geometry<K0>(g, batch, chans, size, in_stride, out_stride, in_vec, 0)) return -1;
  constexpr int kSmem = Smem<T, K0>::kFwd;
  cudaError_t err = cudaFuncSetAttribute(depthwise_conv_fwd<T, K0>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(g.tiles[0] * g.tiles[1] * g.tiles[2], (chans + kLanes - 1) / kLanes, batch);
  depthwise_conv_fwd<T, K0><<<grid, Tile<K0>::kFwdThreads, kSmem, st>>>(static_cast<const T*>(in), weight, bias,
                                                                        static_cast<T*>(out), g, flip);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int K0>
int launch_wgrad(const void* in, const void* grad, float* partial, float* bias_partial, float* dw, float* dbias,
                 int batch, int chans, const int* size, const long long* in_stride, const long long* grad_stride,
                 int in_vec, int grad_vec, int samples_per_block, cudaStream_t st) {
  Geometry g;
  if (!geometry<K0>(g, batch, chans, size, in_stride, grad_stride, in_vec, grad_vec)) return -1;
  if (samples_per_block <= 0) return -1;
  constexpr int kSmem = Smem<T, K0>::kGrad;
  cudaError_t err = cudaFuncSetAttribute(depthwise_conv_wgrad<T, K0>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int runs = (batch + samples_per_block - 1) / samples_per_block;
  const dim3 grid(g.tiles[0] * g.tiles[1] * g.tiles[2], (chans + kLanes - 1) / kLanes, runs);
  depthwise_conv_wgrad<T, K0><<<grid, Tile<K0>::kGradThreads, kSmem, st>>>(
      static_cast<const T*>(in), static_cast<const T*>(grad), partial, bias_partial, g, samples_per_block);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int parts = static_cast<int>(grid.x) * runs;
  const long long n = (long long)chans * (Tile<K0>::kTapCount + 1);
  depthwise_conv_wgrad_sum<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(partial, bias_partial, dw, dbias, parts,
                                                                         chans, Tile<K0>::kTapCount);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The output tile of one block, (x, y, z), for the kernel's extent k0 along x (5: 3-D, 1: 2-D), written to
// tile[0..2]. Returns 0, or -1 for another k0.
extern "C" int cinema_depthwise_conv_tile(int k0, int* tile) {
  if (k0 != 5 && k0 != 1) return -1;
  tile[0] = k0 == 5 ? Tile<5>::kTX : Tile<1>::kTX;
  tile[1] = k0 == 5 ? Tile<5>::kTY : Tile<1>::kTY;
  tile[2] = kTZ;
  return 0;
}

// The forward (or, with flip = 1 and no bias, the data gradient) of one call: in and out are (batch, x, y, z,
// channels) with the given element strides, channels contiguous; a 2-D image is (1, H, W) with k0 = 1. weight
// is the f32 filter [chans][k0 * 25] (read tap-reversed with flip) and bias f32 [chans] or null, both rounded
// to the input's dtype here. dtype 0: f32, 1: bf16. Returns
// cudaGetLastError() after the launch, or -1 for arguments it refuses.
extern "C" int cinema_depthwise_conv_fwd(const void* in, const float* weight, const float* bias, void* out,
                                         int dtype, int k0, int batch, int chans, const int* size,
                                         const long long* in_stride, const long long* out_stride, int in_vec,
                                         int flip, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto launcher) {
    return launcher(in, weight, bias, out, batch, chans, size, in_stride, out_stride, in_vec, flip, st);
  };
  if (dtype == 1 && k0 == 5) return launch(launch_fwd<__nv_bfloat16, 5>);
  if (dtype == 1 && k0 == 1) return launch(launch_fwd<__nv_bfloat16, 1>);
  if (dtype == 0 && k0 == 5) return launch(launch_fwd<float, 5>);
  if (dtype == 0 && k0 == 1) return launch(launch_fwd<float, 1>);
  return -1;
}

// The weight gradient of one call: in (the forward's input) and grad (its output's gradient) as above;
// partial holds f32 [runs * tiles][chans][k0 * 25] and bias_partial [runs * tiles][chans], with
// runs = ceil(batch / samples_per_block); dw gets f32 [chans][k0 * 25], dbias (null: not computed) [chans].
extern "C" int cinema_depthwise_conv_wgrad(const void* in, const void* grad, float* partial, float* bias_partial,
                                           float* dw, float* dbias, int dtype, int k0, int batch, int chans,
                                           const int* size, const long long* in_stride,
                                           const long long* grad_stride, int in_vec, int grad_vec,
                                           int samples_per_block, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto launcher) {
    return launcher(in, grad, partial, bias_partial, dw, dbias, batch, chans, size, in_stride, grad_stride, in_vec,
                    grad_vec, samples_per_block, st);
  };
  if (dtype == 1 && k0 == 5) return launch(launch_wgrad<__nv_bfloat16, 5>);
  if (dtype == 1 && k0 == 1) return launch(launch_wgrad<__nv_bfloat16, 1>);
  if (dtype == 0 && k0 == 5) return launch(launch_wgrad<float, 5>);
  if (dtype == 0 && k0 == 1) return launch(launch_wgrad<float, 1>);
  return -1;
}
