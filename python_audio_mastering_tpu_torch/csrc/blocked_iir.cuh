// The fp32 blocked-IIR tile loop of the kweight_cells kernel, its only
// user until K4 moves to the tensor-core product of tf32_product.cuh, as
// front_chain, band_energies and band_gain_apply have.
//
// A block of L samples of a biquad cascade is recomputed from its incoming
// cascade state as one product:
//
//     y_blk = x_blk @ T + s_in @ Wt        T (L, L), Wt (S, L)
//
// which is a single GEMM over the augmented depth K = L + S:
// A = [x_blk | s_in], B = [T ; Wt].  This header computes that
// product for one tile of kTileRows rows and leaves it in shared memory,
// where the kernel's epilogue reads it.
//
// What bounds it on the H100: per output sample the product does L + S
// FMAs and moves 8-12 bytes, ~100 FMAs per byte, far above the ~20 FMAs
// per byte at which fp32 CUDA-core work (67 TFLOP/s) meets 3.35 TB/s.  So
// it is bound by the fp32 FMA rate.  It stays in full fp32 (no TF32 mma):
// reduced-precision dots put 0.105 max abs error on the chain on the TPU.
// The design keeps the FMA loop fed from shared memory: each thread owns
// 4 rows x L/32 columns in registers, reads its 4 A values as one
// broadcast float4 and its columns conflict-free (lane-strided), so a
// k-step is 4·L/32 FMAs for 1 + L/32 shared loads; T's zero triangle is
// skipped and the k-tiles are double-buffered (see blocked_iir_tile).
//
// Rows of a tile are (block, channel) pairs, t = bl * C + c, for the
// blocks b0 .. b0 + br - 1 of a group, so every channel of a block is in
// the same CTA: the bucket sums couple columns and stay inside the CTA.
// Rows past the last block are loaded as zeros and never stored.
#pragma once

#include <cuda_runtime.h>

namespace pam {

constexpr int kThreads = 256;   // 8 row groups (ty) x 32 column lanes (tx)
constexpr int kTileRows = 32;   // each thread owns 4 of them
constexpr int kBK = 16;         // depth of one k-tile
constexpr int kAStride = kTileRows + 4;  // padded, keeps float4 alignment

template <int L>
struct TileSmem {
  // two stages of [A tile (kBK x kAStride) | B tile (kBK x L)]
  static constexpr int kStageFloats = kBK * kAStride + kBK * L;
  static constexpr int kMainFloats = 2 * kStageFloats;
  static constexpr int kEpiFloats = kTileRows * L;
  static constexpr size_t kBytes =
      sizeof(float) * (kMainFloats > kEpiFloats ? kMainFloats : kEpiFloats);
};

// y = [x | s_in] @ [T ; Wt] for rows (b0 .. b0+br-1) x (0 .. C-1).
// `smem` holds TileSmem<L>::kBytes.  On return smem[t * L + j] holds row
// t, column j of the tile (rows past the last block hold zeros), and the
// block is synchronised.
//   x     (C, nb, L)   raw rows
//   t     (L, L)       zero-state response operator (causal: T[k][j] = 0
//                      for j < k)
//   wt    (S, L)       state-correction operator, transposed
//   s_in  (C, nb, S)   incoming cascade states
//
// The k-tiles are double-buffered: the next tile's global loads are in
// flight in registers while the current one is multiplied from shared
// memory, with one barrier per k-tile.  T is causal, so in the k-tile
// starting at k0 every column below k0 is zero: those columns are neither
// loaded nor multiplied (a warp skips a column group when all its 32
// columns lie below k0), which halves the FMAs of the x @ T part.
template <int L>
__device__ __forceinline__ void blocked_iir_tile(
    const float* __restrict__ x, const float* __restrict__ t,
    const float* __restrict__ wt, const float* __restrict__ s_in,
    int C, int nb, int S, int b0, int br, float* smem) {
  static_assert(L % 32 == 0, "L must be a multiple of 32");
  constexpr int TN = L / 32;
  constexpr int kAPer = kTileRows * kBK / kThreads;
  constexpr int kBPer = kBK * L / kThreads;
  static_assert(kAPer * kThreads == kTileRows * kBK, "A tile split");
  static_assert(kBPer * kThreads == kBK * L, "B tile split");
  const int tid = threadIdx.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;
  const int rows = br * C;
  const int K = L + S;

  float ra[kAPer];
  float rb[kBPer];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kAPer; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kBK;
      const int k = k0 + e % kBK;
      const int b = b0 + r / C;
      float v = 0.f;
      if (r < rows && b < nb && k < K) {
        const size_t row = (size_t)(r % C) * nb + b;
        v = k < L ? x[row * L + k] : s_in[row * S + (k - L)];
      }
      ra[i] = v;
    }
#pragma unroll
    for (int i = 0; i < kBPer; ++i) {
      const int e = tid + i * kThreads;
      const int k = k0 + e / L;
      const int j = e % L;
      float v = 0.f;
      if (k < L) {
        if (j >= k0) v = t[(size_t)k * L + j];
      } else if (k < K) {
        v = wt[(size_t)(k - L) * L + j];
      }
      rb[i] = v;
    }
  };
  // stored apart from load(), so that the loads stay in flight across the
  // multiply of the previous tile
  auto store = [&](int stage) {
    float* As = smem + stage * TileSmem<L>::kStageFloats;
    float* Bs = As + kBK * kAStride;
#pragma unroll
    for (int i = 0; i < kAPer; ++i) {
      const int e = tid + i * kThreads;
      As[(e % kBK) * kAStride + e / kBK] = ra[i];
    }
#pragma unroll
    for (int i = 0; i < kBPer; ++i) Bs[tid + i * kThreads] = rb[i];
  };

  float acc[4][TN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  load(0);
  store(0);
  __syncthreads();
  int stage = 0;
  for (int k0 = 0; k0 < K; k0 += kBK) {
    const bool more = k0 + kBK < K;
    if (more) load(k0 + kBK);
    const float* As = smem + stage * TileSmem<L>::kStageFloats;
    const float* Bs = As + kBK * kAStride;
    const bool dense = k0 >= L;  // the Wt rows have no zero triangle
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a =
          *reinterpret_cast<const float4*>(&As[kk * kAStride + ty * 4]);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        if (dense || 32 * j + 32 > k0) {
          const float b = Bs[kk * L + tx + 32 * j];
          acc[0][j] = fmaf(a.x, b, acc[0][j]);
          acc[1][j] = fmaf(a.y, b, acc[1][j]);
          acc[2][j] = fmaf(a.z, b, acc[2][j]);
          acc[3][j] = fmaf(a.w, b, acc[3][j]);
        }
      }
    }
    if (more) store(stage ^ 1);
    __syncthreads();
    stage ^= 1;
  }

  // the tile buffers are dead: the result tile reuses their shared memory
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      smem[(ty * 4 + i) * L + tx + 32 * j] = acc[i][j];
  __syncthreads();
}

// Set the dynamic shared memory the kernel needs and launch it on `stream`.
// Returns cudaGetLastError() after the launch.
template <typename Kernel, typename... Args>
int launch_tile_kernel(Kernel kernel, size_t smem_bytes, int grid,
                       void* stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem_bytes, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace pam

// Dispatch a runtime block size to the template instantiations.
#define PAM_DISPATCH_L(L_RUNTIME, FN, ...)                         \
  switch (L_RUNTIME) {                                             \
    case 128: return FN<128>(__VA_ARGS__);                         \
    case 256: return FN<256>(__VA_ARGS__);                         \
    case 384: return FN<384>(__VA_ARGS__);                         \
    case 512: return FN<512>(__VA_ARGS__);                         \
    default: return (int)cudaErrorInvalidValue;                    \
  }
