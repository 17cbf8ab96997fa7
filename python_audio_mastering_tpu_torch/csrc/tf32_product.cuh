// The blocked-IIR product of a tile on the tensor cores, in 3xTF32, for
// one filter (front_chain) or the two crossover filters (band_energies,
// band_gain_apply).
//
// A block of L samples of a biquad cascade is recomputed from its incoming
// cascade state as one product, y_blk = x_blk @ T + s_in @ Wt (T (L, L)
// causal, Wt (S, L) the transposed state operator).  With F filters over
// the same rows it is one product of depth K = L + F·S:
//
//     F = 1:   y            = [x_blk | s] @ [ T  ]
//                                            [ Wt ]
//
//     F = 2:   [low | high] = [x_blk | s_lp | s_hp] @ [ T_lp  T_hp ]
//                                                     [ W_lp   0   ]
//                                                     [  0    W_hp ]
//
// product_tile_tf32<F> computes kGM rows and 2·kGN output columns, j0 ..
// j0 + 2·kGN - 1 of the one filter (F = 1) or j0 .. j0 + kGN - 1 of each
// band (F = 2), and leaves them in shared memory for the kernel's
// epilogue.  Either way the 8 warps hold the same 32 x 64 warp tiles.
//
// What bounds it on the H100: L(L+1)/2 + F·S·L multiply-adds a filter and
// row (T's zero triangle skipped), ~75 000 at L = 384, against 8-12 bytes
// of signal a row and column: the products.  They run on the tensor cores
// (mma.sync.m16n8k8.tf32), which TF32 alone would leave at ~3 decimal
// digits: reduced-precision products put 0.105 max abs error on the chain
// on the TPU.  So every fp32 operand v is split into a TF32 big part and
// the TF32 rounding of the rest, v = big + small, and a product takes
// three MMAs, small·big + big·small + big·big, accumulated in fp32 (the
// small·small term, ~2^-22 relative, is dropped, see split_tf32): close
// to fp32 accuracy at a third of the TF32 rate (495 / 3 TFLOP/s dense
// against 67 for fp32 on the CUDA cores).
//
// Why mma.sync and not wgmma: TF32 wgmma wants both operands K-major in
// shared memory with swizzled descriptors and 64-row warpgroup tiles; the
// m16n8k8 fragments are plain per-lane registers loaded from padded,
// conflict-free shared-memory tiles, which keeps the split into big and
// small parts a few register instructions beside each fragment load.
//
// Staging: a ring of kGStages tiles in shared memory, filled with cp.async
// (16-byte copies, rows past the last block zero-filled) kGStages - 1
// tiles ahead of the MMAs.  T is causal (T[k][j] = 0 for j < k), so the
// tile's columns need only the rows k < (last column + 1) of T: the other
// k-tiles are never loaded or multiplied, and at F = 1 the warps of the
// left 64 columns also skip the k-tiles that are zero for them alone.
// The states and W come first, as one short tile (F·S rows, padded to 8)
// staged before the loop, so that its staging (plain loads and stores)
// takes no registers beside the live accumulators.
// A CTA holds kGM = 128 rows, so each operator tile it loads from L2
// serves 128 rows (the fp32 tile loop that K1-K4 ran first served 32).
//
// The states term in fp32 (kFp32States, one filter): where W is large
// beside the result, its 3xTF32 rounding dominates the product's error.
// The K-weighting's near-unit-circle poles give max |Wt| ~70 against
// |y| ~1, and 3xTF32 s_in @ Wt then errs by ~1.3e-5 of the max, x @ T by
// ~1e-6 (tests/test_torch_tf32.py).  With kFp32States the states tile is
// not multiplied on the tensor cores: once the x @ T tile is in shared
// memory, s_in @ Wt (F·S <= 16 multiply-adds an element, ~2 % of the
// product at S = 4, L = 384) is added to it with fmaf on the CUDA cores.
//
// cp.async copies the signal raw, so a transform of x (front_chain's
// exciter) cannot ride on the copy: each thread applies `xop` in place to
// the 16-byte chunks of the A tile that it copied itself, after its own
// wait for that stage and before the barrier that hands the stage to the
// MMAs.  The states tile is never transformed.
//
// Rows of a tile are (block, channel) pairs, t = bl * C + c, for the
// blocks b0 .. b0 + br - 1, so every channel of a block is in the CTA and
// the epilogues' channel couplings (width, means) stay inside it.  Rows
// past the last block are loaded as zeros and never stored.  A row's
// offset in x is (c·nb + b)·L in 64 bits: the callers refuse only C·nb >=
// 2^31 rows, ~1 TiB of signal, which no card can address.
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace pam {

constexpr int kGM = 128;        // rows of a tile
constexpr int kGWarpsM = kGM / 32;          // row groups of 32 rows
constexpr int kGThreads = 64 * kGWarpsM;    // 2 warps of 64 columns a group
constexpr int kGN = 64;         // output columns of a warp tile
constexpr int kGK = 32;         // depth of a stage
constexpr int kGStages = 3;
constexpr int kGAStride = kGK + 4;        // A tile row: conflict-free frags
constexpr int kGBStride = 2 * kGN + 8;    // B tile row: conflict-free frags
constexpr int kGEStride = 2 * kGN + 4;    // result tile row
constexpr int kGStageFloats = kGM * kGAStride + kGK * kGBStride;
constexpr int kGStateDepth = 16;  // F·S <= 16: the states tile <= 2 k-steps
// the ring, then the row index of every tile row
constexpr size_t kGSmemBytes =
    sizeof(float) * kGStages * kGStageFloats + sizeof(int) * kGM;
constexpr int kGRingFloats = kGStages * kGStageFloats;
static_assert(kGM * kGEStride <= kGRingFloats,
              "the result tile reuses the ring");
// the fp32 states term's operands beside the result tile, in the ring
static_assert(kGM * kGEStride + (kGM + 2 * kGN) * kGStateDepth <=
                  kGRingFloats,
              "the states and W fit in the ring beside the result tile");

constexpr uint32_t kTf32Mask = 0xffffe000u;  // sign, exponent, 10 bits

// v = big + small + r, big and small TF32 (low 13 bits zero): big is v
// rounded to TF32 (to nearest, ties away from zero: add half of TF32's
// last place to the bits, then cut), v - big is exact in fp32, and small
// is it cut to TF32, |r| <= 2^-11 |v - big| <= 2^-22 |v|.  Integer ops
// only: cvt.rna.tf32 runs on the slower conversion pipe, and the splits
// of every fragment load went through it.
__device__ __forceinline__ void split_tf32(float v, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(v) + 0x1000u) & kTf32Mask;
  small = __float_as_uint(v - __uint_as_float(big)) & kTf32Mask;
}

// d += a (16x8, row) * b (8x8, col), TF32 in, fp32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16-byte global -> shared copy; src_bytes 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The signal as it is copied (no transform of x; never called).
struct RawX {
  __device__ __forceinline__ float operator()(float v) const { return v; }
};

// F filters' product for rows (b0 .. b0+br-1) x (0 .. C-1) and the
// columns above.  On return smem[t * kGEStride + n] holds row t, column n
// of the result tile (F = 1: output column j0 + n; F = 2: column j0 + n %
// kGN of band n / kGN, 0 low, 1 high), and the block is synchronised.
//   x        (C, nb, L)   raw rows (16-byte aligned, L % 4 == 0)
//   t        (F, L, L)    zero-state operators (causal; 16-byte aligned)
//   wt       (F, S, L)    state operators, transposed
//   s0, s1   (C, nb, S)   incoming states of filter 0 and 1 (s1 unused
//                         at F = 1)
//   xop      RawX, or a functor float -> float applied to every element
//            of x (not to the states) before it enters the product
//   kFp32States  s0 @ Wt in fp32 on the CUDA cores, added to the 3xTF32
//            x @ T tile (F = 1 only; see the note above)
// `smem` holds kGSmemBytes.
template <int F, typename XOp, bool kFp32States = false>
__device__ __forceinline__ void product_tile_tf32(
    const float* __restrict__ x, const float* __restrict__ t,
    const float* __restrict__ wt, const float* __restrict__ s0,
    const float* __restrict__ s1, int C, int nb, int L, int S, int b0,
    int br, int j0, XOp xop, float* smem) {
  static_assert(F == 1 || F == 2, "one or two filters");
  static_assert(F == 1 || !kFp32States, "the fp32 states term: one filter");
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp % kGWarpsM;  // rows wm * 32 .. wm * 32 + 31
  const int wn = warp / kGWarpsM;  // result tile columns wn * kGN ..
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int rows = br * C;
  // k-tiles of T with nonzero columns in the tile, and in this warp's
  const int n_x = (j0 + (3 - F) * kGN) / kGK;
  const int n_x_warp = F == 1 ? (j0 + (wn + 1) * kGN) / kGK : n_x;
  const int n_tiles = n_x + 1;       // + the states tile
  const int ks_states = (F * S + 7) / 8;

  // The (channel, block) row of every tile row (-1 past the last block),
  // worked out once, since a row's channel and block take divisions by C;
  // kept in shared memory, where it costs no registers.
  int* row_idx = reinterpret_cast<int*>(smem + kGRingFloats);
  for (int r = tid; r < kGM; r += kGThreads)
    row_idx[r] = r < rows && b0 + r / C < nb ? (r % C) * nb + b0 + r / C : -1;
  __syncthreads();
  constexpr int kAChunks = kGM * kGK / 4 / kGThreads;
  const int q_a = tid % (kGK / 4);  // this thread's 16-byte chunk of a row

  auto stage_x = [&](int xt, int stage) {  // x k-tile xt
    float* As = smem + stage * kGStageFloats;
    float* Bs = As + kGM * kGAStride;
    const int k0 = xt * kGK;
    // rolled: the copies' addresses, unrolled beside the accumulators,
    // spill at 128 registers
#pragma unroll 1
    for (int i = 0; i < kAChunks; ++i) {
      const int r = (tid + i * kGThreads) / (kGK / 4);
      const int row = row_idx[r];
      cp_async16(As + r * kGAStride + 4 * q_a,
                 row >= 0 ? x + (size_t)row * L + k0 + 4 * q_a : x,
                 row >= 0 ? 16 : 0);
    }
#pragma unroll 1
    for (int i = 0; i < kGK * 2 * kGN / 4 / kGThreads; ++i) {
      const int e = tid + i * kGThreads;
      const int kr = e / (2 * kGN / 4);
      const int n = 4 * (e % (2 * kGN / 4));
      const int f = F == 2 ? n / kGN : 0;
      const int col = F == 2 ? n % kGN : n;
      cp_async16(Bs + kr * kGBStride + n,
                 t + (size_t)f * L * L + (size_t)(k0 + kr) * L + j0 + col,
                 16);
    }
  };
  // the states tile: [s0 | s1] @ blockdiag(W_0, W_1)
  auto stage_states = [&](int stage) {
    float* As = smem + stage * kGStageFloats;
    float* Bs = As + kGM * kGAStride;
    const int kd = 8 * ks_states;
    for (int e = tid; e < kGM * kd; e += kGThreads) {
      const int r = e / kd;
      const int k = e % kd;
      const int row = row_idx[r];
      float v = 0.f;
      if (row >= 0 && k < F * S)
        v = k < S ? s0[(size_t)row * S + k] : s1[(size_t)row * S + k - S];
      As[r * kGAStride + k] = v;
    }
    for (int e = tid; e < kd * 2 * kGN; e += kGThreads) {
      const int k = e / (2 * kGN);
      const int n = e % (2 * kGN);
      const int f = F == 2 ? n / kGN : 0;
      const int col = F == 2 ? n % kGN : n;
      float v = 0.f;  // wt row k is filter 0's row k (k < S), else 1's
      if (k < F * S && (k >= S) == (f == 1))
        v = wt[(size_t)k * L + j0 + col];
      Bs[k * kGBStride + n] = v;
    }
  };

  // xop on the chunks of x this thread copied into `stage`
  auto transform_own = [&](int stage) {
    float* As = smem + stage * kGStageFloats;
#pragma unroll 1  // beside the live accumulators, one chunk at a time
    for (int i = 0; i < kAChunks; ++i) {
      const int r = (tid + i * kGThreads) / (kGK / 4);
      float4* p = reinterpret_cast<float4*>(As + r * kGAStride + 4 * q_a);
      float4 v = *p;
      v.x = xop(v.x);
      v.y = xop(v.y);
      v.z = xop(v.z);
      v.w = xop(v.w);
      *p = v;
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  auto compute = [&](int stage, int ksteps) {
    const float* As = smem + stage * kGStageFloats;
    const float* Bs = As + kGM * kGAStride;
#pragma unroll 1  // unrolled, the fragments of two k-steps spill
    for (int ks = 0; ks < ksteps; ++ks) {
      uint32_t ab[2][4], as[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* a =
            As + (wm * 32 + mt * 16 + g) * kGAStride + ks * 8 + tg;
        split_tf32(a[0], ab[mt][0], as[mt][0]);
        split_tf32(a[8 * kGAStride], ab[mt][1], as[mt][1]);
        split_tf32(a[4], ab[mt][2], as[mt][2]);
        split_tf32(a[8 * kGAStride + 4], ab[mt][3], as[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float* b =
            Bs + (ks * 8 + tg) * kGBStride + wn * kGN + nt * 8 + g;
        uint32_t bb[2], bs[2];
        split_tf32(b[0], bb[0], bs[0]);
        split_tf32(b[4 * kGBStride], bb[1], bs[1]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_tf32(acc[mt][nt], as[mt], bb);
          mma_tf32(acc[mt][nt], ab[mt], bs);
          mma_tf32(acc[mt][nt], ab[mt], bb);
        }
      }
    }
  };

  // tile 0 is the states tile (empty with kFp32States), tiles 1 .. n_x
  // the x k-tiles
  if constexpr (!kFp32States) stage_states(0);
  cp_async_commit();
  stage_x(0, 1);
  cp_async_commit();
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kGStages - 2>();
    if constexpr (!std::is_same_v<XOp, RawX>) {
      if (i > 0) transform_own(i % kGStages);
    }
    __syncthreads();
    const int next = i + kGStages - 1;
    if (next < n_tiles) stage_x(next - 1, next % kGStages);
    cp_async_commit();
    if ((F == 2 || i == 0 || i - 1 < n_x_warp) && !(kFp32States && i == 0))
      compute(i % kGStages, i == 0 ? ks_states : kGK / 8);
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: reuse it

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int r = wm * 32 + mt * 16 + g;
      const int c = wn * kGN + nt * 8 + 2 * tg;
      *reinterpret_cast<float2*>(smem + r * kGEStride + c) =
          make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(smem + (r + 8) * kGEStride + c) =
          make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  __syncthreads();

  if constexpr (kFp32States) {
    // y += s0 @ Wt: the states (kGM, S) and Wt's tile columns (S, 2·kGN)
    // staged beside the result tile, then S fmaf an element
    float* ss = smem + kGM * kGEStride;
    float* ws = ss + kGM * kGStateDepth;
    for (int e = tid; e < kGM * S; e += kGThreads) {
      const int row = row_idx[e / S];
      ss[e] = row >= 0 ? s0[(size_t)row * S + e % S] : 0.f;
    }
    for (int e = tid; e < S * 2 * kGN; e += kGThreads)
      ws[e] = wt[(size_t)(e / (2 * kGN)) * L + j0 + e % (2 * kGN)];
    __syncthreads();
    for (int e = tid; e < kGM * 2 * kGN; e += kGThreads) {
      const int r = e / (2 * kGN);
      const int n = e % (2 * kGN);
      float v = 0.f;
      for (int k = 0; k < S; ++k)
        v = fmaf(ss[r * S + k], ws[k * 2 * kGN + n], v);
      smem[r * kGEStride + n] += v;
    }
    __syncthreads();
  }
}

}  // namespace pam
