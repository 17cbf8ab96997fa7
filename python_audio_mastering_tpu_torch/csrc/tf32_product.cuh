// The crossover bands of a tile on the tensor cores, in 3xTF32.
//
// A block of L samples of a biquad cascade is recomputed from its incoming
// cascade state as one product (blocked_iir.cuh).  The crossover runs two
// cascades over the same rows, so both become one product of depth
// K = L + 2S and width 2L:
//
//     [low | high] = [x_blk | s_lp | s_hp] @ [ T_lp  T_hp ]
//                                            [ W_lp   0   ]
//                                            [  0    W_hp ]
//
// (W the transposed state operators wt2.)  crossover_tile_tf32 computes
// the tile of kGM rows and output columns j0 .. j0 + kGN - 1 of both bands
// and leaves it in shared memory for the kernel's epilogue.
//
// What bounds it on the H100: ~150 000 multiply-adds per row, ~12.5 GFLOP
// for a 3-min stereo track, against ~170 MB of the kernel's own traffic:
// the products.  They run on the tensor cores (mma.sync.m16n8k8.tf32),
// which TF32 alone would leave at ~3 decimal digits: reduced-precision
// products put 0.105 max abs error on the chain on the TPU.  So every
// fp32 operand v is split into a TF32 big part and the TF32 rounding of
// the rest, v = big + small, and a product takes three MMAs, small·big +
// big·small + big·big, accumulated in fp32 (the small·small term, ~2^-22
// relative, is dropped, see split_tf32): close to fp32 accuracy at a
// third of the TF32 rate (495 / 3 TFLOP/s dense against 67 for fp32 on
// the CUDA cores).
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
// column tile j0 .. j0 + kGN - 1 needs only the rows k < j0 + kGN of T:
// the other k-tiles are never loaded or multiplied.  The states and W
// come last as one short tile (2S rows, padded to 8).  A CTA holds kGM =
// 128 rows, so each operator tile it loads from L2 serves 128 rows (the
// fp32 loop of blocked_iir.cuh serves 32).
//
// Rows of a tile are (block, channel) pairs, t = bl * C + c, for the
// blocks b0 .. b0 + br - 1, so every channel of a block is in the CTA and
// the epilogue's channel mean stays inside it.  Rows past the last block
// are loaded as zeros and never stored.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace pam {

constexpr int kGM = 128;        // rows of a tile
constexpr int kGWarpsM = kGM / 32;          // row groups of 32 rows
constexpr int kGThreads = 64 * kGWarpsM;    // a warp per row group and band
constexpr int kGN = 64;         // output columns of a tile (each band)
constexpr int kGK = 32;         // depth of a stage
constexpr int kGStages = 3;
constexpr int kGAStride = kGK + 4;        // A tile row: conflict-free frags
constexpr int kGBStride = 2 * kGN + 8;    // B tile row: conflict-free frags
constexpr int kGEStride = 2 * kGN + 4;    // result tile row
constexpr int kGStageFloats = kGM * kGAStride + kGK * kGBStride;
constexpr int kGMaxStates = 8;  // 2S <= 16: the state tile is <= 2 k-steps
// the ring, then the x offset of every tile row
constexpr size_t kGSmemBytes =
    sizeof(float) * kGStages * kGStageFloats + sizeof(int) * kGM;
static_assert(kGM * kGEStride <= kGStages * kGStageFloats,
              "the result tile reuses the ring");

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

// Low and high band of rows (b0 .. b0+br-1) x (0 .. C-1), columns j0 ..
// j0 + kGN - 1.  On return smem[t * kGEStride + f * kGN + j] holds row t,
// column j0 + j of band f (0 low, 1 high), and the block is synchronised.
//   x          (C, nb, L)   raw rows (16-byte aligned, L % 4 == 0,
//                           fewer than 2^31 floats)
//   t2         (2, L, L)    zero-state operators T_lp, T_hp (causal)
//   wt2        (2, S, L)    state operators, transposed
//   s_lp, s_hp (C, nb, S)   incoming cascade states
// `smem` holds kGSmemBytes.
__device__ __forceinline__ void crossover_tile_tf32(
    const float* __restrict__ x, const float* __restrict__ t2,
    const float* __restrict__ wt2, const float* __restrict__ s_lp,
    const float* __restrict__ s_hp, int C, int nb, int L, int S, int b0,
    int br, int j0, float* smem) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp % kGWarpsM;  // rows wm * 32 .. wm * 32 + 31
  const int wn = warp / kGWarpsM;  // band: accumulator columns wn * kGN ..
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int rows = br * C;
  const int n_x = (j0 + kGN) / kGK;  // k-tiles of T with nonzero columns
  const int n_tiles = n_x + 1;       // + the states tile
  const int ks_states = (2 * S + 7) / 8;

  // the (channel, block) row of tile row t, and whether it exists
  auto row_of = [&](int t) -> size_t {
    return (size_t)(t % C) * nb + b0 + t / C;
  };
  auto valid = [&](int t) { return t < rows && b0 + t / C < nb; };

  // The offset in x of every tile row (-1 past the last block), worked
  // out once, since a row's channel and block take divisions by C; kept
  // in shared memory, where it costs no registers.
  int* row_off = reinterpret_cast<int*>(smem + kGStages * kGStageFloats);
  for (int t = tid; t < kGM; t += kGThreads)
    row_off[t] = valid(t) ? (int)(row_of(t) * L) : -1;
  __syncthreads();
  constexpr int kAChunks = kGM * kGK / 4 / kGThreads;
  const int q_a = tid % (kGK / 4);  // this thread's 16-byte chunk of a row

  auto stage_tile = [&](int tile, int stage) {
    float* As = smem + stage * kGStageFloats;
    float* Bs = As + kGM * kGAStride;
    if (tile < n_x) {
      const int k0 = tile * kGK;
#pragma unroll
      for (int i = 0; i < kAChunks; ++i) {
        const int t = (tid + i * kGThreads) / (kGK / 4);
        const int off = row_off[t];
        cp_async16(As + t * kGAStride + 4 * q_a,
                   off >= 0 ? x + off + k0 + 4 * q_a : x, off >= 0 ? 16 : 0);
      }
#pragma unroll
      for (int i = 0; i < kGK * 2 * kGN / 4 / kGThreads; ++i) {
        const int e = tid + i * kGThreads;
        const int kr = e / (2 * kGN / 4);
        const int q = e % (2 * kGN / 4);
        const int f = q / (kGN / 4);
        const int c4 = 4 * (q % (kGN / 4));
        cp_async16(Bs + kr * kGBStride + f * kGN + c4,
                   t2 + (size_t)f * L * L + (size_t)(k0 + kr) * L + j0 + c4,
                   16);
      }
    } else {  // the states tile: [s_lp | s_hp] @ [W_lp 0 ; 0 W_hp]
      const int kd = 8 * ks_states;
      for (int e = tid; e < kGM * kd; e += kGThreads) {
        const int t = e / kd;
        const int k = e % kd;
        float v = 0.f;
        if (valid(t) && k < 2 * S)
          v = k < S ? s_lp[row_of(t) * S + k] : s_hp[row_of(t) * S + k - S];
        As[t * kGAStride + k] = v;
      }
      for (int e = tid; e < kd * 2 * kGN; e += kGThreads) {
        const int k = e / (2 * kGN);
        const int n = e % (2 * kGN);
        const int f = n / kGN;
        float v = 0.f;  // wt2 row k is W_lp's row k (k < S), else W_hp's
        if (k < 2 * S && (k >= S) == (f == 1))
          v = wt2[(size_t)k * L + j0 + n % kGN];
        Bs[k * kGBStride + n] = v;
      }
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

#pragma unroll
  for (int s = 0; s < kGStages - 1; ++s) {
    if (s < n_tiles) stage_tile(s, s);
    cp_async_commit();
  }
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kGStages - 2>();
    __syncthreads();
    const int next = i + kGStages - 1;
    if (next < n_tiles) stage_tile(next, next % kGStages);
    cp_async_commit();
    compute(i % kGStages, i < n_x ? kGK / 8 : ks_states);
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
}

}  // namespace pam
