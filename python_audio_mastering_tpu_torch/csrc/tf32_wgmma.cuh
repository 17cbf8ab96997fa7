// The blocked-IIR product of the tensor-core kernels on Hopper's warpgroup
// MMA (wgmma), in 3xTF32, with the states term in fp32: the crossover
// pair of the band kernels (band_energies, band_gain_apply) and the one
// filter of front_chain (the EQ) and kweight_cells (the K-weighting).
//
// A block of L samples of a filter is recomputed from its incoming states
// as
//
//     y_f = x_blk @ T_f + s_f @ W_fᵀ
//
// (T (L, L) causal, W (L, S)).  A tile is 128 rows ((channel, block)
// pairs) by kN columns, kN / kF of each of the kF filters: the band
// kernels' two filters in 64 columns each (band_product), one filter in
// 128 (front_chain) or 64 (kweight_cells) columns (one_product).  The
// product of a persistent grid's tiles is handed, tile by tile, in shared
// memory, to the kernel's epilogue.
//
// What bounds it on the H100: L(L+1)/2 multiply-adds a row and filter for
// x @ T (~74 000 at L = 384), against 8-12 bytes of signal a row and
// column: the tensor cores.  TF32 alone keeps ~3 decimal digits, so the
// product is 3xTF32: every fp32 operand v is split into a TF32 big part
// and the TF32 rest (split_tf32), and a product takes three MMAs,
// small·big + big·small + big·big, summed in fp32 (the small·small term,
// ~2^-22 relative, is dropped): close to fp32 at a third of the TF32 rate
// (495 / 3 TFLOP/s dense against 67 for fp32 on the CUDA cores).
//
// The design:
//  - x @ T runs on wgmma.m64nNk8.f32.tf32.tf32 (N = kN) with A (the
//    signal) in registers: each consumer thread loads its fragments from
//    shared memory and splits them there, in a few integer instructions,
//    after an optional transform of the signal (front_chain's exciter,
//    evaluated in registers once a fragment load).  B (the operator,
//    constant) is split once where it is built (ops/cuda_multiband.py,
//    pack_operator), stored K-major (Tᵀ) with its big and small parts side
//    by side, each k-tile already in the 128-byte-swizzled order that the
//    B descriptor reads, so that one 1-D bulk copy lands a k-tile.  A k8
//    step issues three wgmmas into one accumulator: A_small·B_big,
//    A_big·B_small, A_big·B_big.
//  - A warp-specialised ring of kStages stages, each with a full and an
//    empty mbarrier, filled by one producer thread: the B k-tile (one bulk
//    copy) and the A k-tile (one TMA copy of a box of 32 samples x br
//    blocks x C channels of x (C, nb, L), blocks past nb zero-filled,
//    128-byte swizzled so that the fragment loads meet no bank conflict:
//    one request a stage, where a copy a row would take 128 small ones).
//    Two consumer warpgroups of 64 rows each run the MMAs, given 128
//    registers by setmaxnreg (the producer's warpgroup gives its up).
//  - An epilogue of its own: two more warpgroups add the states term to
//    the products (handed over in shared memory, a tile_full and a
//    tile_empty mbarrier) and run the kernel's epilogue, a warp a row or
//    block and a lane two columns, so that their loads and stores are
//    coalesced, while the consumers run the next tile's products.
//  - A persistent grid: one CTA an SM walks (row tile, column span) items,
//    the spans with the most k-tiles first.  Causal skipping: a column
//    tile ending at column j1 loads and multiplies only the k-tiles below
//    j1 (T[k][j] = 0 for j < k), and the packed operator holds no others.
//  - The states term in fp32: s @ Wᵀ (S multiply-adds an element) is added
//    with fmaf in the epilogue.  The crossovers' state operators reach
//    ~4e4 and the K-weighting's ~70 times the signal, and their 3xTF32
//    rounding dominated the all-3xTF32 product's error
//    (tests/test_torch_tf32.py).
//
// Rows of a tile are (channel, block) pairs in the TMA box's order, t = c
// * br + bl, for the blocks b0 .. b0 + br - 1, so every channel of a block
// is in the tile and the epilogues' channel couplings (sums, width, means)
// stay inside the CTA.  Rows past the last block are zeros, rows past C *
// br (128 % C of them) hold whatever the stage held; no epilogue reads
// either.
#pragma once

#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

namespace pam {
namespace wgb {

constexpr int kRows = 128;               // rows of a tile
constexpr int kCols = 64;                // columns of a band in a tile
constexpr int kN = 2 * kCols;            // wgmma N: both bands
constexpr int kK = 32;                   // a k-tile: one 128-byte swizzle row
constexpr int kStages = 3;
constexpr int kPartBytes = kN * kK * 4;  // a k-tile of B, big or small
constexpr int kBBytes = 2 * kPartBytes;  // big, then small
constexpr int kABytes = kRows * kK * 4;  // the A k-tile, 128-byte swizzled
constexpr int kStageBytes = kBBytes + kABytes;
constexpr int kMaxS = 4;                 // states a filter (LR4: 4)
static_assert(kMaxS == 4, "a row's states are one float4");
constexpr int kTStride = kN + 8;         // the result tile's row, floats
// warpgroups: the producer (one thread), two consumers, two for the
// epilogue; registers a thread: 96 at launch, which the epilogue keeps,
// then 24 for the producer's and 128 for the consumers' (setmaxnreg; an
// increase is served only from what the CTA's decreases free)
constexpr int kThreads = 640;
constexpr int kConsumers = 256;
constexpr int kEpilogue = 256;
constexpr int kEpiWarps = kEpilogue / 32;
constexpr int kLaunchRegs = 96;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 128;
// shared memory, from a 1024-byte aligned base: the ring, the result
// tile, the item's states (f, tile row, k), a scratch of 3 x kCols floats
// an epilogue warp and 2 x 3 x kRows carried sums (band_energies'), the
// barriers
constexpr int kTileOff = kStages * kStageBytes;
constexpr int kStatesOff = kTileOff + kRows * kTStride * 4;
constexpr int kScratchOff = kStatesOff + 2 * kRows * kMaxS * 4;
constexpr int kCarryOff = kScratchOff + kEpiWarps * 3 * kCols * 4;
constexpr int kBarOff = kCarryOff + 2 * 3 * kRows * 4;
constexpr int kBars = 2 * kStages + 2;
constexpr int kSmemBytes = kBarOff + kBars * 8 + 1024;  // + alignment
static_assert(kStageBytes % 1024 == 0 && kBBytes % 1024 == 0,
              "swizzled tiles on 1024-byte boundaries");
static_assert(kSmemBytes <= 232448, "fits the H100's shared memory");
static_assert(kLaunchRegs * kThreads <= 65536 &&
                  (kConsumerRegs - kLaunchRegs) * kConsumers <=
                      (kLaunchRegs - kProducerRegs) * 128,
              "the register file: the consumers' increase is freed first");

// The ring and result tile of a product: kN wgmma columns a tile, kF
// filters side by side in them (kCols = kN / kF columns of each), a ring
// of kStages stages; a column tile jt adds kQ k-tiles to the one before
// it (causal skipping).  Band is the band kernels' (the constants above).
template <int N, int F, int Stages>
struct Shape {
  static constexpr int kN = N;
  static constexpr int kF = F;
  static constexpr int kCols = N / F;
  static constexpr int kQ = kCols / kK;
  static constexpr int kStages = Stages;
  static constexpr int kPartBytes = kN * kK * 4;
  static constexpr int kBBytes = 2 * kPartBytes;
  static constexpr int kStageBytes = kBBytes + kABytes;
  static constexpr int kTStride = kN + 8;
  static constexpr int kTileOff = kStages * kStageBytes;
  static constexpr int kBars = 2 * kStages + 2;
  static_assert(kCols % kK == 0 && (N == 64 || N == 128),
                "whole k-tiles a column tile; wgmma N of 64 or 128");
  static_assert(kStageBytes % 1024 == 0 && kBBytes % 1024 == 0 &&
                    kPartBytes % 1024 == 0,
                "swizzled tiles on 1024-byte boundaries");
};
using Band = Shape<kN, 2, kStages>;
static_assert(Band::kCols == kCols && Band::kBBytes == kBBytes &&
                  Band::kTileOff == kTileOff && Band::kTStride == kTStride,
              "the band kernels' layout");

// The one-filter kernels' shared memory, from a 1024-byte aligned base:
// the ring, the result tile, the item's states (tile row, k < kMaxS1,
// zeros past S), EpiBytes of the kernel's epilogue, the barriers.
// ConsumerRegs and EpilogueRegs: the registers a thread of the consumers
// and of the epilogue warpgroups ask for by setmaxnreg (the launch's 96
// where not more), out of what the producer's warpgroup gives up.
constexpr int kMaxS1 = 16;  // states of one filter (the EQ's 4 sections: 8)
template <int N, int Stages, int EpiBytes, int ConsumerRegs = kConsumerRegs,
          int EpilogueRegs = kLaunchRegs>
struct One : Shape<N, 1, Stages> {
  using Sh = Shape<N, 1, Stages>;
  static constexpr int kConsumerRegs1 = ConsumerRegs;
  static constexpr int kEpilogueRegs1 = EpilogueRegs;
  static constexpr int kStatesOff = Sh::kTileOff + kRows * Sh::kTStride * 4;
  static constexpr int kEpiOff = kStatesOff + kRows * kMaxS1 * 4;
  static constexpr int kBarOff = kEpiOff + EpiBytes;
  static constexpr int kSmemBytes = kBarOff + Sh::kBars * 8 + 1024;
  static_assert(kSmemBytes <= 232448, "fits the H100's shared memory");
  static_assert(ConsumerRegs >= kLaunchRegs && EpilogueRegs >= kLaunchRegs &&
                    (ConsumerRegs - kLaunchRegs) * kConsumers +
                            (EpilogueRegs - kLaunchRegs) * kEpilogue <=
                        (kLaunchRegs - kProducerRegs) * 128,
                "the register file: the increases are freed first");
};

// v = big + small + r, big and small TF32 (low 13 bits zero): big is v
// rounded to TF32 (to nearest, ties away from zero: add half of TF32's
// last place to the bits, then cut), v - big is exact in fp32, and small
// is it cut to TF32, |r| <= 2^-11 |v - big| <= 2^-22 |v|.  Integer ops
// only: cvt.rna.tf32 runs on the slower conversion pipe.
// ops/cuda_multiband.split_tf32 is the same recipe in torch.
constexpr uint32_t kTf32Mask = 0xffffe000u;  // sign, exponent, 10 bits
__device__ __forceinline__ void split_tf32(float v, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(v) + 0x1000u) & kTf32Mask;
  small = __float_as_uint(v - __uint_as_float(big)) & kTf32Mask;
}

// The signal as it is copied (no transform of A).
struct NoX {
  __device__ __forceinline__ float operator()(float v) const { return v; }
};

// The work of a launch: items (row tile, span) of `tiles` column tiles,
// n_rt row tiles of br blocks, n_sp spans.
struct Geometry {
  int C, nb, L, S, h, br, n_rt, n_sp, tiles, items;
};

// What the epilogue knows of a tile: its blocks b0 .. b0 + blocks - 1,
// its columns j0 .. j0 + 63 (the tt-th tile of its span), the products in
// shared memory (row c * br + bl: x @ T_lp at columns 0 .. 63, x @ T_hp at
// 64 .. 127), the item's states, and the epilogue warp (0 .. 7) and lane
// that run it: a warp takes the blocks bl = warp + kEpiWarps * u, a lane
// the columns j0 + 2 lane, + 1, and w holds W's rows at those columns.
struct TileCtx {
  int b0, blocks, j0, tt, warp, lane;
  const float* tile;    // kRows x kTStride floats
  const float* states;  // 2 x kRows x kMaxS floats
  float* scratch;       // 3 x kCols floats of this warp
  float* carry;         // 2 x 3 x kRows floats, kept across a span's tiles
  float2 w[2][kMaxS];   // W_f[j][k] at the lane's columns
};

// --- barriers, copies, wgmma (PTX) ---------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.  A wait
// that cannot end (a broken ring) traps after ~2^26 polls: a launch
// failure, not a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (polls == (1u << 26)) __trap();
  }
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"((uint64_t)src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The box of `map` at coordinates (c0, c1, c2) into shared memory.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

// A B descriptor: K-major, 128-byte swizzle (8 rows of 128 bytes an atom,
// 1024 bytes between 8-row groups), at shared address `addr`.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// Keep the compiler from moving a register's reads or writes across the
// asynchronous MMAs that read or write it.
__device__ __forceinline__ void pin(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void pin(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// d (64 x 128, fp32) += a (64 x 8, TF32, registers) * b (8 x 128, TF32,
// shared memory, K-major)
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d (64 x 64, fp32) += a (64 x 8, TF32, registers) * b (8 x 64, TF32,
// shared memory, K-major)
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// --- the persistent product -----------------------------------------------

__device__ __forceinline__ void item_at(const Geometry& g, int it, int& b0,
                                        int& sp) {
  sp = g.n_sp - 1 - it / g.n_rt;  // the spans with the most k-tiles first
  b0 = (it % g.n_rt) * g.br;
}

// The producer (one thread): every k-tile of every tile of this CTA's
// items into the ring, in the order the consumers take them.  Column tile
// jt holds the k-tiles below its last column, Sh::kQ (jt + 1) of them,
// after the Sh::kQ jt (jt + 1) / 2 of the tiles before it.
template <class Sh>
__device__ __forceinline__ void produce(const CUtensorMap* xmap,
                                        const float* __restrict__ packed,
                                        const Geometry& g, uint8_t* smem,
                                        uint64_t* full, uint64_t* empty) {
  const uint32_t tx = Sh::kBBytes + (uint32_t)(kK * 4 * g.br * g.C);
  int stage = 0;
  uint32_t phase = 0;
  for (int it = blockIdx.x; it < g.items; it += gridDim.x) {
    int b0, sp;
    item_at(g, it, b0, sp);
    for (int tt = 0; tt < g.tiles; ++tt) {
      const int jt = sp * g.tiles + tt;
      const int nk = Sh::kQ * (jt + 1);
      const float* pk = packed + (size_t)(Sh::kQ * jt * (jt + 1) / 2) *
                                     (Sh::kBBytes / 4);
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(empty + stage, phase ^ 1);
        uint8_t* st = smem + stage * Sh::kStageBytes;
        mbar_arrive_tx(full + stage, tx);
        bulk_load(st, pk + (size_t)kt * (Sh::kBBytes / 4), Sh::kBBytes,
                  full + stage);
        tma_load_3d(st + Sh::kBBytes, xmap, kt * kK, b0, 0, full + stage);
        if (++stage == Sh::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  }
}

// The consumers: the products of a tile, then (once the epilogue is done
// with the previous tile) the products into shared memory.  Their work is
// the tensor cores' and the A fragments' (xop, then the split): the states
// term, the gains, the squares, the sums and the stores run on the
// epilogue's warpgroups meanwhile.
template <class Sh, class XOp>
__device__ __forceinline__ void consume(const Geometry& g, uint8_t* smem,
                                        uint64_t* full, uint64_t* empty,
                                        uint64_t* tile_full,
                                        uint64_t* tile_empty, XOp xop) {
  constexpr int kAcc = Sh::kN / 2;  // accumulators a thread
  const int ctid = threadIdx.x - 128;
  const int lane = threadIdx.x % 32;
  const int gq = lane / 4;
  const int tq = lane % 4;
  // this thread's rows of the tile, rbase and rbase + 8, and columns
  // 8 i + 2 tq, + 1 (i < kCols / 8) of each filter
  const int rbase = 64 * (ctid / 128) + 16 * ((ctid / 32) % 4) + gq;
  float* tile = reinterpret_cast<float*>(smem + Sh::kTileOff);
  int stage = 0, done = 0;
  uint32_t phase = 0;
  for (int it = blockIdx.x; it < g.items; it += gridDim.x) {
    int b0, sp;
    item_at(g, it, b0, sp);
    for (int tt = 0; tt < g.tiles; ++tt) {
      const int nk = Sh::kQ * (sp * g.tiles + tt + 1);
      float acc[kAcc];
#pragma unroll
      for (int i = 0; i < kAcc; ++i) {
        acc[i] = 0.f;
        pin(acc[i]);
      }
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(full + stage, phase);
        uint8_t* st = smem + stage * Sh::kStageBytes;
        // row r, column k of the A tile at r * 32 + ((k / 4) ^ (r % 8)) * 4
        // + k % 4; this thread's rows are gq (mod 8)
        const float* as = reinterpret_cast<const float*>(st + Sh::kBBytes) +
                          rbase * kK + tq;
        uint32_t ab[4][4], asm_[4][4];  // big, small: 4 k8 steps
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const float* a0 = as + (((2 * s) ^ gq) << 2);
          const float* a2 = as + (((2 * s + 1) ^ gq) << 2);
          split_tf32(xop(a0[0]), ab[s][0], asm_[s][0]);
          split_tf32(xop(a0[8 * kK]), ab[s][1], asm_[s][1]);
          split_tf32(xop(a2[0]), ab[s][2], asm_[s][2]);
          split_tf32(xop(a2[8 * kK]), ab[s][3], asm_[s][3]);
        }
        wgmma_fence();
        const uint32_t bb = smem_u32(st);
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const uint32_t k8 = 32 * s;  // bytes into the swizzle row
          wgmma_tf32(acc, asm_[s], b_desc(bb + k8));
          wgmma_tf32(acc, ab[s], b_desc(bb + Sh::kPartBytes + k8));
          wgmma_tf32(acc, ab[s], b_desc(bb + k8));
        }
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            pin(ab[s][i]);
            pin(asm_[s][i]);
          }
#pragma unroll
        for (int i = 0; i < kAcc; ++i) pin(acc[i]);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + stage);
        if (++stage == Sh::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      mbar_wait(tile_empty, (done & 1) ^ 1);  // the epilogue is done with it
#pragma unroll
      for (int f = 0; f < Sh::kF; ++f)
#pragma unroll
        for (int rho = 0; rho < 2; ++rho)
#pragma unroll
          for (int i = 0; i < Sh::kCols / 8; ++i) {
            const int a = (kAcc / Sh::kF) * f + 4 * i + 2 * rho;
            *reinterpret_cast<float2*>(
                tile + (rbase + 8 * rho) * Sh::kTStride + Sh::kCols * f +
                8 * i + 2 * tq) = make_float2(acc[a], acc[a + 1]);
          }
      mbar_arrive(tile_full);
      ++done;
    }
  }
}

// The epilogue warpgroups: the item's states into shared memory, then for
// each tile the consumers hand over, W's rows at the lane's columns and
// epi.tile(ctx).  epi adds the states term, s @ Wᵀ, in fp32 (bands_at):
// the crossovers' state operators reach ~4e4, and in 3xTF32 their
// rounding dominated the product's error.
template <class Epi>
__device__ __forceinline__ void finish(const float* __restrict__ wt2,
                                       const float* __restrict__ s_lp,
                                       const float* __restrict__ s_hp,
                                       const Geometry& g, uint8_t* smem,
                                       uint64_t* tile_full,
                                       uint64_t* tile_empty, Epi& epi) {
  const int etid = threadIdx.x - 128 - kConsumers;
  TileCtx t;
  t.warp = etid / 32;
  t.lane = etid % 32;
  t.tile = reinterpret_cast<const float*>(smem + kTileOff);
  float* states = reinterpret_cast<float*>(smem + kStatesOff);
  t.states = states;
  t.scratch = reinterpret_cast<float*>(smem + kScratchOff) +
              t.warp * 3 * kCols;
  t.carry = reinterpret_cast<float*>(smem + kCarryOff);
  // the states this thread stages: filter sf, tile row sr
  const int sf = etid / kRows;
  const int sr = etid % kRows;
  const float* s_f = sf == 0 ? s_lp : s_hp;
  uint32_t tphase = 0;
  for (int it = blockIdx.x; it < g.items; it += gridDim.x) {
    int sp;
    item_at(g, it, t.b0, sp);
    t.blocks = min(g.br, g.nb - t.b0);
    // every epilogue thread is done with the previous item's states
    // before they are overwritten, and these are in before any is read
    const int c = sr / g.br;
    const int bl = sr - c * g.br;
    const bool ok = c < g.C && bl < t.blocks;
    float sv[kMaxS];
#pragma unroll
    for (int k = 0; k < kMaxS; ++k)
      sv[k] = ok && k < g.S
                  ? __ldg(s_f + ((size_t)c * g.nb + t.b0 + bl) * g.S + k)
                  : 0.f;
    asm volatile("bar.sync 2, %0;" ::"n"(kEpilogue) : "memory");
    *reinterpret_cast<float4*>(states + (sf * kRows + sr) * kMaxS) =
        make_float4(sv[0], sv[1], sv[2], sv[3]);
    asm volatile("bar.sync 2, %0;" ::"n"(kEpilogue) : "memory");
    for (t.tt = 0; t.tt < g.tiles; ++t.tt) {
      t.j0 = (sp * g.tiles + t.tt) * kCols;
      const int j = t.j0 + 2 * t.lane;
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int k = 0; k < kMaxS; ++k)
          t.w[f][k] = k < g.S ? __ldg(reinterpret_cast<const float2*>(
                                    wt2 + ((size_t)f * g.S + k) * g.L + j))
                              : make_float2(0.f, 0.f);
      mbar_wait(tile_full, tphase);
      epi.tile(t);
      mbar_arrive(tile_empty);
      tphase ^= 1;
    }
  }
}

// low and high of tile row r at the lane's columns: the products plus the
// states term, s @ Wᵀ, in fp32
__device__ __forceinline__ void bands_at(const TileCtx& t, int r, float2& lo,
                                         float2& hi) {
  const float* p = t.tile + r * kTStride + 2 * t.lane;
  lo = *reinterpret_cast<const float2*>(p);
  hi = *reinterpret_cast<const float2*>(p + kCols);
  const float4 s0 = *reinterpret_cast<const float4*>(t.states + r * kMaxS);
  const float4 s1 =
      *reinterpret_cast<const float4*>(t.states + (kRows + r) * kMaxS);
  const float a[kMaxS] = {s0.x, s0.y, s0.z, s0.w};
  const float b[kMaxS] = {s1.x, s1.y, s1.z, s1.w};
  float2 sl = make_float2(0.f, 0.f), sh = sl;
#pragma unroll
  for (int k = 0; k < kMaxS; ++k) {
    sl.x = fmaf(a[k], t.w[0][k].x, sl.x);
    sl.y = fmaf(a[k], t.w[0][k].y, sl.y);
    sh.x = fmaf(b[k], t.w[1][k].x, sh.x);
    sh.y = fmaf(b[k], t.w[1][k].y, sh.y);
  }
  lo.x += sl.x;
  lo.y += sl.y;
  hi.x += sh.x;
  hi.y += sh.y;
}

// The kernel body: roles, then the ring.  `packed` is the operator of
// crossover_packed (ops/cuda_multiband.py), 16-byte aligned; `xmap` the
// TMA map of x made by rows_map.
template <class Epi>
__device__ __forceinline__ void band_product(
    const CUtensorMap* xmap, const float* __restrict__ packed,
    const float* __restrict__ wt2, const float* __restrict__ s_lp,
    const float* __restrict__ s_hp, const Geometry& g, Epi& epi) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarOff);
  uint64_t* empty = full + kStages;
  uint64_t* tile_full = empty + kStages;
  uint64_t* tile_empty = tile_full + 1;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers / 32);  // a warp of each consumer
    }
    mbar_init(tile_full, kConsumers);
    mbar_init(tile_empty, kEpilogue);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == 0)
      produce<Band>(xmap, packed, g, smem, full, empty);
  } else if (threadIdx.x < 128 + kConsumers) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    consume<Band>(g, smem, full, empty, tile_full, tile_empty, NoX{});
  } else {
    finish(wt2, s_lp, s_hp, g, smem, tile_full, tile_empty, epi);
  }
}

// --- one filter (front_chain, kweight_cells) -------------------------------

// What a one-filter epilogue knows of a tile: its blocks b0 .. b0 + blocks
// - 1, its columns j0 .. j0 + kN - 1 (the tt-th tile of its span), the
// products in shared memory (row c * br + bl), the item's states (zeros
// past S), the epilogue's own shared memory, and the epilogue warp (0 ..
// 7) and lane that run it.  The tile's columns are kN / 64 halves of 64
// columns: a warp takes the half warp % halves and the rows (or blocks)
// first, first + step, .. (first = warp / halves, step = 8 / halves), a
// lane the tile's columns c0, c0 + 1 (c0 = 64 half + 2 lane), and w holds
// Wᵀ's rows at those columns (zeros past S).
struct Tile1 {
  int b0, blocks, j0, tt, warp, lane, c0, first, step, S;
  const float* tile;    // kRows x kTStride floats
  const float* states;  // kRows x kMaxS1 floats
  float* epi;           // the epilogue's EpiBytes
  float2 w[kMaxS1];     // Wᵀ[k][j0 + c0 + (0, 1)]
};

// Tile row r at the lane's columns: the product plus the states term,
// s @ Wᵀ, summed in fp32 (fmaf, k = 0 .. S - 1), then added to it.
template <class Sh>
__device__ __forceinline__ float2 value_at(const Tile1& t, int r) {
  const float2 p =
      *reinterpret_cast<const float2*>(t.tile + r * Sh::kTStride + t.c0);
  const float4* s = reinterpret_cast<const float4*>(t.states + r * kMaxS1);
  float2 v = make_float2(0.f, 0.f);
#pragma unroll
  for (int k4 = 0; k4 < kMaxS1 / 4; ++k4) {
    if (4 * k4 >= t.S) break;
    const float4 q = s[k4];
    const float a[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v.x = fmaf(a[k], t.w[4 * k4 + k].x, v.x);
      v.y = fmaf(a[k], t.w[4 * k4 + k].y, v.y);
    }
  }
  return make_float2(p.x + v.x, p.y + v.y);
}

// The epilogue warpgroups of a one-filter kernel: the item's states into
// shared memory (two threads a row, eight states each), then for each
// tile the consumers hand over, Wᵀ's rows at the lane's columns and
// epi.tile(t).
template <class Sh, class Epi>
__device__ __forceinline__ void finish1(const float* __restrict__ wt,
                                        const float* __restrict__ s_in,
                                        const Geometry& g, uint8_t* smem,
                                        uint64_t* tile_full,
                                        uint64_t* tile_empty, Epi& epi) {
  constexpr int kHalves = Sh::kN / 64;
  const int etid = threadIdx.x - 128 - kConsumers;
  Tile1 t;
  t.warp = etid / 32;
  t.lane = etid % 32;
  t.c0 = 64 * (t.warp % kHalves) + 2 * t.lane;
  t.first = t.warp / kHalves;
  t.step = kEpiWarps / kHalves;
  t.S = g.S;
  t.tile = reinterpret_cast<const float*>(smem + Sh::kTileOff);
  float* states = reinterpret_cast<float*>(smem + Sh::kStatesOff);
  t.states = states;
  t.epi = reinterpret_cast<float*>(smem + Sh::kEpiOff);
  const int sr = etid / 2;        // the tile row whose states it stages
  const int kh = 8 * (etid % 2);  // states kh .. kh + 7
  uint32_t tphase = 0;
  for (int it = blockIdx.x; it < g.items; it += gridDim.x) {
    int sp;
    item_at(g, it, t.b0, sp);
    t.blocks = min(g.br, g.nb - t.b0);
    const int c = sr / g.br;
    const int bl = sr - c * g.br;
    const bool ok = c < g.C && bl < t.blocks;
    const float* src = s_in + ((size_t)c * g.nb + t.b0 + bl) * g.S + kh;
    float sv[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      sv[k] = ok && kh + k < g.S ? __ldg(src + k) : 0.f;
    // every epilogue thread is done with the previous item's states
    // before they are overwritten, and these are in before any is read
    asm volatile("bar.sync 2, %0;" ::"n"(kEpilogue) : "memory");
    float4* dst = reinterpret_cast<float4*>(states + sr * kMaxS1 + kh);
    dst[0] = make_float4(sv[0], sv[1], sv[2], sv[3]);
    dst[1] = make_float4(sv[4], sv[5], sv[6], sv[7]);
    asm volatile("bar.sync 2, %0;" ::"n"(kEpilogue) : "memory");
    for (t.tt = 0; t.tt < g.tiles; ++t.tt) {
      t.j0 = (sp * g.tiles + t.tt) * Sh::kN;
      const float* wj = wt + t.j0 + t.c0;
#pragma unroll
      for (int k = 0; k < kMaxS1; ++k)
        t.w[k] = k < g.S ? __ldg(reinterpret_cast<const float2*>(
                               wj + (size_t)k * g.L))
                         : make_float2(0.f, 0.f);
      mbar_wait(tile_full, tphase);
      epi.tile(t);
      mbar_arrive(tile_empty);
      tphase ^= 1;
    }
  }
}

// The one-filter kernel body: roles, then the ring.  `packed` is the
// operator of packed_operator (ops/cuda_multiband.py) for column tiles of
// Sh::kN, 16-byte aligned; wt (S, L) is Wᵀ; `xmap` the TMA map of x made
// by rows_map; xop transforms the signal before the split.
template <class Sh, class XOp, class Epi>
__device__ __forceinline__ void one_product(
    const CUtensorMap* xmap, const float* __restrict__ packed,
    const float* __restrict__ wt, const float* __restrict__ s_in,
    const Geometry& g, XOp xop, Epi& epi) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Sh::kBarOff);
  uint64_t* empty = full + Sh::kStages;
  uint64_t* tile_full = empty + Sh::kStages;
  uint64_t* tile_empty = tile_full + 1;
  if (threadIdx.x == 0) {
    for (int s = 0; s < Sh::kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers / 32);  // a warp of each consumer
    }
    mbar_init(tile_full, kConsumers);
    mbar_init(tile_empty, kEpilogue);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) produce<Sh>(xmap, packed, g, smem, full, empty);
  } else if (threadIdx.x < 128 + kConsumers) {
    if constexpr (Sh::kConsumerRegs1 > kLaunchRegs)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(
          Sh::kConsumerRegs1));
    consume<Sh>(g, smem, full, empty, tile_full, tile_empty, xop);
  } else {
    if constexpr (Sh::kEpilogueRegs1 > kLaunchRegs)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(
          Sh::kEpilogueRegs1));
    finish1<Sh>(wt, s_in, g, smem, tile_full, tile_empty, epi);
  }
}

// The launch's geometry, or false for a shape the kernels do not take:
// 1 <= C <= kRows, 1 <= S <= max_s, L a positive multiple of `cols` (the
// columns of a filter in a tile) that the span (a multiple of cols)
// divides, C·nb < 2^31.
inline bool geometry(int C, int nb, int L, int S, int h, int span,
                     Geometry& g, int cols = kCols, int max_s = kMaxS) {
  if (C < 1 || C > kRows || nb < 1 || S < 1 || S > max_s || h < 1 ||
      L < cols || L % cols != 0 || L % h != 0 || span % cols != 0 ||
      L % span != 0 || (long long)C * nb >= (1LL << 31))
    return false;
  g.C = C;
  g.nb = nb;
  g.L = L;
  g.S = S;
  g.h = h;
  g.br = kRows / C;
  g.n_rt = (nb + g.br - 1) / g.br;
  g.n_sp = L / span;
  g.tiles = span / cols;
  g.items = g.n_rt * g.n_sp;
  return true;
}

// cuTensorMapEncodeTiled, from the driver the runtime has loaded (no
// -lcuda on the link line).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The TMA map of x (C, nb, L): boxes of kK samples x br blocks x C
// channels, 128-byte swizzled, blocks past nb read as zeros.
inline cudaError_t rows_map(const float* x, const Geometry& g,
                            CUtensorMap* map) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[3] = {(cuuint64_t)g.L, (cuuint64_t)g.nb,
                              (cuuint64_t)g.C};
  const cuuint64_t strides[2] = {(cuuint64_t)g.L * 4,
                                 (cuuint64_t)g.nb * g.L * 4};
  const cuuint32_t box[3] = {kK, (cuuint32_t)g.br, (cuuint32_t)g.C};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(x), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The persistent grid, one CTA an SM (fewer if there are fewer items),
// with the kernel allowed its shared memory, and x's TMA map.
template <class Kernel>
inline cudaError_t prepare(Kernel kernel, const float* x, const Geometry& g,
                           dim3& grid, CUtensorMap* xmap,
                           int smem_bytes = kSmemBytes) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err == cudaSuccess) err = rows_map(x, g, xmap);
  grid = dim3(sms < g.items ? sms : g.items);
  return err;
}

}  // namespace wgb
}  // namespace pam
