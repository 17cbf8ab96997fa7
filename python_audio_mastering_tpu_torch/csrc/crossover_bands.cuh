// The crossover bands of one tile on the fp32 CUDA cores, for
// band_energies (band_gain_apply runs the same product on the tensor
// cores, tf32_product.cuh).
//
// The worker split is low = LP4(x), high = HP4(x), mid = x - low - high.
// Both filters read the same raw rows x, so a tile runs the blocked-IIR
// loop (blocked_iir.cuh) twice over the same rows, once with the low-pass
// operators and once with the high-pass ones.  A single loop producing
// both outputs would double the accumulator tile a thread holds in
// registers; the loop already needs ~200-250 registers at L = 384 for one
// output, so the second output would spill.  Instead the low band is
// parked in a shared-memory region of its own while the high band runs,
// and the epilogue reads both tiles from shared memory.
#pragma once

#include "blocked_iir.cuh"

namespace pam {

template <int L>
struct BandsSmem {
  static constexpr int kLowFloats = kTileRows * L;
  static constexpr size_t kBytes =
      sizeof(float) * kLowFloats + TileSmem<L>::kBytes;
};

// On return low[t * L + j] and high[t * L + j] hold row t, column j of the
// two bands (rows t = bl * C + c), and the block is synchronised.
//   t2   (2, L, L)   zero-state operators T_lp, T_hp
//   wt2  (2, S, L)   state operators, transposed
//   s_lp, s_hp (C, nb, S)  incoming cascade states of each filter
template <int L>
__device__ __forceinline__ void crossover_bands_tile(
    const float* __restrict__ x, const float* __restrict__ t2,
    const float* __restrict__ wt2, const float* __restrict__ s_lp,
    const float* __restrict__ s_hp, int C, int nb, int S, int b0, int br,
    float* smem, const float** low, const float** high) {
  float* lo = smem;
  float* work = smem + BandsSmem<L>::kLowFloats;
  blocked_iir_tile<L>(x, t2, wt2, s_lp, C, nb, S, b0, br, false, 0.f, 1.f,
                      work, lo);
  blocked_iir_tile<L>(x, t2 + (size_t)L * L, wt2 + (size_t)S * L, s_hp, C,
                      nb, S, b0, br, false, 0.f, 1.f, work, work);
  *low = lo;
  *high = work;
}

}  // namespace pam
