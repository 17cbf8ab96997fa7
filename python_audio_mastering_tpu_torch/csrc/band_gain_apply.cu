// band_gain_apply: the multiband recombination with control-rate gains,
// y = x * g_mid + low * (g_low - g_mid) + high * (g_high - g_mid), plus the
// mono downmix the loudness meter reads.
//
// Replaces the TPU kernel python_audio_mastering_tpu/ops/pallas_multiband.py
// band_gain_apply / _gain_apply_kernel.  It recomputes the low and high
// bands of a tile from their incoming states (crossover_bands.cuh: two
// passes of the blocked-IIR loop, bound by the fp32 FMA rate, see
// blocked_iir.cuh), repeats each of the three control-rate gain columns
// over its h samples, and writes y once: the band signals and the mid band
// never reach device memory.  The TPU kernel upsamples the gains as a
// product with a 0/1 matrix; each output there has one nonzero term, so
// the plain repeat here is the same value.  One CTA owns every channel of
// a group of blocks, so the mono mean stays inside it; the last group is
// masked.
#include "crossover_bands.cuh"

namespace pam {

template <int L>
__global__ void __launch_bounds__(kThreads)
band_gain_apply_kernel(const float* __restrict__ x,
                       const float* __restrict__ t2,
                       const float* __restrict__ wt2,
                       const float* __restrict__ s_lp,
                       const float* __restrict__ s_hp,
                       const float* __restrict__ cols, float* __restrict__ y,
                       float* __restrict__ mono, int C, int nb, int S, int br,
                       int h) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int b0 = blockIdx.x * br;
  const float* low;
  const float* high;
  crossover_bands_tile<L>(x, t2, wt2, s_lp, s_hp, C, nb, S, b0, br, smem,
                          &low, &high);
  const int lh = L / h;
  const size_t T = (size_t)nb * lh;
  const float inv_c = 1.f / (float)C;
  for (int e = threadIdx.x; e < br * L; e += kThreads) {
    const int bl = e / L;
    const int j = e % L;
    const int b = b0 + bl;
    if (b >= nb) break;
    const size_t g = (size_t)b * lh + j / h;
    const float gm = cols[g];
    const float dl = cols[T + g];
    const float dh = cols[2 * T + g];
    float sum = 0.f;
    for (int c = 0; c < C; ++c) {
      const size_t at = ((size_t)c * nb + b) * L + j;
      const size_t r = (size_t)(bl * C + c) * L + j;
      const float v = x[at] * gm + low[r] * dl + high[r] * dh;
      y[at] = v;
      sum += v;
    }
    if (mono != nullptr) mono[(size_t)b * L + j] = sum * inv_c;
  }
}

template <int L>
int launch_band_gain_apply(const float* x, const float* t2, const float* wt2,
                           const float* s_lp, const float* s_hp,
                           const float* cols, float* y, float* mono, int C,
                           int nb, int S, int h, void* stream) {
  if (L % h != 0) return (int)cudaErrorInvalidValue;
  const int br = kTileRows / C;
  const int grid = (nb + br - 1) / br;
  return launch_tile_kernel(band_gain_apply_kernel<L>, BandsSmem<L>::kBytes,
                            grid, stream, x, t2, wt2, s_lp, s_hp, cols, y,
                            mono, C, nb, S, br, h);
}

}  // namespace pam

// y (C, nb, L) and, when mono is not null, mono (nb, L), from cols
// (3, nb * L / h) = (g_mid, g_low - g_mid, g_high - g_mid).  Returns the
// CUDA error code of the launch (0 on success).
extern "C" int pam_band_gain_apply(const float* x, const float* t2,
                                   const float* wt2, const float* s_lp,
                                   const float* s_hp, const float* cols,
                                   float* y, float* mono, int C, int nb,
                                   int L, int S, int h, void* stream) {
  if (C < 1 || C > pam::kTileRows || nb < 1 || S < 1 || h < 1)
    return (int)cudaErrorInvalidValue;
  PAM_DISPATCH_L(L, pam::launch_band_gain_apply, x, t2, wt2, s_lp, s_hp, cols,
                 y, mono, C, nb, S, h, stream)
}
