// band_energies: the multiband detector's input, the channel-mean squared
// energies of the three crossover bands summed over buckets of h samples.
//
// Replaces the TPU kernel python_audio_mastering_tpu/ops/pallas_multiband.py
// band_energies / _energies_kernel (+ _bands_block).  It recomputes the low
// and high bands of a tile from their incoming states (crossover_bands.cuh:
// two passes of the blocked-IIR loop, bound by the fp32 FMA rate, see
// blocked_iir.cuh), forms mid = x - low - high, squares, averages over the
// channels and sums buckets of h adjacent columns, so no band signal ever
// reaches device memory: the kernel reads the rows (and the tiny states)
// and writes three control-rate rows.  The TPU kernel sums buckets as a
// product with a 0/1 matrix (a matrix-unit trick); here it is a plain sum
// read from shared memory.  One CTA owns every channel of a group of
// blocks, so the channel mean stays inside it; the last group is masked.
#include "crossover_bands.cuh"

namespace pam {

template <int L>
__global__ void __launch_bounds__(kThreads)
band_energies_kernel(const float* __restrict__ x, const float* __restrict__ t2,
                     const float* __restrict__ wt2,
                     const float* __restrict__ s_lp,
                     const float* __restrict__ s_hp, float* __restrict__ out,
                     int C, int nb, int S, int br, int h) {
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
  for (int e = threadIdx.x; e < br * lh; e += kThreads) {
    const int bl = e / lh;
    const int q = e % lh;
    const int b = b0 + bl;
    if (b >= nb) break;
    float el = 0.f, em = 0.f, eh = 0.f;
    for (int c = 0; c < C; ++c) {
      const float* xr = x + ((size_t)c * nb + b) * L + q * h;
      const float* lr = low + (size_t)(bl * C + c) * L + q * h;
      const float* hr = high + (size_t)(bl * C + c) * L + q * h;
      for (int i = 0; i < h; ++i) {
        const float lo = lr[i];
        const float hi = hr[i];
        const float mid = xr[i] - lo - hi;
        el = fmaf(lo, lo, el);
        em = fmaf(mid, mid, em);
        eh = fmaf(hi, hi, eh);
      }
    }
    const size_t o = (size_t)b * lh + q;
    out[o] = el * inv_c;
    out[T + o] = em * inv_c;
    out[2 * T + o] = eh * inv_c;
  }
}

template <int L>
int launch_band_energies(const float* x, const float* t2, const float* wt2,
                         const float* s_lp, const float* s_hp, float* out,
                         int C, int nb, int S, int h, void* stream) {
  if (L % h != 0) return (int)cudaErrorInvalidValue;
  const int br = kTileRows / C;
  const int grid = (nb + br - 1) / br;
  return launch_tile_kernel(band_energies_kernel<L>, BandsSmem<L>::kBytes,
                            grid, stream, x, t2, wt2, s_lp, s_hp, out, C, nb,
                            S, br, h);
}

}  // namespace pam

// out (3, nb * L / h): low, mid, high.  Returns the CUDA error code of the
// launch (0 on success).
extern "C" int pam_band_energies(const float* x, const float* t2,
                                 const float* wt2, const float* s_lp,
                                 const float* s_hp, float* out, int C, int nb,
                                 int L, int S, int h, void* stream) {
  if (C < 1 || C > pam::kTileRows || nb < 1 || S < 1 || h < 1)
    return (int)cudaErrorInvalidValue;
  PAM_DISPATCH_L(L, pam::launch_band_energies, x, t2, wt2, s_lp, s_hp, out,
                 C, nb, S, h, stream)
}
