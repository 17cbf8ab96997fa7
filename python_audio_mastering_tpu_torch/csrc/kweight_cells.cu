// kweight_cells: K-weighted energies summed over buckets of h samples, the
// input of the BS.1770 loudness cells.
//
// Replaces the TPU kernel python_audio_mastering_tpu/ops/pallas_multiband.py
// kweight_cells / _cells_kernel.  It recomputes the K-weighted signal block
// by block from the incoming states with the shared tile loop
// (blocked_iir.cuh: bound by the fp32 FMA rate, see there), squares it and
// writes only the h-bucket sums, so the K-weighted signal never reaches
// device memory.  The TPU kernel sums buckets as a product with a 0/1
// matrix (a matrix-unit trick); here it is a plain sum over h adjacent
// columns of the tile, read from shared memory.
#include "blocked_iir.cuh"

namespace pam {

template <int L>
__global__ void __launch_bounds__(kThreads)
kweight_cells_kernel(const float* __restrict__ x, const float* __restrict__ t,
                     const float* __restrict__ wt,
                     const float* __restrict__ s_in, float* __restrict__ out,
                     int C, int nb, int S, int br, int h) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int b0 = blockIdx.x * br;
  blocked_iir_tile<L>(x, t, wt, s_in, C, nb, S, b0, br, smem);
  const int lh = L / h;
  for (int e = threadIdx.x; e < br * C * lh; e += kThreads) {
    const int r = e / lh;
    const int q = e % lh;
    const int b = b0 + r / C;
    if (b >= nb) break;
    const float* v = smem + (size_t)r * L + q * h;
    float s = 0.f;
    for (int i = 0; i < h; ++i) s = fmaf(v[i], v[i], s);
    out[(size_t)(r % C) * nb * lh + (size_t)b * lh + q] = s;
  }
}

template <int L>
int launch_kweight_cells(const float* x, const float* t, const float* wt,
                         const float* s_in, float* out, int C, int nb, int S,
                         int h, void* stream) {
  if (L % h != 0) return (int)cudaErrorInvalidValue;
  const int br = kTileRows / C;
  const int grid = (nb + br - 1) / br;
  return launch_tile_kernel(kweight_cells_kernel<L>, TileSmem<L>::kBytes,
                            grid, stream, x, t, wt, s_in, out, C, nb, S, br,
                            h);
}

}  // namespace pam

// out (C, nb * L / h).  Returns the CUDA error code of the launch (0 on
// success).
extern "C" int pam_kweight_cells(const float* x, const float* t,
                                 const float* wt, const float* s_in,
                                 float* out, int C, int nb, int L, int S,
                                 int h, void* stream) {
  if (C < 1 || C > pam::kTileRows || nb < 1 || S < 1 || h < 1)
    return (int)cudaErrorInvalidValue;
  PAM_DISPATCH_L(L, pam::launch_kweight_cells, x, t, wt, s_in, out, C, nb, S,
                 h, stream)
}
