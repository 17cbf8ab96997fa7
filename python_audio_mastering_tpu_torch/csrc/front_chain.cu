// front_chain: saturate -> EQ (from per-block states) -> stereo width,
// plus the mono downmix the loudness meter reads.
//
// Replaces the TPU kernel python_audio_mastering_tpu/ops/pallas_multiband.py
// front_chain / _front_kernel.  It reads the raw rows once, applies the
// exciter as the A tile is loaded (tanh before the product, as the TPU
// kernel does), recomputes the EQ from the incoming states with the shared
// tile loop (blocked_iir.cuh: bound by the fp32 FMA rate, see there), and
// writes the widened output once.  The width couples the two channels of a
// block, which the tile layout keeps in one CTA.  Any channel count is
// taken; the width applies only at C == 2, as stereo_width does, and the
// mono output is the channel mean.
#include "blocked_iir.cuh"

namespace pam {

template <int L>
__global__ void __launch_bounds__(kThreads)
front_chain_kernel(const float* __restrict__ x, const float* __restrict__ t,
                   const float* __restrict__ wt,
                   const float* __restrict__ s_in, float* __restrict__ y,
                   float* __restrict__ mono, int C, int nb, int S, int br,
                   float mix, float drive, float width) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int b0 = blockIdx.x * br;
  blocked_iir_tile<L>(x, t, wt, s_in, C, nb, S, b0, br, true, mix, drive,
                      smem, smem);
  const float inv_c = 1.f / (float)C;
  for (int e = threadIdx.x; e < br * L; e += kThreads) {
    const int bl = e / L;
    const int j = e % L;
    const int b = b0 + bl;
    if (b >= nb) break;
    const float* col = smem + (size_t)bl * C * L + j;  // row bl*C + c
    if (C == 2) {
      const float a = col[0];
      const float r = col[L];
      const float mid = (a + r) * 0.5f;
      const float side = (a - r) * (0.5f * width);
      const float o0 = mid + side;
      const float o1 = mid - side;
      y[(size_t)b * L + j] = o0;
      y[((size_t)nb + b) * L + j] = o1;
      if (mono != nullptr) mono[(size_t)b * L + j] = (o0 + o1) * 0.5f;
    } else {
      float sum = 0.f;
      for (int c = 0; c < C; ++c) {
        const float v = col[(size_t)c * L];
        y[((size_t)c * nb + b) * L + j] = v;
        sum += v;
      }
      if (mono != nullptr) mono[(size_t)b * L + j] = sum * inv_c;
    }
  }
}

template <int L>
int launch_front_chain(const float* x, const float* t, const float* wt,
                       const float* s_in, float* y, float* mono, int C,
                       int nb, int S, float mix, float drive, float width,
                       void* stream) {
  const int br = kTileRows / C;
  const int grid = (nb + br - 1) / br;
  return launch_tile_kernel(front_chain_kernel<L>, TileSmem<L>::kBytes, grid,
                            stream, x, t, wt, s_in, y, mono, C, nb, S, br,
                            mix, drive, width);
}

}  // namespace pam

// y (C, nb, L) and, when mono is not null, mono (nb, L).  Returns the CUDA
// error code of the launch (0 on success).
extern "C" int pam_front_chain(const float* x, const float* t,
                               const float* wt, const float* s_in, float* y,
                               float* mono, int C, int nb, int L, int S,
                               float mix, float drive, float width,
                               void* stream) {
  if (C < 1 || C > pam::kTileRows || nb < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  PAM_DISPATCH_L(L, pam::launch_front_chain, x, t, wt, s_in, y, mono, C, nb,
                 S, mix, drive, width, stream)
}
