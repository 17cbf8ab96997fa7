// band_gain_apply: the multiband recombination with control-rate gains,
// y = x * g_mid + low * (g_low - g_mid) + high * (g_high - g_mid), plus the
// mono downmix the loudness meter reads.
//
// Replaces the TPU kernel python_audio_mastering_tpu/ops/pallas_multiband.py
// band_gain_apply / _gain_apply_kernel.  It recomputes the low and high
// bands of a tile from their incoming states as one product on the tensor
// cores in 3xTF32 (tf32_product.cuh with F = 2: bound by the products,
// ~12.5 GFLOP for a 3-min stereo track, 0.076 ms at the 3xTF32 rate),
// repeats each of the three control-rate gain
// columns over its h samples, and writes y once: the band signals and the
// mid band never reach device memory.  The TPU kernel upsamples the gains
// as a product with a 0/1 matrix; each output there has one nonzero term,
// so the plain repeat here is the same value.
//
// A CTA owns kGM rows (every channel of br = kGM / C blocks) and kGN
// output columns of both bands, so the recombination and the mono mean
// run from the result tile in shared memory; x at the output columns is
// read again (from L2, most of it).  The grid puts the column tiles with
// the most k-tiles (the right end of the causal T) first.
#include "tf32_product.cuh"

namespace pam {

// 512 threads an SM (at most 128 registers each): two CTAs of 128 rows
// (2 x 106 KB of shared memory), so that one CTA's epilogue overlaps the
// other's products
__global__ void __launch_bounds__(kGThreads, 512 / kGThreads)
band_gain_apply_kernel(const float* __restrict__ x,
                       const float* __restrict__ t2,
                       const float* __restrict__ wt2,
                       const float* __restrict__ s_lp,
                       const float* __restrict__ s_hp,
                       const float* __restrict__ cols, float* __restrict__ y,
                       float* __restrict__ mono, int C, int nb, int L, int S,
                       int br, int h) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int b0 = blockIdx.y * br;
  const int j0 = (gridDim.x - 1 - blockIdx.x) * kGN;
  product_tile_tf32<2>(x, t2, wt2, s_lp, s_hp, C, nb, L, S, b0, br, j0,
                       RawX{}, smem);
  const int lh = L / h;
  const size_t T = (size_t)nb * lh;
  const float inv_c = 1.f / (float)C;
  for (int e = threadIdx.x; e < br * kGN; e += kGThreads) {
    const int bl = e / kGN;
    const int jj = e % kGN;
    const int b = b0 + bl;
    if (b >= nb) break;
    const int j = j0 + jj;
    const size_t g = (size_t)b * lh + j / h;
    const float gm = cols[g];
    const float dl = cols[T + g];
    const float dh = cols[2 * T + g];
    float sum = 0.f;
    for (int c = 0; c < C; ++c) {
      const size_t at = ((size_t)c * nb + b) * L + j;
      const float* r = smem + (bl * C + c) * kGEStride + jj;
      const float v = x[at] * gm + r[0] * dl + r[kGN] * dh;
      y[at] = v;
      sum += v;
    }
    if (mono != nullptr) mono[(size_t)b * L + j] = sum * inv_c;
  }
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
  if (C < 1 || C > pam::kGM || nb < 1 || S < 1 ||
      2 * S > pam::kGStateDepth || h < 1 || L < pam::kGN ||
      L % pam::kGN != 0 || L % h != 0 || (long long)C * nb >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int br = pam::kGM / C;
  const dim3 grid(L / pam::kGN, (nb + br - 1) / br);
  cudaError_t err = cudaFuncSetAttribute(
      pam::band_gain_apply_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pam::kGSmemBytes);
  if (err != cudaSuccess) return (int)err;
  pam::band_gain_apply_kernel<<<grid, pam::kGThreads, pam::kGSmemBytes,
                                (cudaStream_t)stream>>>(
      x, t2, wt2, s_lp, s_hp, cols, y, mono, C, nb, L, S, br, h);
  return (int)cudaGetLastError();
}
