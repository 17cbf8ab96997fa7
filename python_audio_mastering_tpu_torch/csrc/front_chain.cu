// front_chain: saturate -> EQ (from per-block states) -> stereo width,
// plus the mono downmix the loudness meter reads.
//
// Replaces the TPU kernel python_audio_mastering_tpu/ops/pallas_multiband.py
// front_chain / _front_kernel.  It recomputes the EQ of a tile from its
// incoming states as one product on the tensor cores in 3xTF32
// (tf32_product.cuh with F = 1: 128 rows x 128 columns a CTA).  What bounds
// it on the H100, at the main path's shapes (3-min stereo track, L = 384,
// with the mono output): ~160 MB of signal in and out, 0.048 ms at 3.35
// TB/s, just above its ~6.4 GFLOP of products, 0.039 ms at the 3xTF32 rate
// (0.095 ms on the fp32 CUDA cores, where the first version's tile loop ran it).  The
// design reads the raw rows from device memory once (the column
// tiles of a row group re-read them from L2), applies the exciter (1-mix)·x
// + mix·tanh(drive·x) in place to the A tiles as they land in shared memory
// (the states are not shaped: they come from the saturated signal already),
// and writes the widened output once from the result tile.  The width couples
// the two channels of a block, which the tile layout keeps in one CTA.  Any
// channel count is taken; the width applies only at C == 2, as stereo_width
// does, and the mono output is the channel mean.
#include "tf32_product.cuh"

namespace pam {

// waveshaper.saturate's exciter in its order of operations, no contraction
// (mix and drive stay kernel parameters, read where used: no registers)
struct Exciter {
  float mix, drive;
  __device__ __forceinline__ float operator()(float v) const {
    return __fadd_rn(__fmul_rn(1.f - mix, v),
                     __fmul_rn(mix, tanhf(__fmul_rn(v, drive))));
  }
};

// as band_gain_apply: two CTAs of 128 rows an SM
__global__ void __launch_bounds__(kGThreads, 512 / kGThreads)
front_chain_kernel(const float* __restrict__ x, const float* __restrict__ t,
                   const float* __restrict__ wt,
                   const float* __restrict__ s_in, float* __restrict__ y,
                   float* __restrict__ mono, int C, int nb, int L, int S,
                   int br, float mix, float drive, float width) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int kCols = 2 * kGN;
  const int b0 = blockIdx.y * br;
  // the column tiles with the most k-tiles first
  const int j0 = (gridDim.x - 1 - blockIdx.x) * kCols;
  product_tile_tf32<1>(x, t, wt, s_in, nullptr, C, nb, L, S, b0, br, j0,
                       Exciter{mix, drive}, smem);
  const float inv_c = 1.f / (float)C;
  for (int e = threadIdx.x; e < br * kCols; e += kGThreads) {
    const int bl = e / kCols;
    const int jj = e % kCols;
    const int b = b0 + bl;
    if (b >= nb) break;
    const size_t j = (size_t)b * L + j0 + jj;     // (block, column) in a row
    const float* col = smem + bl * C * kGEStride + jj;  // row bl*C + c
    if (C == 2) {
      const float a = col[0];
      const float r = col[kGEStride];
      const float mid = (a + r) * 0.5f;
      const float side = (a - r) * (0.5f * width);
      const float o0 = mid + side;
      const float o1 = mid - side;
      y[j] = o0;
      y[(size_t)nb * L + j] = o1;
      if (mono != nullptr) mono[j] = (o0 + o1) * 0.5f;
    } else {
      float sum = 0.f;
      for (int c = 0; c < C; ++c) {
        const float v = col[c * kGEStride];
        y[(size_t)c * nb * L + j] = v;
        sum += v;
      }
      if (mono != nullptr) mono[j] = sum * inv_c;
    }
  }
}

}  // namespace pam

// y (C, nb, L) and, when mono is not null, mono (nb, L).  x and t must be
// 16-byte aligned.  Refuses C·nb >= 2^31 rows (never addressable).
// Returns the CUDA error code of the launch (0 on success).
extern "C" int pam_front_chain(const float* x, const float* t,
                               const float* wt, const float* s_in, float* y,
                               float* mono, int C, int nb, int L, int S,
                               float mix, float drive, float width,
                               void* stream) {
  if (C < 1 || C > pam::kGM || nb < 1 || S < 1 || S > pam::kGStateDepth ||
      L < 2 * pam::kGN || L % (2 * pam::kGN) != 0 ||
      (long long)C * nb >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int br = pam::kGM / C;
  const dim3 grid(L / (2 * pam::kGN), (nb + br - 1) / br);
  cudaError_t err = cudaFuncSetAttribute(
      pam::front_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)pam::kGSmemBytes);
  if (err != cudaSuccess) return (int)err;
  pam::front_chain_kernel<<<grid, pam::kGThreads, pam::kGSmemBytes,
                            (cudaStream_t)stream>>>(
      x, t, wt, s_in, y, mono, C, nb, L, S, br, mix, drive, width);
  return (int)cudaGetLastError();
}
