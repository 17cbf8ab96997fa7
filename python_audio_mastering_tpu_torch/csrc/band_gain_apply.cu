// band_gain_apply: the multiband recombination with control-rate gains,
// y = x * g_mid + low * (g_low - g_mid) + high * (g_high - g_mid), plus the
// mono downmix the loudness meter reads.
//
// Replaces the TPU kernel python_audio_mastering_tpu/ops/pallas_multiband.py
// band_gain_apply / _gain_apply_kernel.  It recomputes the low and high
// bands of a tile from their incoming states (tf32_wgmma.cuh: x @ T in
// 3xTF32 on wgmma, the states term in fp32), repeats each of the three
// control-rate gain columns over its h samples, and writes y once: the
// band signals and the mid band never reach device memory.  What bounds
// it on the H100, at the main path's shapes (3-min stereo track, L = 384):
// its ~12.2 GFLOP of x @ T, 0.074 ms at the 3xTF32 rate, and ~0.2 GFLOP of
// states term on the fp32 cores, 0.004 ms, against ~170 MB in and out
// (0.051 ms at 3.35 TB/s).  The TPU kernel upsamples the gains as a
// product with a 0/1 matrix; each output there has one nonzero term, so
// the plain repeat here is the same value.
//
// An item is 128 rows (every channel of br = 128 / C blocks) and one
// column tile of 64 columns of both bands.  The epilogue warpgroups read
// the products from shared memory, a warp a block, add the states term
// and form y and the mono mean there, reading x at the output columns
// again (from L2), while the consumers run the next tile's products.
#include "tf32_wgmma.cuh"

namespace pam {

struct GainApplyEpilogue {
  const float* __restrict__ x;
  const float* __restrict__ cols;
  float* __restrict__ y;
  float* __restrict__ mono;
  int C, nb, L, h, br;

  // A warp takes kBatch of its blocks at a time (every channel of each,
  // so the mono mean needs no other warp), a lane two columns; a batch's
  // gains and first two channels of x are loaded before any is used.
  static constexpr int kBatch = 2;
  struct Batch {
    int bl[kBatch];
    float2 gm[kBatch], dl[kBatch], dh[kBatch], xv[kBatch][2];
  };

  __device__ __forceinline__ void load(const wgb::TileCtx& t, int u0,
                                       Batch& b) const {
    const int lh = L / h;
    const size_t T = (size_t)nb * lh;
    const size_t plane = (size_t)nb * L;
    const int j = t.j0 + 2 * t.lane;
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      b.bl[q] = t.warp + wgb::kEpiWarps * (u0 + q);
      const bool ok = b.bl[q] < t.blocks;
      const size_t blk = (size_t)t.b0 + (ok ? b.bl[q] : 0);
      const size_t q0 = blk * lh + j / h;
      const size_t q1 = blk * lh + (j + 1) / h;
      b.gm[q] = make_float2(__ldg(cols + q0), __ldg(cols + q1));
      b.dl[q] = make_float2(__ldg(cols + T + q0), __ldg(cols + T + q1));
      b.dh[q] = make_float2(__ldg(cols + 2 * T + q0), __ldg(cols + 2 * T + q1));
#pragma unroll
      for (int k = 0; k < 2; ++k)
        b.xv[q][k] = ok && k < C ? __ldg(reinterpret_cast<const float2*>(
                                       x + k * plane + blk * L + j))
                                 : make_float2(0.f, 0.f);
    }
  }

  __device__ __forceinline__ void tile(const wgb::TileCtx& t) const {
    const size_t plane = (size_t)nb * L;  // from one channel to the next
    const int j = t.j0 + 2 * t.lane;
    const float inv_c = 1.f / (float)C;
    for (int u0 = 0; t.warp + wgb::kEpiWarps * u0 < t.blocks; u0 += kBatch) {
      Batch cur;
      load(t, u0, cur);
      float2 m[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) m[q] = make_float2(0.f, 0.f);
      for (int c = 0; c < C; c += 2) {
        if (c > 0) {  // channels past the first two: loaded here
#pragma unroll
          for (int q = 0; q < kBatch; ++q)
#pragma unroll
            for (int k = 0; k < 2; ++k)
              cur.xv[q][k] =
                  cur.bl[q] < t.blocks && c + k < C
                      ? __ldg(reinterpret_cast<const float2*>(
                            x + (c + k) * plane +
                            (size_t)(t.b0 + cur.bl[q]) * L + j))
                      : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int q = 0; q < kBatch; ++q)
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            if (cur.bl[q] >= t.blocks || c + k >= C) continue;
            float2 lo, hi;
            wgb::bands_at(t, (c + k) * br + cur.bl[q], lo, hi);
            const float2 xv = cur.xv[q][k];
            const float2 v = make_float2(
                xv.x * cur.gm[q].x + lo.x * cur.dl[q].x + hi.x * cur.dh[q].x,
                xv.y * cur.gm[q].y + lo.y * cur.dl[q].y + hi.y * cur.dh[q].y);
            *reinterpret_cast<float2*>(y + (c + k) * plane +
                                       (size_t)(t.b0 + cur.bl[q]) * L + j) = v;
            m[q].x += v.x;
            m[q].y += v.y;
          }
      }
      if (mono != nullptr) {
#pragma unroll
        for (int q = 0; q < kBatch; ++q)
          if (cur.bl[q] < t.blocks)
            *reinterpret_cast<float2*>(mono +
                                       (size_t)(t.b0 + cur.bl[q]) * L + j) =
                make_float2(m[q].x * inv_c, m[q].y * inv_c);
      }
    }
  }
};

__global__ void __launch_bounds__(wgb::kThreads, 1)
band_gain_apply_kernel(const __grid_constant__ CUtensorMap xmap,
                       const float* __restrict__ x,
                       const float* __restrict__ packed,
                       const float* __restrict__ wt2,
                       const float* __restrict__ s_lp,
                       const float* __restrict__ s_hp,
                       const float* __restrict__ cols, float* __restrict__ y,
                       float* __restrict__ mono, wgb::Geometry g) {
  GainApplyEpilogue epi{x, cols, y, mono, g.C, g.nb, g.L, g.h, g.br};
  wgb::band_product(&xmap, packed, wt2, s_lp, s_hp, g, epi);
}

}  // namespace pam

// y (C, nb, L) and, when mono is not null, mono (nb, L), from cols
// (3, nb * L / h) = (g_mid, g_low - g_mid, g_high - g_mid).  `packed` is
// the crossover operator of ops/cuda_multiband.py's crossover_packed and
// wt2 (2, S, L) the transposed state operators.  Returns the CUDA error
// code of the launch (0 on success); cudaErrorInvalidValue for a shape the
// kernel does not take.
extern "C" int pam_band_gain_apply(const float* x, const float* packed,
                                   const float* wt2, const float* s_lp,
                                   const float* s_hp, const float* cols,
                                   float* y, float* mono, int C, int nb,
                                   int L, int S, int h, void* stream) {
  pam::wgb::Geometry g;
  if (!pam::wgb::geometry(C, nb, L, S, h, pam::wgb::kCols, g))
    return (int)cudaErrorInvalidValue;
  dim3 grid;
  CUtensorMap xmap;
  cudaError_t err =
      pam::wgb::prepare(pam::band_gain_apply_kernel, x, g, grid, &xmap);
  if (err != cudaSuccess) return (int)err;
  pam::band_gain_apply_kernel<<<grid, pam::wgb::kThreads,
                                pam::wgb::kSmemBytes,
                                (cudaStream_t)stream>>>(
      xmap, x, packed, wt2, s_lp, s_hp, cols, y, mono, g);
  return (int)cudaGetLastError();
}
