// front_chain: saturate -> EQ (from per-block states) -> stereo width,
// plus the mono downmix the loudness meter reads.
//
// Replaces the TPU kernel python_audio_mastering_tpu/ops/pallas_multiband.py
// front_chain / _front_kernel.  It recomputes the EQ of a tile from its
// incoming states (tf32_wgmma.cuh, one filter in 128-column tiles: x @ T
// in 3xTF32 on wgmma, the states term in fp32), widens it and writes it
// once.  What bounds it on the H100, at the main path's shapes (3-min
// stereo track, L = 384, S = 8, with the mono output): ~160 MB of signal
// in and out, 0.048 ms at 3.35 TB/s, just above its ~6.4 GFLOP of
// products, 0.039 ms at the 3xTF32 rate.  The design reads each row tile
// of the raw signal by TMA once a column tile (the column tiles of a row
// tile re-read it from L2) and applies the exciter dry·x + wet·tanh(drive·x)
// in the consumers' registers to each A fragment as it is loaded, before
// the split (the states are not shaped: they come from the saturated
// signal already).  The epilogue warpgroups add the states term, widen a
// block's two channels (the tile layout keeps them in one CTA) and write
// y and the mono mean, a warp a block and 64 columns, while the consumers
// run the next tile's products.  Any channel count is taken; the width
// applies only at C == 2, as stereo_width does, and the mono output is
// the channel mean.
#include "tf32_wgmma.cuh"

namespace pam {

// waveshaper.exciter in its order of operations, no contraction.  The
// worker's saturation passes dry = 1 - mix (rounded to float), wet =
// mix; the legacy one tanh(g·x)/g as dry = 0, wet = 1/g, drive = g.
struct Exciter {
  float dry, wet, drive;
  __device__ __forceinline__ float operator()(float v) const {
    return __fadd_rn(__fmul_rn(dry, v),
                     __fmul_rn(wet, tanhf(__fmul_rn(v, drive))));
  }
};

// 128 columns of one filter a tile, three stages (48 KB each)
using FrontShape = wgb::One<128, 3, 0>;

struct FrontEpilogue {
  float* __restrict__ y;
  float* __restrict__ mono;
  int C, nb, L, br;
  float width;

  __device__ __forceinline__ void tile(const wgb::Tile1& t) const {
    const size_t plane = (size_t)nb * L;  // from one channel to the next
    const int j = t.j0 + t.c0;
    const float inv_c = 1.f / (float)C;
    for (int bl = t.first; bl < t.blocks; bl += t.step) {
      const size_t at = (size_t)(t.b0 + bl) * L + j;
      if (C == 2) {
        const float2 a = wgb::value_at<FrontShape>(t, bl);
        const float2 r = wgb::value_at<FrontShape>(t, br + bl);
        const float2 mid = make_float2((a.x + r.x) * 0.5f,
                                       (a.y + r.y) * 0.5f);
        const float2 side = make_float2((a.x - r.x) * (0.5f * width),
                                        (a.y - r.y) * (0.5f * width));
        const float2 o0 = make_float2(mid.x + side.x, mid.y + side.y);
        const float2 o1 = make_float2(mid.x - side.x, mid.y - side.y);
        *reinterpret_cast<float2*>(y + at) = o0;
        *reinterpret_cast<float2*>(y + plane + at) = o1;
        if (mono != nullptr)
          *reinterpret_cast<float2*>(mono + at) = make_float2(
              (o0.x + o1.x) * 0.5f, (o0.y + o1.y) * 0.5f);
      } else {
        float2 sum = make_float2(0.f, 0.f);
        for (int c = 0; c < C; ++c) {
          const float2 v = wgb::value_at<FrontShape>(t, c * br + bl);
          *reinterpret_cast<float2*>(y + c * plane + at) = v;
          sum.x += v.x;
          sum.y += v.y;
        }
        if (mono != nullptr)
          *reinterpret_cast<float2*>(mono + at) =
              make_float2(sum.x * inv_c, sum.y * inv_c);
      }
    }
  }
};

__global__ void __launch_bounds__(wgb::kThreads, 1)
front_chain_kernel(const __grid_constant__ CUtensorMap xmap,
                   const float* __restrict__ packed,
                   const float* __restrict__ wt,
                   const float* __restrict__ s_in, float* __restrict__ y,
                   float* __restrict__ mono, wgb::Geometry g, Exciter exc,
                   float width) {
  FrontEpilogue epi{y, mono, g.C, g.nb, g.L, g.br, width};
  wgb::one_product<FrontShape>(&xmap, packed, wt, s_in, g, exc, epi);
}

}  // namespace pam

// y (C, nb, L) and, when mono is not null, mono (nb, L).  `packed` is the
// EQ operator of ops/cuda_multiband.py's packed_operator (128-column
// tiles), wt (S, L) the transposed state operator; x 16-byte aligned.
// Refuses C > 128 (the tile height), S > 16, L not a multiple of 128 and
// C·nb >= 2^31 rows (never addressable).  Returns the CUDA error code of
// the launch (0 on success).
extern "C" int pam_front_chain(const float* x, const float* packed,
                               const float* wt, const float* s_in, float* y,
                               float* mono, int C, int nb, int L, int S,
                               float dry, float wet, float drive,
                               float width, void* stream) {
  using Sh = pam::FrontShape;
  pam::wgb::Geometry g;
  if (!pam::wgb::geometry(C, nb, L, S, 1, Sh::kN, g, Sh::kN,
                          pam::wgb::kMaxS1))
    return (int)cudaErrorInvalidValue;
  dim3 grid;
  CUtensorMap xmap;
  cudaError_t err = pam::wgb::prepare(pam::front_chain_kernel, x, g, grid,
                                      &xmap, Sh::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  pam::front_chain_kernel<<<grid, pam::wgb::kThreads, Sh::kSmemBytes,
                            (cudaStream_t)stream>>>(
      xmap, packed, wt, s_in, y, mono, g, pam::Exciter{dry, wet, drive},
      width);
  return (int)cudaGetLastError();
}
