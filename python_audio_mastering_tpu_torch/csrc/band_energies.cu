// band_energies: the multiband detector's input, the channel-mean squared
// energies of the three crossover bands summed over buckets of h samples.
//
// Replaces the TPU kernel python_audio_mastering_tpu/ops/pallas_multiband.py
// band_energies / _energies_kernel (+ _bands_block).  It recomputes the low
// and high bands of a tile from their incoming states (tf32_wgmma.cuh: x @
// T in 3xTF32 on wgmma, the states term in fp32), forms mid = x - low -
// high, squares, sums over the channels and over buckets of h adjacent
// columns, so no band signal ever reaches device memory: the kernel reads
// the rows (and the tiny states) and writes three control-rate rows.  What
// bounds it on the H100, at the main path's shapes (3-min stereo track, L
// = 384, hop 8): its ~12.2 GFLOP of x @ T, 0.074 ms at the 3xTF32 rate,
// and ~0.2 GFLOP of states term on the fp32 cores, 0.004 ms, against ~77
// MB in and out (0.023 ms at 3.35 TB/s).  The TPU kernel sums buckets as a
// product with a 0/1 matrix (a matrix-unit trick); here they are plain
// sums from shared memory.
//
// An item is 128 rows (every channel of br = 128 / C blocks) and a span of
// W = lcm(h, 64) columns, which holds whole buckets and divides L (h and 64
// both divide it).  At hop 8 that is one column tile; a hop that does not
// divide 64 (3, 6, 12, ..) or exceeds it takes W / 64 tiles in a row, and
// the bucket that crosses from one tile into the next carries its partial
// sums in shared memory.  Each bucket is summed in one fixed order by one
// thread: the result is deterministic, with no atomics.
#include "tf32_wgmma.cuh"

namespace pam {

struct EnergiesEpilogue {
  const float* __restrict__ x;
  float* __restrict__ out;
  int C, nb, L, h, br;

  // A warp takes kBatch of its blocks at a time, a lane two columns: the
  // channels' sums of the three bands' squares (two channels' x loaded
  // before either is used), then, a block at a time, through the warp's
  // scratch, the buckets q0 .. q0 + nq - 1 that meet this tile, a lane a
  // (band, bucket): a bucket that began in the tile before adds its
  // carried sum, one that goes on into the next tile leaves it.
  static constexpr int kBatch = 2;
  struct Batch {
    int bl[kBatch];
    float2 xv[kBatch][2];
  };

  __device__ __forceinline__ void load(const wgb::TileCtx& t, int u0, int c,
                                       Batch& b) const {
    const size_t plane = (size_t)nb * L;
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      b.bl[q] = t.warp + wgb::kEpiWarps * (u0 + q);
#pragma unroll
      for (int k = 0; k < 2; ++k)
        b.xv[q][k] = b.bl[q] < t.blocks && c + k < C
                         ? __ldg(reinterpret_cast<const float2*>(
                               x + (c + k) * plane +
                               (size_t)(t.b0 + b.bl[q]) * L + t.j0 +
                               2 * t.lane))
                         : make_float2(0.f, 0.f);
    }
  }

  __device__ __forceinline__ void tile(const wgb::TileCtx& t) const {
    const int lh = L / h;
    const size_t T = (size_t)nb * lh;
    const float inv_c = 1.f / (float)C;
    const int q0 = t.j0 / h;
    const int nq = (t.j0 + wgb::kCols - 1) / h - q0 + 1;
    const int jj = 2 * t.lane;
    // the buckets that go on into the next tile of the span leave their
    // sums in one buffer, and the next tile reads them from it
    const float* c_in = t.carry + ((t.tt + 1) & 1) * 3 * wgb::kRows;
    float* c_out = t.carry + (t.tt & 1) * 3 * wgb::kRows;
    for (int u0 = 0; t.warp + wgb::kEpiWarps * u0 < t.blocks; u0 += kBatch) {
      Batch cur;
      float2 el[kBatch], em[kBatch], eh[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q)
        el[q] = em[q] = eh[q] = make_float2(0.f, 0.f);
      for (int c = 0; c < C; c += 2) {
        load(t, u0, c, cur);  // two channels' x, before either is used
#pragma unroll
        for (int q = 0; q < kBatch; ++q)
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            if (cur.bl[q] >= t.blocks || c + k >= C) continue;
            float2 lo, hi;
            wgb::bands_at(t, (c + k) * br + cur.bl[q], lo, hi);
            const float2 xv = cur.xv[q][k];
            const float2 mid =
                make_float2(xv.x - lo.x - hi.x, xv.y - lo.y - hi.y);
            el[q] = make_float2(fmaf(lo.x, lo.x, el[q].x),
                                fmaf(lo.y, lo.y, el[q].y));
            em[q] = make_float2(fmaf(mid.x, mid.x, em[q].x),
                                fmaf(mid.y, mid.y, em[q].y));
            eh[q] = make_float2(fmaf(hi.x, hi.x, eh[q].x),
                                fmaf(hi.y, hi.y, eh[q].y));
          }
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        if (cur.bl[q] >= t.blocks) break;
        float2* sc = reinterpret_cast<float2*>(t.scratch + jj);
        sc[0] = el[q];
        sc[wgb::kCols / 2] = em[q];
        sc[wgb::kCols] = eh[q];
        __syncwarp();
        const size_t b = (size_t)t.b0 + cur.bl[q];
        for (int u = t.lane; u < 3 * nq; u += 32) {
          const int band = u / nq;
          const int qq = q0 + u % nq;
          const int c0 = max(qq * h, t.j0) - t.j0;
          const int c1 = min((qq + 1) * h, t.j0 + wgb::kCols) - t.j0;
          const float* e = t.scratch + band * wgb::kCols;
          float sum =
              qq * h < t.j0 ? c_in[band * wgb::kRows + cur.bl[q]] : 0.f;
          for (int i = c0; i < c1; ++i) sum += e[i];
          if ((qq + 1) * h <= t.j0 + wgb::kCols)
            out[band * T + b * lh + qq] = sum * inv_c;
          else
            c_out[band * wgb::kRows + cur.bl[q]] = sum;
        }
        __syncwarp();  // the scratch is free for the next block
      }
    }
  }
};

__global__ void __launch_bounds__(wgb::kThreads, 1)
band_energies_kernel(const __grid_constant__ CUtensorMap xmap,
                     const float* __restrict__ x,
                     const float* __restrict__ packed,
                     const float* __restrict__ wt2,
                     const float* __restrict__ s_lp,
                     const float* __restrict__ s_hp, float* __restrict__ out,
                     wgb::Geometry g) {
  EnergiesEpilogue epi{x, out, g.C, g.nb, g.L, g.h, g.br};
  wgb::band_product(&xmap, packed, wt2, s_lp, s_hp, g, epi);
}

}  // namespace pam

// out (3, nb * L / h): low, mid, high.  `packed` is the crossover operator
// of ops/cuda_multiband.py's crossover_packed and wt2 (2, S, L) the
// transposed state operators.  Returns the CUDA error code of the launch
// (0 on success); cudaErrorInvalidValue for a shape the kernel does not
// take.
extern "C" int pam_band_energies(const float* x, const float* packed,
                                 const float* wt2, const float* s_lp,
                                 const float* s_hp, float* out, int C, int nb,
                                 int L, int S, int h, void* stream) {
  int a = h, b = pam::wgb::kCols;  // span = lcm(h, 64), a divisor of L
  while (b != 0) {
    const int r = a % b;
    a = b;
    b = r;
  }
  pam::wgb::Geometry g;
  if (h < 1 || !pam::wgb::geometry(C, nb, L, S, h,
                                   h / a * pam::wgb::kCols, g))
    return (int)cudaErrorInvalidValue;
  dim3 grid;
  CUtensorMap xmap;
  cudaError_t err =
      pam::wgb::prepare(pam::band_energies_kernel, x, g, grid, &xmap);
  if (err != cudaSuccess) return (int)err;
  pam::band_energies_kernel<<<grid, pam::wgb::kThreads, pam::wgb::kSmemBytes,
                              (cudaStream_t)stream>>>(xmap, x, packed, wt2,
                                                      s_lp, s_hp, out, g);
  return (int)cudaGetLastError();
}
