// kweight_cells: K-weighted energies summed over buckets of h samples, the
// input of the BS.1770 loudness cells.
//
// Replaces the TPU kernel python_audio_mastering_tpu/ops/pallas_multiband.py
// kweight_cells / _cells_kernel.  It recomputes the K-weighted signal of a
// tile from its incoming states (tf32_wgmma.cuh, one filter in 64-column
// tiles: x @ T in 3xTF32 on wgmma, the states term in fp32), squares it
// and writes only the h-bucket sums, so the K-weighted signal never
// reaches device memory.  What bounds it on the H100, at the main path's
// shapes (the 3-min track's mono rows, L = 384, S = 4): its ~3.1 GFLOP of
// products, 0.019 ms with x @ T in 3xTF32 on the tensor cores, against
// ~32 MB in and ~5 MB out (0.011 ms at 3.35 TB/s).  The states term runs
// in fp32 on the epilogue warps: the K-weighting's state operator is ~70
// times the signal, and its 3xTF32 rounding alone would put ~1.3e-5 of
// the max on the product, ten times what x @ T carries.  The TPU kernel
// sums buckets as a product with a 0/1 matrix (a matrix-unit trick); here
// they are plain sums from shared memory.
//
// An item is 128 rows (every channel of br = 128 / C blocks) and a span of
// lcm(h, 64) columns, which holds whole buckets and divides L (h and 64
// both divide it): at L = 384, 192 columns for the chain's h = 6 (44.1
// kHz) and 192 (48 kHz), so a row tile is two items and the 3-min track's
// 162 row tiles give 324 items for the card's 132 SMs; the streamed
// chunk's 23 give 46.  A span's 64-column tiles run in a row on one CTA,
// and a bucket that crosses from one tile into the next carries its
// partial sum in shared memory (band_energies' scheme): each bucket is
// summed in one fixed order by one thread, so the result is
// deterministic, with no atomics and no scratch in device memory.
#include "tf32_wgmma.cuh"

namespace pam {

// 64 columns a tile, four stages (32 KB each); the epilogue's shared
// memory: a scratch of kBatch rows of 64 values an epilogue warp, the
// carried sums of two tiles (a tile row each), and each warp's table of
// its rows' output offsets
constexpr int kBatch = 8;
constexpr int kWarpRows = wgb::kRows / wgb::kEpiWarps;  // a warp's rows
constexpr int kScratchFloats = wgb::kEpiWarps * kBatch * 64;
constexpr int kCarryFloats = 2 * wgb::kRows;
constexpr int kCellsEpiBytes =
    (kScratchFloats + kCarryFloats) * 4 + wgb::kRows * 8;
// its consumers (N = 64: half of K1's accumulators) and its epilogue
// warpgroups (the pairs' sums side by side, Wᵀ's 16 rows) take 112
// registers each
using CellsShape = wgb::One<64, 4, kCellsEpiBytes, 112, 112>;

struct CellsEpilogue {
  float* __restrict__ out;
  int C, nb, L, h, br;

  // A warp takes the tile rows r = warp + 8 k (k < 16; (channel, block)
  // = (r / br, r % br)), kBatch of them at a time, a lane two columns: the
  // rows' values through the warp's scratch, then the (row, bucket) pairs
  // of the buckets q0 .. q0 + nq - 1 that meet this tile, kPairs a lane at
  // a time so that their serial sums run side by side: a bucket that
  // began in the tile before adds its carried sum, one that goes on into
  // the next tile leaves it.  Row r is the same warp's in every tile, so a
  // carry needs no barrier.  No division a pair: the warp's rows' output
  // offsets are a table made once a tile, and a lane's pairs (q, qq) step
  // by 32 pairs at a time.
  static constexpr int kPairs = 3;

  __device__ __forceinline__ void tile(const wgb::Tile1& t) const {
    constexpr int kW = CellsShape::kN;
    const int lh = L / h;
    const int q0 = t.j0 / h;
    const int nq = (t.j0 + kW - 1) / h - q0 + 1;
    const int rows = C * br;
    const int pairs = kBatch * nq;
    float* scratch = t.epi + t.warp * kBatch * kW;
    float* carry = t.epi + kScratchFloats;
    const float* c_in = carry + ((t.tt + 1) & 1) * wgb::kRows;
    float* c_out = carry + (t.tt & 1) * wgb::kRows;
    long long* offs =
        reinterpret_cast<long long*>(carry + kCarryFloats) + t.warp * kWarpRows;
    if (t.lane < kWarpRows) {  // row first + step * lane: its offset, or -1
      const int r = t.first + t.step * t.lane;
      const int c = r / br;
      const int bl = r - c * br;
      offs[t.lane] = r < rows && bl < t.blocks
                         ? (long long)((size_t)c * nb + t.b0 + bl) * lh
                         : -1;
    }
    const int dq = 32 / nq, dqq = 32 - dq * nq;  // 32 pairs on
    const int lq = t.lane / nq, lqq = t.lane - lq * nq;
    for (int k0 = 0; k0 < kWarpRows; k0 += kBatch) {
      const int r0 = t.first + t.step * k0;
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int r = r0 + q * t.step;
        if (r < rows)
          *reinterpret_cast<float2*>(scratch + q * kW + t.c0) =
              wgb::value_at<CellsShape>(t, r);
      }
      __syncwarp();
      int q = lq, qq = lqq;  // the lane's next pair: row k0 + q, bucket qq
      for (int u0 = t.lane; u0 < pairs; u0 += 32 * kPairs) {
        // a pair: its row q of the batch, bucket q0 + qq, first column at
        // of the scratch, columns len in this tile (0: no pair), sum
        int pq[kPairs], pqq[kPairs], at[kPairs], len[kPairs], most = 0;
        float sum[kPairs];
#pragma unroll
        for (int p = 0; p < kPairs; ++p) {
          const int b = q0 + qq;
          const bool ok = u0 + 32 * p < pairs && offs[k0 + q] >= 0;
          const int c0 = max(b * h, t.j0) - t.j0;
          pq[p] = q;
          pqq[p] = qq;
          at[p] = q * kW + c0;
          len[p] = ok ? min((b + 1) * h, t.j0 + kW) - t.j0 - c0 : 0;
          sum[p] = ok && b * h < t.j0 ? c_in[r0 + q * t.step] : 0.f;
          most = max(most, len[p]);
          q += dq;
          qq += dqq;
          if (qq >= nq) {
            qq -= nq;
            ++q;
          }
        }
        for (int i = 0; i < most; ++i)
#pragma unroll
          for (int p = 0; p < kPairs; ++p)
            if (i < len[p])
              sum[p] = fmaf(scratch[at[p] + i], scratch[at[p] + i], sum[p]);
#pragma unroll
        for (int p = 0; p < kPairs; ++p) {
          if (len[p] == 0) continue;
          const int b = q0 + pqq[p];
          if ((b + 1) * h <= t.j0 + kW)
            out[offs[k0 + pq[p]] + b] = sum[p];
          else
            c_out[r0 + pq[p] * t.step] = sum[p];
        }
      }
      __syncwarp();  // the scratch is free for the next batch
    }
  }
};

__global__ void __launch_bounds__(wgb::kThreads, 1)
kweight_cells_kernel(const __grid_constant__ CUtensorMap xmap,
                     const float* __restrict__ packed,
                     const float* __restrict__ wt,
                     const float* __restrict__ s_in, float* __restrict__ out,
                     wgb::Geometry g) {
  CellsEpilogue epi{out, g.C, g.nb, g.L, g.h, g.br};
  wgb::one_product<CellsShape>(&xmap, packed, wt, s_in, g, wgb::NoX{}, epi);
}

}  // namespace pam

// out (C, nb * L / h).  `packed` is the K-filter's operator of
// ops/cuda_multiband.py's packed_operator (64-column tiles), wt (S, L) the
// transposed state operator; x 16-byte aligned.  Refuses C > 128 (the
// tile height), S > 16, L not a multiple of 64, h not dividing L and C·nb
// >= 2^31 rows (never addressable).  Returns the CUDA error code of the
// launch (0 on success).
extern "C" int pam_kweight_cells(const float* x, const float* packed,
                                 const float* wt, const float* s_in,
                                 float* out, int C, int nb, int L, int S,
                                 int h, void* stream) {
  using Sh = pam::CellsShape;
  int a = h, b = Sh::kN;  // span = lcm(h, 64), a divisor of L
  while (b != 0) {
    const int r = a % b;
    a = b;
    b = r;
  }
  pam::wgb::Geometry g;
  if (h < 1 || !pam::wgb::geometry(C, nb, L, S, h, h / a * Sh::kN, g,
                                   Sh::kN, pam::wgb::kMaxS1))
    return (int)cudaErrorInvalidValue;
  dim3 grid;
  CUtensorMap xmap;
  cudaError_t err = pam::wgb::prepare(pam::kweight_cells_kernel, x, g, grid,
                                      &xmap, Sh::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  pam::kweight_cells_kernel<<<grid, pam::wgb::kThreads, Sh::kSmemBytes,
                              (cudaStream_t)stream>>>(xmap, packed, wt, s_in,
                                                      out, g);
  return (int)cudaGetLastError();
}
