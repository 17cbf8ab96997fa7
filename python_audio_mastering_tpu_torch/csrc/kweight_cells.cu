// kweight_cells: K-weighted energies summed over buckets of h samples, the
// input of the BS.1770 loudness cells.
//
// Replaces the TPU kernel python_audio_mastering_tpu/ops/pallas_multiband.py
// kweight_cells / _cells_kernel.  It recomputes the K-weighted signal of a
// tile from its incoming states as one product (tf32_product.cuh with one
// filter: 128 rows x 128 columns a CTA), squares it and writes only the
// h-bucket sums, so the K-weighted signal never reaches device memory.
// What bounds it on the H100, at the main path's shapes (the 3-min track's
// mono rows, L = 384, S = 4): its ~3.1 GFLOP of products, 0.019 ms with
// x @ T in 3xTF32 on the tensor cores (0.047 ms on the fp32 CUDA cores),
// against ~32 MB in and ~5 MB out (0.011 ms at 3.35 TB/s).  The states
// term s_in @ Wt runs in fp32 on the CUDA cores (the header's kFp32States):
// the K-weighting's state operator is ~70 times the signal, and its 3xTF32
// rounding alone would put ~1.3e-5 of the max on the product, ten times
// what x @ T carries.  The TPU kernel sums buckets as a product with a
// 0/1 matrix (a matrix-unit trick); here they are plain sums from shared
// memory.
//
// A CTA owns kGM rows (every channel of br = kGM / C blocks) and one
// column tile, so that a mono track's few row groups still fill the card
// (the 3-min track is 162 row groups, 486 CTAs at L = 384; a streamed
// chunk 23 groups, 69 CTAs).  A bucket inside the tile is summed and
// written at once.  Where h does not divide 128 (h = 6 at 44.1 kHz and 192
// at 48 kHz, with L = 384), a bucket can cross a tile edge: each tile
// leaves the pieces it holds of such buckets in a scratch buffer, and the
// last CTA of the row group to finish (a ticket counted with atomicAdd,
// which that CTA sets back to 0) adds every crossing bucket's pieces, left
// to right, and writes it.  Each
// bucket is summed in one fixed order: the result is deterministic,
// whichever CTA finishes last.
#include "tf32_product.cuh"

namespace pam {

constexpr int kKCols = 2 * kGN;  // columns of a product tile (one filter)

// as front_chain: two CTAs of 128 rows an SM
__global__ void __launch_bounds__(kGThreads, 512 / kGThreads)
kweight_cells_kernel(const float* __restrict__ x, const float* __restrict__ t,
                     const float* __restrict__ wt,
                     const float* __restrict__ s_in, float* __restrict__ out,
                     float* part, int* tickets, int C, int nb, int L, int S,
                     int br, int h) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ bool last;
  const int n_tiles = gridDim.x;
  const int tile = n_tiles - 1 - blockIdx.x;  // the most k-tiles first
  const int j0 = tile * kKCols;
  const int b0 = blockIdx.y * br;
  const int rows = br * C;
  const int lh = L / h;
  product_tile_tf32<1, RawX, true>(x, t, wt, s_in, nullptr, C, nb, L, S, b0,
                                   br, j0, RawX{}, smem);
  // the pieces of crossing buckets: (row group, tile, row, side), side 0
  // the bucket that began before the tile, 1 the one that goes on past it
  float* my_part = part + ((size_t)blockIdx.y * n_tiles + tile) * kGM * 2;
  const int q0 = j0 / h;
  const int nq = (j0 + kKCols - 1) / h - q0 + 1;
  for (int e = threadIdx.x; e < rows * nq; e += kGThreads) {
    const int r = e / nq;
    const int q = q0 + e % nq;
    const int b = b0 + r / C;
    if (b >= nb) break;
    const int c0 = max(q * h, j0) - j0;
    const int c1 = min((q + 1) * h, j0 + kKCols) - j0;
    const float* v = smem + r * kGEStride;
    float s = 0.f;
    for (int i = c0; i < c1; ++i) s = fmaf(v[i], v[i], s);
    if (q * h >= j0 && (q + 1) * h <= j0 + kKCols)
      out[((size_t)(r % C) * nb + b) * lh + q] = s;
    else
      my_part[r * 2 + (q * h < j0 ? 0 : 1)] = s;
  }
  if (kKCols % h == 0 || n_tiles == 1) return;  // no bucket crosses a tile

  __threadfence();  // the pieces, before the ticket that hands them over
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&tickets[blockIdx.y], 1) == n_tiles - 1;
  __syncthreads();
  if (!last) return;
  // every tile of the group has taken its ticket: zero it for the next
  // launch, so the caller keeps one buffer and never clears it
  if (threadIdx.x == 0) tickets[blockIdx.y] = 0;
  __threadfence();
  // Every tile of the group is done: each crossing bucket, at the first
  // tile edge it crosses, adds its pieces left to right.
  const float* grp = part + (size_t)blockIdx.y * n_tiles * kGM * 2;
  for (int e = threadIdx.x; e < rows * (n_tiles - 1); e += kGThreads) {
    const int r = e / (n_tiles - 1);
    const int edge = (e % (n_tiles - 1) + 1) * kKCols;
    const int b = b0 + r / C;
    const int q = edge / h;
    if (b >= nb) break;
    // no bucket crosses this edge, or it crossed the edge before
    if (edge % h == 0 || q * h < edge - kKCols) continue;
    float s = 0.f;
    for (int tt = q * h / kKCols; tt * kKCols < (q + 1) * h; ++tt)
      s += __ldcg(grp + ((size_t)tt * kGM + r) * 2 +
                  (q * h < tt * kKCols ? 0 : 1));
    out[((size_t)(r % C) * nb + b) * lh + q] = s;
  }
}

}  // namespace pam

// out (C, nb * L / h).  part (ceil(nb / (128 / C)), L / 128, 128, 2)
// float and tickets (at least ceil(nb / (128 / C))) int, zeros, left at
// zeros, are scratch, used only when 128 % h != 0 (else they may be
// null); launches that share tickets must not overlap.  x and t must be
// 16-byte aligned.  Refuses C > 128 (the tile height), S > 16, L not a
// multiple of 128, h not dividing L and C·nb >= 2^31 rows (never
// addressable).
// Returns the CUDA error code of the launch (0 on success).
extern "C" int pam_kweight_cells(const float* x, const float* t,
                                 const float* wt, const float* s_in,
                                 float* out, float* part, int* tickets, int C,
                                 int nb, int L, int S, int h, void* stream) {
  if (C < 1 || C > pam::kGM || nb < 1 || S < 1 || S > pam::kGStateDepth ||
      h < 1 || L < pam::kKCols || L % pam::kKCols != 0 || L % h != 0 ||
      (long long)C * nb >= (1LL << 31) ||
      (pam::kKCols % h != 0 && (part == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int br = pam::kGM / C;
  const dim3 grid(L / pam::kKCols, (nb + br - 1) / br);
  cudaError_t err = cudaFuncSetAttribute(
      pam::kweight_cells_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)pam::kGSmemBytes);
  if (err != cudaSuccess) return (int)err;
  pam::kweight_cells_kernel<<<grid, pam::kGThreads, pam::kGSmemBytes,
                              (cudaStream_t)stream>>>(
      x, t, wt, s_in, out, part, tickets, C, nb, L, S, br, h);
  return (int)cudaGetLastError();
}
