// band_energies: the multiband detector's input, the channel-mean squared
// energies of the three crossover bands summed over buckets of h samples.
//
// Replaces the TPU kernel python_audio_mastering_tpu/ops/pallas_multiband.py
// band_energies / _energies_kernel (+ _bands_block).  It recomputes the low
// and high bands of a tile from their incoming states as one product on the
// tensor cores in 3xTF32 (tf32_product.cuh with F = 2, band_gain_apply's
// product), forms mid = x - low - high, squares, sums over the channels and
// over buckets of h adjacent columns, so no band signal ever reaches device
// memory: the kernel reads the rows (and the tiny states) and writes three
// control-rate rows.  What bounds it on the H100, at the main path's shapes
// (3-min stereo track, L = 384, hop 8): its ~12.5 GFLOP of products, 0.076
// ms at the 3xTF32 rate (0.186 ms on the fp32 CUDA cores, where the first
// version's tile loop ran it), against ~78 MB in and out (0.023 ms at 3.35
// TB/s).  The TPU kernel sums buckets as a product with a 0/1 matrix (a
// matrix-unit trick); here they are plain sums from shared memory.
//
// A CTA owns kGM rows (every channel of br = kGM / C blocks), so the
// channel sums stay inside it, and a span of W = lcm(h, 64) columns, which
// holds whole buckets and divides L (h and 64 both divide it).  At hop 8
// that is one column tile of the product, as band_gain_apply's grid; a hop
// that does not divide 64 (3, 6, 12, ..) or exceeds it takes W / 64 tiles
// in a row, and the bucket that crosses from one tile into the next
// carries its partial sums in shared memory.  Each bucket is summed in one
// fixed order by one thread: the result is deterministic, with no atomics.
#include "tf32_product.cuh"

namespace pam {

constexpr int kEMidStride = kGN + 1;  // odd: conflict-free bucket reads
// the mid energies of a tile beside the result tile, in the ring
static_assert(kGM * kGEStride + kGM * kEMidStride <= kGRingFloats,
              "the mid energies fit in the ring beside the result tile");
// the carried partial sums (low, mid, high) of each block, two buffers
constexpr size_t kESmemBytes = kGSmemBytes + sizeof(float) * 2 * kGM * 3;

// as band_gain_apply: two CTAs of 128 rows an SM
__global__ void __launch_bounds__(kGThreads, 512 / kGThreads)
band_energies_kernel(const float* __restrict__ x, const float* __restrict__ t2,
                     const float* __restrict__ wt2,
                     const float* __restrict__ s_lp,
                     const float* __restrict__ s_hp, float* __restrict__ out,
                     int C, int nb, int L, int S, int br, int h, int span) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* emid = smem + kGM * kGEStride;
  float* carry = smem + kGSmemBytes / sizeof(float);
  const int b0 = blockIdx.y * br;
  for (int tt = 0; tt < span / kGN; ++tt) {
    // the spans with the most k-tiles first
    const int j0 = (gridDim.x - 1 - blockIdx.x) * span + tt * kGN;
    product_tile_tf32<2>(x, t2, wt2, s_lp, s_hp, C, nb, L, S, b0, br, j0,
                         RawX{}, smem);
    // Column energies, summed over the channels, written over the slots
    // that only this (block, column) read: low and high into the block's
    // first row of the result tile, mid beside it.
    for (int e = threadIdx.x; e < br * kGN; e += kGThreads) {
      const int bl = e / kGN;
      const int jj = e % kGN;
      const int b = b0 + bl;
      if (b >= nb) break;
      float el = 0.f, em = 0.f, eh = 0.f;
      for (int c = 0; c < C; ++c) {
        const float* r = smem + (bl * C + c) * kGEStride + jj;
        const float lo = r[0];
        const float hi = r[kGN];
        const float mid = x[((size_t)c * nb + b) * L + j0 + jj] - lo - hi;
        el = fmaf(lo, lo, el);
        em = fmaf(mid, mid, em);
        eh = fmaf(hi, hi, eh);
      }
      float* r0 = smem + bl * C * kGEStride + jj;
      r0[0] = el;
      r0[kGN] = eh;
      emid[bl * kEMidStride + jj] = em;
    }
    __syncthreads();
    // The buckets q0 .. q1 that meet this tile, one thread each: a bucket
    // that began in the tile before adds its carried sums, one that goes
    // on into the next tile leaves them in the other carry buffer.
    const float* c_in = carry + ((tt + 1) & 1) * kGM * 3;
    float* c_out = carry + (tt & 1) * kGM * 3;
    const int lh = L / h;
    const size_t T = (size_t)nb * lh;
    const float inv_c = 1.f / (float)C;
    const int q0 = j0 / h;
    const int nq = (j0 + kGN - 1) / h - q0 + 1;
    for (int e = threadIdx.x; e < br * nq; e += kGThreads) {
      const int bl = e / nq;
      const int q = q0 + e % nq;
      const int b = b0 + bl;
      if (b >= nb) break;
      const int c0 = max(q * h, j0) - j0;
      const int c1 = min((q + 1) * h, j0 + kGN) - j0;
      const float* r0 = smem + bl * C * kGEStride;
      const float* rm = emid + bl * kEMidStride;
      float el = 0.f, em = 0.f, eh = 0.f;
      if (q * h < j0) {
        el = c_in[bl * 3];
        em = c_in[bl * 3 + 1];
        eh = c_in[bl * 3 + 2];
      }
      for (int i = c0; i < c1; ++i) {
        el += r0[i];
        em += rm[i];
        eh += r0[kGN + i];
      }
      if ((q + 1) * h <= j0 + kGN) {
        const size_t o = (size_t)b * lh + q;
        out[o] = el * inv_c;
        out[T + o] = em * inv_c;
        out[2 * T + o] = eh * inv_c;
      } else {
        c_out[bl * 3] = el;
        c_out[bl * 3 + 1] = em;
        c_out[bl * 3 + 2] = eh;
      }
    }
    // the next tile's product synchronises before it stages into the ring
  }
}

}  // namespace pam

// out (3, nb * L / h): low, mid, high.  x and t2 must be 16-byte aligned.
// Refuses C·nb >= 2^31 rows (never addressable).  Returns the CUDA error
// code of the launch (0 on success).
extern "C" int pam_band_energies(const float* x, const float* t2,
                                 const float* wt2, const float* s_lp,
                                 const float* s_hp, float* out, int C, int nb,
                                 int L, int S, int h, void* stream) {
  if (C < 1 || C > pam::kGM || nb < 1 || S < 1 ||
      2 * S > pam::kGStateDepth || h < 1 || L < pam::kGN ||
      L % pam::kGN != 0 || L % h != 0 || (long long)C * nb >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  int a = h, b = pam::kGN;  // span = lcm(h, kGN), a divisor of L
  while (b != 0) {
    const int r = a % b;
    a = b;
    b = r;
  }
  const int span = h / a * pam::kGN;
  const int br = pam::kGM / C;
  const dim3 grid(L / span, (nb + br - 1) / br);
  cudaError_t err = cudaFuncSetAttribute(
      pam::band_energies_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)pam::kESmemBytes);
  if (err != cudaSuccess) return (int)err;
  pam::band_energies_kernel<<<grid, pam::kGThreads, pam::kESmemBytes,
                              (cudaStream_t)stream>>>(
      x, t2, wt2, s_lp, s_hp, out, C, nb, L, S, br, h, span);
  return (int)cudaGetLastError();
}
