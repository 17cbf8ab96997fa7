// K8: the exact direct-form II transposed recurrence of SOS cascades, one
// thread a column, in float32 and float64.  The driver is ops/sos_scan.py.
//
// Replaces no Pallas kernel: the JAX package runs this recurrence as an
// XLA lax.scan, python_audio_mastering_tpu/ops/iir.py:67 (sosfilt_scan),
// on its exact filter path (ChainConfig.filter_method "scan", and "auto"
// below 4 x block_size).  A per-sample loop of tensor ops would take hours
// on a 3-min track; this kernel walks it in one launch.
//
// Per sample and section, in the order of sosfilt_scan (and of scipy's
// sosfilt), every product and sum rounded on its own (no contraction):
//
//   y  = b0*x + z0
//   z0 = (b1*x - a1*y) + z1
//   z1 = b2*x - a2*y
//
// The plain twin (sos_scan_ref in ops/sos_scan.py) runs the same
// operations on the same values, so the two agree bit for bit.
//
// What bounds it on the H100: latency, not bandwidth.  Each section
// carries a loop of four dependent operations from y(t) to y(t+1) (the
// a1*y product, the subtraction, the z1 add, the b0*x + z0 add), about
// 8 ns a sample at ~4 cycles each; a 180 s stereo column is 7.94 M
// samples, ~64 ms whatever the section count if the sections overlap in
// the thread.  Its bytes (the column read once, the output written once)
// take 0.04 ms at 3.35 TB/s.  So the design only has to keep the
// recurrence fed: each thread loads the next kTile samples of its column
// into registers while it walks the current kTile, and keeps its sections'
// coefficients and states in registers.  A warp wavefront over sections
// and deeper prefetch are later work (ROADMAP queue 2).
//
// Layout: x is (R, N), R columns of N contiguous samples (the rows form
// (C, T, nb, L) read in place: each (channel, track) is one run of nb*L
// samples).  F cascades run in one launch over the same x, column c =
// f*R + r, output y (F, R, N).  sos is (F, kmax, 6), nsec (F,) the
// sections of each (at most kmax), zi and zf (F, kmax, 2, R) in scipy's
// (K, 2, C) layout per filter, n_valid (R,) the samples of each column
// before its padding: zf is the state after n_valid samples, and the
// output runs on over the whole column.  ysec, when not null (one
// cascade, F = 1), receives every section's output, (kmax, R, N): the
// gradient (ops/sos_scan.py) needs the signals between the sections.

#include <cuda_runtime.h>

namespace pam {

constexpr int kScanThreads = 32;

template <typename T>
struct ScanOps;

template <>
struct ScanOps<float> {
  static constexpr int kTile = 32;
  static __device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ float sub(float a, float b) {
    return __fsub_rn(a, b);
  }
};

template <>
struct ScanOps<double> {
  static constexpr int kTile = 16;
  static __device__ __forceinline__ double mul(double a, double b) {
    return __dmul_rn(a, b);
  }
  static __device__ __forceinline__ double add(double a, double b) {
    return __dadd_rn(a, b);
  }
  static __device__ __forceinline__ double sub(double a, double b) {
    return __dsub_rn(a, b);
  }
};

template <typename T, int KMAX>
__global__ void __launch_bounds__(kScanThreads)
    sos_scan_kernel(const T* __restrict__ x, const T* __restrict__ sos,
                    const int* __restrict__ nsec, const T* __restrict__ zi,
                    const long long* __restrict__ n_valid, T* __restrict__ y,
                    T* __restrict__ zf, T* __restrict__ ysec, int F, int R,
                    long long N) {
  using Op = ScanOps<T>;
  constexpr int kTile = Op::kTile;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= F * R) return;
  const int f = col / R, r = col % R;
  const int k = nsec[f];
  T b0[KMAX], b1[KMAX], b2[KMAX], a1[KMAX], a2[KMAX], z0[KMAX], z1[KMAX];
  T s0[KMAX], s1[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    const T* c = sos + ((long long)f * KMAX + j) * 6;
    b0[j] = c[0];
    b1[j] = c[1];
    b2[j] = c[2];
    a1[j] = c[4];
    a2[j] = c[5];
    const long long zo = (((long long)f * KMAX + j) * 2) * R + r;
    z0[j] = zi[zo];
    z1[j] = zi[zo + R];
    s0[j] = z0[j];
    s1[j] = z1[j];
  }
  const long long nv = n_valid[r];
  const T* xc = x + (long long)r * N;
  T* yc = y + (long long)col * N;

  T cur[kTile], nxt[kTile];
#pragma unroll
  for (int i = 0; i < kTile; ++i) cur[i] = i < N ? xc[i] : T(0);
  for (long long t0 = 0; t0 < N; t0 += kTile) {
    const long long tn = t0 + kTile;
    // the next tile's loads are in flight while this one is walked
#pragma unroll
    for (int i = 0; i < kTile; ++i) nxt[i] = tn + i < N ? xc[tn + i] : T(0);
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      const long long t = t0 + i;
      if (t < N) {
        T v = cur[i];
#pragma unroll
        for (int j = 0; j < KMAX; ++j) {
          if (j < k) {
            const T yj = Op::add(Op::mul(b0[j], v), z0[j]);
            z0[j] = Op::add(Op::sub(Op::mul(b1[j], v), Op::mul(a1[j], yj)),
                            z1[j]);
            z1[j] = Op::sub(Op::mul(b2[j], v), Op::mul(a2[j], yj));
            v = yj;
            if (ysec != nullptr) ysec[((long long)j * R + r) * N + t] = yj;
          }
        }
        yc[t] = v;
        if (t + 1 == nv) {
#pragma unroll
          for (int j = 0; j < KMAX; ++j) {
            s0[j] = z0[j];
            s1[j] = z1[j];
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kTile; ++i) cur[i] = nxt[i];
  }
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    const long long zo = (((long long)f * KMAX + j) * 2) * R + r;
    zf[zo] = s0[j];
    zf[zo + R] = s1[j];
  }
}

template <typename T>
int launch_sos_scan(const T* x, const T* sos, const int* nsec, const T* zi,
                    const long long* n_valid, T* y, T* zf, T* ysec, int F,
                    int R, long long N, int kmax, void* stream) {
  if (F < 1 || R < 1 || N < 1 || (long long)F * R > (1LL << 30) ||
      (ysec != nullptr && F != 1))
    return (int)cudaErrorInvalidValue;
  const int grid = (F * R + kScanThreads - 1) / kScanThreads;
  cudaStream_t s = (cudaStream_t)stream;
  switch (kmax) {
    case 2:
      sos_scan_kernel<T, 2><<<grid, kScanThreads, 0, s>>>(
          x, sos, nsec, zi, n_valid, y, zf, ysec, F, R, N);
      break;
    case 4:
      sos_scan_kernel<T, 4><<<grid, kScanThreads, 0, s>>>(
          x, sos, nsec, zi, n_valid, y, zf, ysec, F, R, N);
      break;
    case 8:
      sos_scan_kernel<T, 8><<<grid, kScanThreads, 0, s>>>(
          x, sos, nsec, zi, n_valid, y, zf, ysec, F, R, N);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace pam

// y (F, R, N) and zf (F, kmax, 2, R) from x (R, N); kmax is 2, 4 or 8
// and every nsec[f] <= kmax (see the layout above); ysec null or (kmax, R,
// N) with F = 1.
extern "C" int pam_sos_scan_f32(const float* x, const float* sos,
                                const int* nsec, const float* zi,
                                const long long* n_valid, float* y, float* zf,
                                float* ysec, int F, int R, long long N,
                                int kmax, void* stream) {
  return pam::launch_sos_scan<float>(x, sos, nsec, zi, n_valid, y, zf, ysec,
                                     F, R, N, kmax, stream);
}

extern "C" int pam_sos_scan_f64(const double* x, const double* sos,
                                const int* nsec, const double* zi,
                                const long long* n_valid, double* y,
                                double* zf, double* ysec, int F, int R,
                                long long N, int kmax, void* stream) {
  return pam::launch_sos_scan<double>(x, sos, nsec, zi, n_valid, y, zf, ysec,
                                      F, R, N, kmax, stream);
}
