// gain_limit: the chain's tail in one pass.  Each track's loudness gain,
// the soft limiter of either chain variant and the unfold from the rows
// form (C, T, M) to the mastered (T, n, C), M = nb·L >= n.
//
// Replaces no TPU kernel: the JAX package leaves the gain, the limiter and
// the transpose to XLA, which fuses them into one elementwise pass.  In
// plain torch they were a full multiply, a strided read of the (T, n, C)
// view and a dozen more elementwise passes, each a full-size temporary.
//
// What bounds it on the H100: bytes.  An album of 12 stereo tracks of
// 420 s is 445 M samples, 1.78 GB read and 1.78 GB written, 1.06 ms at
// 3.35 TB/s; the limiter is ~10 operations a sample, far under the fp32
// rate.  The design streams: a persistent grid (as many CTAs of 256
// threads as the card holds at once, at least 4 an SM: 32 KB of loads in
// flight an SM, enough to cover the memory's latency) walks each
// track in quads of 4 frames.  A thread loads the quad of every channel
// with one 128-bit load each (the rows are contiguous in time), limits
// the 4·C samples in registers and stores them interleaved, (n, C) order,
// as 128-bit stores where the quad's output offset is 16-byte aligned,
// 64-bit where it is 8-byte aligned (a track whose t·n·C offset is 2 mod
// 4), else single floats; a track's last quad stores only its valid
// frames.  Loads and stores carry the streaming hint (.cs): every byte is
// touched once.  The gain is read from device memory, one float a track.
//
// The arithmetic is torch's CUDA ops', in their order, each rounded once:
// no contraction (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn), a Python
// scalar rounded to float32, and ``over / knee`` as torch's true division
// by a scalar computes it, a multiply by the float reciprocal.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace pam {

constexpr int kGainLimitThreads = 256;
constexpr int kGainLimitMinCtas = 4;   // an SM, at most 64 registers a thread

// waveshaper.soft_limiter: thr + (|z| - thr) / sqrt(1 + ((|z| - thr) /
// knee)^2), times sign(z), where |z| > thr; z elsewhere.
struct RationalKnee {
  float thr, inv_knee;
  __device__ __forceinline__ float operator()(float z) const {
    const float a = fabsf(z);
    if (!(a > thr)) return z;
    const float over = __fadd_rn(a, -thr);
    const float q = __fmul_rn(over, inv_knee);
    const float s = __fsqrt_rn(__fadd_rn(__fmul_rn(q, q), 1.f));
    const float lim = __fadd_rn(__fdiv_rn(over, s), thr);
    return __fmul_rn(lim, (float)((0.f < z) - (z < 0.f)));
  }
};

// waveshaper.soft_limiter_legacy: tanh(z)·thr where |z| > thr.
struct TanhClip {
  float thr;
  __device__ __forceinline__ float operator()(float z) const {
    return fabsf(z) > thr ? __fmul_rn(tanhf(z), thr) : z;
  }
};

// N floats to dst, as 16-byte stores where dst allows, else 8-byte, else
// 4-byte ones (N a multiple of 4).
template <int N>
__device__ __forceinline__ void store_quad(float* dst, const float (&v)[N]) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(dst);
  if ((at & 15) == 0) {
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
      __stcs(reinterpret_cast<float4*>(dst) + j,
             make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]));
  } else if ((at & 7) == 0) {
#pragma unroll
    for (int j = 0; j < N / 2; ++j)
      __stcs(reinterpret_cast<float2*>(dst) + j,
             make_float2(v[2 * j], v[2 * j + 1]));
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) __stcs(dst + j, v[j]);
  }
}

// x (C, T, M), y (T, n, C), gain (T,) or null.  CT: the channel count (1
// or 2) fixed at compile time, or 0 for any C (scalar loads and stores).
// vec: M a multiple of 4 and x 16-byte aligned (the quads' loads).
template <int CT, class Limiter>
__global__ void __launch_bounds__(kGainLimitThreads, kGainLimitMinCtas)
gain_limit_kernel(const float* __restrict__ x,
                  const float* __restrict__ gain, float* __restrict__ y,
                  int C_any, int T, long long M, long long n, bool vec,
                  Limiter lim) {
  const int C = CT > 0 ? CT : C_any;
  const long long plane = (long long)T * M;  // one channel to the next
  const long long quads = (n + 3) / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (int t = 0; t < T; ++t) {
    const bool gained = gain != nullptr;
    const float g = gained ? __ldg(gain + t) : 1.f;
    const float* xt = x + (long long)t * M;
    float* yt = y + (long long)t * n * C;
    for (long long q = first; q < quads; q += stride) {
      const long long i0 = 4 * q;
      const int frames = (int)min(4LL, n - i0);
      if constexpr (CT > 0) {
        float v[4 * CT];
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          const float* src = xt + c * plane + i0;
          float4 u;
          if (vec) {
            u = __ldcs(reinterpret_cast<const float4*>(src));
          } else {
            u.x = __ldcs(src);
            u.y = frames > 1 ? __ldcs(src + 1) : 0.f;
            u.z = frames > 2 ? __ldcs(src + 2) : 0.f;
            u.w = frames > 3 ? __ldcs(src + 3) : 0.f;
          }
          const float in[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
          for (int f = 0; f < 4; ++f)
            v[f * CT + c] = lim(gained ? __fmul_rn(in[f], g) : in[f]);
        }
        float* dst = yt + i0 * CT;
        if (frames == 4) {
          store_quad<4 * CT>(dst, v);
        } else {
          for (int j = 0; j < frames * CT; ++j) __stcs(dst + j, v[j]);
        }
      } else {
        for (int f = 0; f < frames; ++f)
          for (int c = 0; c < C; ++c) {
            const float in = __ldcs(xt + c * plane + i0 + f);
            __stcs(yt + (i0 + f) * C + c,
                   lim(gained ? __fmul_rn(in, g) : in));
          }
      }
    }
  }
}

template <int CT, class Limiter>
cudaError_t launch_as(const float* x, const float* gain, float* y, int C,
                      int T, long long M, long long n, Limiter lim,
                      cudaStream_t stream) {
  auto kernel = gain_limit_kernel<CT, Limiter>;
  int dev = 0, sms = 0, occ = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, kernel, kGainLimitThreads, 0);
  if (err != cudaSuccess) return err;
  // as many CTAs as the card holds at once, none without a quad
  const long long quads = (n + 3) / 4;
  const int grid = (int)std::max<long long>(
      1, std::min<long long>((long long)sms * std::max(occ, 1),
                             (quads + kGainLimitThreads - 1) /
                                 kGainLimitThreads));
  const bool vec = M % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  kernel<<<grid, kGainLimitThreads, 0, stream>>>(x, gain, y, C, T, M, n, vec,
                                                 lim);
  return cudaGetLastError();
}

template <class Limiter>
cudaError_t launch_gain_limit(const float* x, const float* gain, float* y,
                              int C, int T, long long M, long long n,
                              Limiter lim, cudaStream_t stream) {
  if (C == 2) return launch_as<2>(x, gain, y, C, T, M, n, lim, stream);
  if (C == 1) return launch_as<1>(x, gain, y, C, T, M, n, lim, stream);
  return launch_as<0>(x, gain, y, C, T, M, n, lim, stream);
}

}  // namespace pam

// y (T, n, C) from x (C, T, M), M >= n: y[t, i, c] = limiter(gain[t] ·
// x[c, t, i]), gain (T,) on the device or null (no gain).  variant 0: the
// worker's rational knee at `threshold` and `knee`; 1: the legacy tanh.
// y must be 16-byte aligned.  Returns the CUDA error code of the launch
// (0 on success).
extern "C" int pam_gain_limit(const float* x, const float* gain, float* y,
                              int C, int T, long long M, long long n,
                              float threshold, float knee, int variant,
                              void* stream) {
  if (C < 1 || T < 1 || n < 1 || M < n || variant < 0 || variant > 1 ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (variant == 1)
    return (int)pam::launch_gain_limit(x, gain, y, C, T, M, n,
                                       pam::TanhClip{threshold}, s);
  return (int)pam::launch_gain_limit(x, gain, y, C, T, M, n,
                                     pam::RationalKnee{threshold, 1.f / knee},
                                     s);
}
