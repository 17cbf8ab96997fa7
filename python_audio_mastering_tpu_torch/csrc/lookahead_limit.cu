// lookahead_limit: the quality mode's lookahead true-peak limiter
// (ops/limiter.py) over one track (n, C) in one launch: the 4x oversampled
// peak envelope, the raw gain, its erosion and look-wide moving average
// (the attack), the release and the gain's multiply.
//
// Replaces no TPU kernel: the JAX package runs ops/limiter.py's jnp ops
// through XLA.  In plain torch they were ~40 whole-track passes: the
// interpolator's 4x output written to device memory and read back for
// its max, eight doubling passes of a windowed min, a float64 running sum
// and a float64 log-domain prefix max.
//
// What bounds it on the H100: arithmetic.  The interpolator is a direct
// FIR of 4 phases x 32 taps, 128 float32 FMAs a sample and channel, on
// the CUDA cores (no TF32: the configuration refuses TF32 products);
// each frame is read once and written once.  A 12-track album of 151 M
// stereo positions is ~77 GFLOP of FIR (1.16 ms at 67 TFLOP/s) against
// 2.4 GB (0.72 ms at 3.35 TB/s).
//
// The design.  A persistent grid (two CTAs of 256 threads an SM) takes
// tiles of P = 4352 - 3 look output frames (4154 at look = 66) from a
// counter, so that tiles start in order.  A tile's gains need its frames
// and look + 16 before and 2 look + 16 after (~5 % more FIR); they come
// a channel plane at a time into a ring of three shared-memory planes by
// asynchronous copies (zeros outside the track: the interpolator's
// padding), the next plane, or the next tile's first, loading while the
// current one is filtered.  Over 4352 slots of position (17 consecutive
// slots a thread: an odd stride, so the strided shared-memory reads are
// free of bank conflicts) each thread runs the FIR a phase at a time, the
// 32 taps in registers, in the order of cuBLAS's product over the plain
// path's banded operator (so the envelope is the same bits), and keeps
// the largest |sample| and |phase output| of each slot: the 4x output
// never leaves the registers.  The raw gain min(1, ceiling / max(peak,
// 1e-9)) goes to shared memory, the track's first and last gains
// replicated past its ends.  The erosion, a window min of 2 look + 1, is
// a suffix min in the thread's own segment, a min over whole segments'
// minima and a prefix min in the segment it ends in.  The moving average
// differences a float64 prefix sum over the tile (exact for gains of
// float32: the direct sum, to which the plain path's float64 running sum
// rounds), divided by look and rounded to float32.
//
// The release g[i] = min(t[i], 1 - (1 - g[i-1]) rho), in float64: with
// u = 1 - g it is u[i] = max(1 - t[i], rho u[i-1]), whose steps (a, f) =
// (1 - t, rho) compose associatively, (a1, f1) then (a2, f2) = (max(a2,
// f2 a1), f1 f2).  Each thread composes its 17 frames from u = 0, a warp
// shuffle scan and a scan of the 8 warps' totals give each thread the
// composition of the frames before it in the tile, and the tiles chain by
// decoupled look-back: a tile publishes its own composition at once, then
// a warp reads its predecessors' 32 at a time (u before tile k is the max
// over them of their aggregate times rho^P per tile between) until one
// has published its inclusive value or the weight falls under 2^-60
// (~27 tiles at the defaults), which no float32 gain can see.  Each
// thread runs its 17 steps again from its true u, min(t, 1 - u), rounds
// to float32, and the CTA writes x * g, contiguous (n, C), coalesced, x
// from the ring for one or two channels (read again from the L2 cache for
// more).
#include <cuda_runtime.h>

#include <cstdint>

namespace pam {

constexpr int kLlThreads = 256;
constexpr int kLlSeg = 17;                            // slots a thread
constexpr int kLlSlots = kLlThreads * kLlSeg;         // 4352
constexpr int kLlPhases = 4;
constexpr int kLlTaps = 32;                           // taps a phase
constexpr int kLlKhalf = kLlTaps / 2;                 // 16
constexpr int kLlWarps = kLlThreads / 32;
// P = kLlSlots - 3 * look frames a tile must stay positive
constexpr int kLlMaxLook = (kLlSlots - kLlThreads) / 3;

// frames of one channel a tile reads: its slots and the FIR's halo
__host__ __device__ constexpr int ll_width(bool tp) {
  return kLlSlots + (tp ? 2 * kLlKhalf : 0);
}

constexpr int kLlRing = 3;   // channel planes: a stereo tile's two, the next

// dynamic shared memory: the float64 prefix sums, the taps, the ring of
// channel planes and the gains
__host__ __device__ constexpr size_t ll_smem_bytes(bool tp) {
  return sizeof(double) * (kLlSlots + 2) +
         sizeof(float) * (kLlPhases * kLlTaps + kLlRing * ll_width(tp) +
                          kLlSlots);
}

// (a, f) after (a_prev, f_prev): the release's steps composed
__device__ __forceinline__ void ll_compose(double a_prev, double f_prev,
                                           double& a, double& f) {
  a = fmax(a, f * a_prev);
  f = f * f_prev;
}

// the moving average's float64 quotient sum / look, as a division
// rounds it: the product by 1 / look is within 3 units in the last place
// of it, so it rounds to the same float32 unless it lies within 4 units
// of a float32 halfway point (low 29 bits 0x10000000), where the division
// decides
__device__ __forceinline__ float ll_mean(double sum, double inv_look,
                                         int look) {
  const double q = sum * inv_look;
  const int low = (int)(__double_as_longlong(q) & 0x1fffffff);
  return __double2float_rn(abs(low - 0x10000000) <= 4 ? sum / (double)look
                                                       : q);
}

// one channel's frames x0 .. x0 + width - 1 (zeros outside [0, n)) into
// a shared-memory plane by asynchronous 4-byte copies, one group a thread
template <int width>
__device__ __forceinline__ void ll_load_plane(float* dst, const float* xc,
                                              long long sn, long long x0,
                                              long long n, int tid) {
#pragma unroll
  for (int j = 0; j < (width + kLlThreads - 1) / kLlThreads; ++j) {
    const int i = tid + j * kLlThreads;
    if (i < width) {
      const long long pos = x0 + i;
      const bool ok = pos >= 0 && pos < n;
      const unsigned d = (unsigned)__cvta_generic_to_shared(dst + i);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                   "l"(ok ? xc + pos * sn : xc), "r"(ok ? 4 : 0)
                   : "memory");
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void ll_wait_planes() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// x (n, C) at element strides (sn, sc); y (n, C) contiguous.  flags: the
// tiles' states (0 none, 1 aggregate, 2 inclusive) then the tile
// counter, all 0 on entry; vals: the tiles' aggregates then inclusive
// values.  A persistent grid: each CTA takes tiles from the counter until
// none is left.
template <bool TP>
__global__ void __launch_bounds__(kLlThreads, 2)
lookahead_limit_kernel(const float* __restrict__ x, float* __restrict__ y,
                       long long n, int C, long long sn, long long sc,
                       int look, int P, float ceiling, double rho,
                       double rho_tile, const float* __restrict__ taps,
                       int* flags, double* vals, int tiles) {
  extern __shared__ double smem64[];
  constexpr int khalf = TP ? kLlKhalf : 0;
  constexpr int width = ll_width(TP);
  double* pre = smem64;                                   // [kLlSlots + 1]
  float* taps_s = reinterpret_cast<float*>(pre + kLlSlots + 2);
  float* planes = taps_s + kLlPhases * kLlTaps;     // [kLlRing][width]
  float* gbuf = planes + kLlRing * width;           // [kLlSlots]
  __shared__ float seg_min[kLlThreads], win_lo[kLlThreads],
      win_hi[kLlThreads];
  __shared__ double warp_a[kLlWarps], warp_f[kLlWarps], warp_s[kLlWarps];
  __shared__ double s_uin;
  __shared__ float s_att_last;
  __shared__ int s_tile, s_next;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int q0 = tid * kLlSeg;
  const float kInf = __int_as_float(0x7f800000);
  const double inv_look = 1.0 / (double)look;
  if (tid == 0) s_tile = atomicAdd(flags + tiles, 1);
  if (TP && tid < kLlPhases * kLlTaps)
    taps_s[(tid % kLlPhases) * kLlTaps + tid / kLlPhases] = __ldg(taps + tid);
  __syncthreads();
  int tile = s_tile;
  int buf = 0;   // the ring's slot of the tile's first plane
  if (tile < tiles)
    ll_load_plane<width>(planes, x, sn, (long long)tile * P - look - khalf,
                         n, tid);

  while (tile < tiles) {
    const long long s = (long long)tile * P;    // the tile's first frame
    if (tid == 0) s_next = atomicAdd(flags + tiles, 1);
    int next_tile = tiles;

    // peak envelope of slots q0 .. q0 + 16 (slot q at frame s - look +
    // q), a channel plane at a time, the next plane (or the next tile's
    // first) loading meanwhile
    float v[kLlSeg];
#pragma unroll
    for (int r = 0; r < kLlSeg; ++r) v[r] = 0.f;
    for (int c = 0; c < C; ++c) {
      // the plane's slot in the ring, and the next plane's: two slots
      // back, read by the previous tile's or plane's last pass
      const int at = (buf + c) % kLlRing, to = (buf + c + 1) % kLlRing;
      ll_wait_planes();
      __syncthreads();   // the plane is in; the next one's slot is free
      if (c == 0) next_tile = s_next;
      const bool same = c + 1 < C;
      const int nt = same ? tile : next_tile;
      if (nt < tiles)
        ll_load_plane<width>(planes + to * width,
                             x + (same ? c + 1 : 0) * sc, sn,
                             (long long)nt * P - look - khalf, n, tid);
      // xw[k]: frame s - look - khalf + q0 + k
      const float* xw = planes + at * width + q0;
#pragma unroll
      for (int r = 0; r < kLlSeg; ++r)
        v[r] = fmaxf(v[r], fabsf(xw[r + khalf]));
      if constexpr (TP) {
#pragma unroll 1
        for (int p = 0; p < kLlPhases; ++p) {
          float h[kLlTaps];
          const float4* hp =
              reinterpret_cast<const float4*>(taps_s + p * kLlTaps);
#pragma unroll
          for (int j = 0; j < kLlTaps / 4; ++j) {
            const float4 t4 = hp[j];
            h[4 * j] = t4.x;
            h[4 * j + 1] = t4.y;
            h[4 * j + 2] = t4.z;
            h[4 * j + 3] = t4.w;
          }
          float acc[kLlSeg];
#pragma unroll
          for (int r = 0; r < kLlSeg; ++r) acc[r] = 0.f;
          // out[j, p] = sum_i h[4 i + p] x[j + 15 - i]: for slot r, x at
          // window index k = r + 31 - i, summed in the order of k
          // (cuBLAS's order over the banded operator's rows: the same
          // bits)
#pragma unroll
          for (int k = 0; k < kLlSeg + kLlTaps - 1; ++k) {
            const float xv = xw[k];
#pragma unroll
            for (int r = 0; r < kLlSeg; ++r) {
              const int i = r + kLlTaps - 1 - k;
              if (i >= 0 && i < kLlTaps) acc[r] = fmaf(h[i], xv, acc[r]);
            }
          }
#pragma unroll
          for (int r = 0; r < kLlSeg; ++r)
            v[r] = fmaxf(v[r], fabsf(acc[r]));
        }
      }
    }
    // raw gain, torch's min(1, reciprocal(max(peak, 1e-9)) * ceiling)
#pragma unroll
    for (int r = 0; r < kLlSeg; ++r)
      gbuf[q0 + r] =
          fminf(1.f, __fmul_rn(__frcp_rn(fmaxf(v[r], 1e-9f)), ceiling));
    __syncthreads();
    // past the track's ends, its first and last gains
    const long long first_q = look - s;           // slot of frame 0
    const long long last_q = n - 1 - s + look;    // slot of frame n - 1
#pragma unroll
    for (int r = 0; r < kLlSeg; ++r) {
      const int q = q0 + r;
      v[r] = gbuf[q < first_q ? first_q : (q > last_q ? last_q : q)];
    }
    __syncthreads();

    // erosion: min over slots [q, q + 2 look], the window's first part
    // in the thread's own segment (a suffix min), then whole segments (a
    // min of K or K + 1 segment minima from the segment after), then a
    // prefix of the segment it ends in; windows of up to 17 slots directly
    const int window = 2 * look + 1;
    float e[kLlSeg];
    if (window <= kLlSeg) {
#pragma unroll
      for (int r = 0; r < kLlSeg; ++r) gbuf[q0 + r] = v[r];
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kLlSeg; ++r) {
        e[r] = v[r];
        for (int j = 1; j < window; ++j) {
          const int q = q0 + r + j;
          e[r] = fminf(e[r], q < kLlSlots ? gbuf[q] : kInf);
        }
      }
    } else {
      float run = kInf;
#pragma unroll
      for (int r = 0; r < kLlSeg; ++r) {   // prefix minima to shared memory
        run = fminf(run, v[r]);
        gbuf[q0 + r] = run;
      }
      seg_min[tid] = run;
#pragma unroll
      for (int r = kLlSeg - 2; r >= 0; --r) v[r] = fminf(v[r], v[r + 1]);
      __syncthreads();
      const int K = (window - 1) / kLlSeg - 1;   // whole segments, or K + 1
      float lo = kInf;
      for (int j = 0; j < K; ++j)
        lo = fminf(lo, tid + j < kLlThreads ? seg_min[tid + j] : kInf);
      win_lo[tid] = lo;
      win_hi[tid] = fminf(lo, tid + K < kLlThreads ? seg_min[tid + K] : kInf);
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kLlSeg; ++r) {
        const int end = q0 + r + window - 1;
        const int whole = end / kLlSeg - tid - 1;
        const float mid = tid + 1 >= kLlThreads
                              ? kInf
                              : (whole == K ? win_lo : win_hi)[tid + 1];
        e[r] = fminf(fminf(v[r], mid), end < kLlSlots ? gbuf[end] : kInf);
      }
    }

    // the eroded gain att[s + q] = e at slot q: its float64 prefix sums
    // over the tile, pre[q] = sum of att below q (exact for gains of
    // float32 over a tile), by the thread's 17 then a scan of the threads
    const long long left = n - s;                   // frames left
    const int count = (int)(left < P ? left : P);   // frames of this tile
    const int last = (int)(left - 1 < kLlSlots ? left - 1 : kLlSlots - 1);
    const int mine = max(0, min(kLlSeg, count - q0));
    double run = 0.0;
#pragma unroll
    for (int r = 0; r < kLlSeg; ++r) {
      pre[q0 + r] = run;
      run += (double)e[r];
      if (q0 + r == last) s_att_last = e[r];
    }
    double incl = run;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const double o = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += o;
    }
    if (lane == 31) warp_s[warp] = incl;
    __syncthreads();
    double off = incl - run;
    for (int w = 0; w < warp; ++w) off += warp_s[w];
#pragma unroll
    for (int r = 0; r < kLlSeg; ++r) pre[q0 + r] += off;
    if (tid == kLlThreads - 1) pre[kLlSlots] = off + run;
    __syncthreads();

    // moving average over [i, i + look), the track's last value past its
    // end, for frames i = q0 .. q0 + 16 of the tile, into gbuf (free
    // since the erosion); with the release's composition from u = 0
    const double att_last = (double)s_att_last;
    double a = 0.0, f = 1.0;
#pragma unroll
    for (int r = 0; r < kLlSeg; ++r) {
      const int hi = q0 + r + look;
      double sum = pre[min(hi, last + 1)] - pre[q0 + r];
      if (hi > last + 1) sum += (double)(hi - last - 1) * att_last;
      const float t = look > 1 ? ll_mean(sum, inv_look, look) : e[r];
      gbuf[q0 + r] = t;
      if (r < mine) {
        a = fmax(1.0 - (double)t, rho * a);
        f *= rho;
      }
    }
    // the warp's inclusive scan, then the warps'
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const double ap = __shfl_up_sync(0xffffffffu, a, d);
      const double fp = __shfl_up_sync(0xffffffffu, f, d);
      if (lane >= d) ll_compose(ap, fp, a, f);
    }
    if (lane == 31) {
      warp_a[warp] = a;
      warp_f[warp] = f;
    }
    __syncthreads();
    double pa = 0.0, pf = 1.0;    // the warps before this one
    for (int w = 0; w < warp; ++w) {
      double wa = warp_a[w], wf = warp_f[w];
      ll_compose(pa, pf, wa, wf);
      pa = wa;
      pf = wf;
    }
    ll_compose(pa, pf, a, f);     // the thread's inclusive value in the tile
    // exclusive: the previous thread's inclusive value
    double ea = __shfl_up_sync(0xffffffffu, a, 1);
    double ef = __shfl_up_sync(0xffffffffu, f, 1);
    if (lane == 0) {
      ea = pa;
      ef = pf;
    }

    // the tiles' chain, by decoupled look-back: the last warp reads 32
    // predecessors a step, lane l tile k - 1 - l weighted rho_tile^l
    if (warp == kLlWarps - 1) {
      volatile int* vflags = flags;
      volatile double* vagg = vals;
      volatile double* vinc = vals + tiles;
      const double ta = __shfl_sync(0xffffffffu, a, 31);
      const double tf = __shfl_sync(0xffffffffu, f, 31);
      if (tile == 0) {
        if (lane == 0) {
          vinc[0] = ta;
          __threadfence();
          vflags[0] = 2;
          s_uin = 0.0;
        }
      } else {
        if (lane == 0) {
          vagg[tile] = ta;
          __threadfence();
          vflags[tile] = 1;
        }
        double weight = 1.0;            // rho_tile^lane
        for (int l = 0; l < lane; ++l) weight *= rho_tile;
        const double step = __shfl_sync(0xffffffffu, weight * rho_tile, 31);
        double excl = 0.0, scale = 1.0;
        for (int base = tile - 1;; base -= 32) {
          const int j = base - lane;
          int state = 2;
          double val = 0.0;
          if (j >= 0) {
            while ((state = vflags[j]) == 0) __nanosleep(32);
            __threadfence();
            val = state == 2 ? vinc[j] : vagg[j];
          }
          // tiles past the nearest inclusive value add nothing
          const unsigned done = __ballot_sync(0xffffffffu, state == 2);
          const int stop = done ? __ffs(done) - 1 : 32;
          double c = lane <= stop ? scale * weight * val : 0.0;
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            c = fmax(c, __shfl_xor_sync(0xffffffffu, c, o));
          excl = fmax(excl, c);
          scale *= step;
          // a weight under 2^-60 moves no float32 gain: 1 - u rounds to 1
          // and any later 1 - t > 0 is 2^-24 or more
          if (done || scale < 0x1p-60) break;
        }
        if (lane == 0) {
          vinc[tile] = fmax(ta, tf * excl);
          __threadfence();
          vflags[tile] = 2;
          s_uin = excl;
        }
      }
    }
    __syncthreads();
    double u = fmax(ea, ef * s_uin);    // u before the thread's first frame

    // the gains, each over its average in gbuf
#pragma unroll
    for (int r = 0; r < kLlSeg; ++r)
      if (r < mine) {
        const double t = (double)gbuf[q0 + r];
        u = fmax(1.0 - t, rho * u);
        gbuf[q0 + r] = __double2float_rn(fmin(t, 1.0 - u));
      }
    __syncthreads();

    // y = x * gain, the tile's (count, C) block of the contiguous output:
    // x from the ring for one or two channels, else read again (from the
    // L2 cache: the planes were loaded just before)
    float* yt = y + s * C;
    const float* xt = x + s * sn;
    const int xoff = look + khalf;   // a plane's index of frame s
    if (C == 2) {
      const float* x0p = planes + buf * width + xoff;
      const float* x1p = planes + (buf + 1) % kLlRing * width + xoff;
      for (int j = tid; j < 2 * count; j += kLlThreads) {
        const int i = j >> 1;
        yt[j] = __fmul_rn((j & 1) ? x1p[i] : x0p[i], gbuf[i]);
      }
    } else if (C == 1) {
      const float* x0p = planes + buf * width + xoff;
      for (int i = tid; i < count; i += kLlThreads)
        yt[i] = __fmul_rn(x0p[i], gbuf[i]);
    } else {
#pragma unroll 8
      for (int j = tid; j < C * count; j += kLlThreads) {
        const int i = j / C, c = j - i * C;
        yt[j] = __fmul_rn(__ldg(xt + i * sn + c * sc), gbuf[i]);
      }
    }
    __syncthreads();   // gbuf, pre and the flags' shared copies reused
    tile = next_tile;
    buf = (buf + C) % kLlRing;
  }
}

template <bool TP>
cudaError_t launch_lookahead_limit(const float* x, float* y, long long n,
                                   int C, long long sn, long long sc,
                                   int look, float ceiling, double rho,
                                   double rho_tile, const float* taps,
                                   int* flags, double* vals, int tiles,
                                   cudaStream_t stream) {
  auto kernel = lookahead_limit_kernel<TP>;
  const int P = kLlSlots - 3 * look;
  const size_t bytes = ll_smem_bytes(TP);
  int dev = 0, sms = 0, occ = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel,
                                                        kLlThreads, bytes);
  if (err != cudaSuccess) return err;
  // as many CTAs as the card holds at once, none without a tile
  const int resident = sms * (occ > 0 ? occ : 1);
  const int grid = tiles < resident ? tiles : resident;
  kernel<<<grid, kLlThreads, bytes, stream>>>(x, y, n, C, sn, sc, look, P,
                                              ceiling, rho, rho_tile, taps,
                                              flags, vals, tiles);
  return cudaGetLastError();
}

}  // namespace pam

// y (n, C) contiguous = x (n, C) at element strides (sn, sc) times the
// lookahead limiter's gain: look frames of look-ahead, the interpolator's
// 4 x 32 taps (`taps` on the device, h[4 i + p], phase p's tap i) when
// true_peak (else unread), the float32 ceiling, the release's rho and
// rho_tile = rho^P, P = 4352 - 3 look frames a tile.  flags: tiles + 1
// ints, all 0; vals: 2 tiles doubles.  Returns the CUDA error code of the
// launch (0 on success).
extern "C" int pam_lookahead_limit(const float* x, float* y, long long n,
                                   int C, long long sn, long long sc,
                                   int look, int true_peak, float ceiling,
                                   double rho, double rho_tile,
                                   const float* taps, int* flags,
                                   double* vals, int tiles, void* stream) {
  if (n < 1 || C < 1 || look < 1 ||
      look > pam::kLlMaxLook ||
      (long long)tiles * (pam::kLlSlots - 3 * look) < n ||
      (long long)(tiles - 1) * (pam::kLlSlots - 3 * look) >= n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (true_peak)
    return (int)pam::launch_lookahead_limit<true>(x, y, n, C, sn, sc, look,
                                                  ceiling, rho, rho_tile,
                                                  taps, flags, vals, tiles, s);
  return (int)pam::launch_lookahead_limit<false>(x, y, n, C, sn, sc, look,
                                                 ceiling, rho, rho_tile,
                                                 taps, flags, vals, tiles, s);
}
