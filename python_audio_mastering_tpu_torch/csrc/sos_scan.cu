// K8: the exact direct-form II transposed recurrence of SOS cascades, in
// float32 and float64.  Its Python side is ops/sos_scan.py.
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
// operations on the same values, so the two agree bit for bit, and so
// does any schedule of (section, sample) steps that keeps each section's
// samples in order.
//
// What bounds it on the H100: latency, not bandwidth.  A section carries
// four dependent operations from z0(t) to z0(t+1) (the y add, the a1*y
// product, the subtraction, the z1 add), 16 cycles in float32, so one
// section walks a sample in ~8 ns at 1.98 GHz; a 180 s stereo column is
// 7.94 M samples.  Its bytes (the column read once, the output written
// once) take 0.04 ms at 3.35 TB/s.  The design keeps every section on its
// own chain and the chains busy:
//
// - One CTA a column (F*R CTAs).  Warp j < k is section j's walker: its
//   lane 0 runs that one section over the column, tile by tile, with no
//   section loop, no runtime section guard and no global address.
// - Section j-1's output reaches walker j through a ring of tiles in
//   shared memory, each slot with a full and an empty mbarrier, so
//   section j walks tile i while section j-1 walks tile i+1: the sections
//   overlap and the time no longer grows with their count.
// - Warp kmax is the producer: its lane 0 keeps cp.async.bulk copies of
//   x's tiles in flight into ring 0.  Warp kmax+1 is the drainer: its
//   lane 0 copies the last ring to y (and, with ysec, every section's
//   ring to ysec) by bulk shared->global copies, releasing a slot once
//   its copy has been read (cp.async.bulk.wait_group.read).
// - Bulk copies need 16-byte aligned addresses and sizes, and a column
//   starts anywhere (row r at r*N elements).  A ring's slot holds a tile
//   at the same offset from a 16-byte boundary as its column in global
//   memory, so the aligned middle of every tile goes by one bulk copy and
//   the few samples around it (fewer than 16 bytes at each end) by plain
//   loads and stores of the producer or drainer thread.
// - The walk is split at the column's valid length (the final state is
//   taken there) and at its last partial tile; every other tile runs a
//   straight-line loop of a compile-time length.
//
// Layout: x is (R, N), R columns of N contiguous samples (the rows form
// (C, T, nb, L) read in place: each (channel, track) is one run of nb*L
// samples).  F cascades run in one launch over the same x, column c =
// f*R + r, output y (F, R, N).  sos is (F, kmax, 6), nsec (F,) the
// sections of each (1 to kmax), zi and zf (F, kmax, 2, R) in scipy's
// (K, 2, C) layout per filter, n_valid (R,) the samples of each column
// before its padding: zf is the state after n_valid samples, and the
// output runs on over the whole column.  ysec, when not null (one
// cascade, F = 1, nsec[0] = kmax, y null), receives every section's
// output, (kmax, R, N), the last being the cascade's output: the gradient
// (ops/sos_scan.py) needs the signals between the sections.

#include <cuda_runtime.h>

#include <cstdint>

namespace pam {

constexpr int kTileBytes = 4096;  // one ring slot's tile
constexpr int kDepth = 4;         // slots a ring
constexpr int kAlign = 16;        // bulk copies: addresses and sizes
constexpr int kChunk = 32;        // samples a walker loads ahead
constexpr int kMaxSections = 8;

template <typename T>
struct ScanOps;

template <>
struct ScanOps<float> {
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

__device__ __forceinline__ float& lane_of(float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The ring geometry of element type T: a tile of kTile samples, held in
// a slot of kSlot elements (the tile shifted by up to kVec - 1 to match
// its column's offset from a 16-byte boundary).
template <typename T>
struct Ring {
  static constexpr int kTile = kTileBytes / sizeof(T);
  static constexpr int kVec = kAlign / sizeof(T);
  static constexpr int kSlot = kTile + kVec;
};

// The dynamic shared memory of a launch: kmax + 1 rings of kDepth slots,
// then a full and an empty mbarrier a slot (ops/sos_scan.py's
// launch_plan computes the same bytes).
template <typename T>
constexpr int smem_bytes(int kmax) {
  return (kmax + 1) * kDepth * Ring<T>::kSlot * (int)sizeof(T) +
         2 * (kmax + 1) * kDepth * 8;
}

// --- shared-memory barriers and bulk copies (PTX) -------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"((uint64_t)src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
          (uint64_t)dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Every bulk store group but the newest has read its shared memory.
__device__ __forceinline__ void bulk_wait_read_all_but_one() {
  asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// This thread's shared-memory writes, seen by later bulk copies.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// --- the split of a tile around its 16-byte aligned middle ----------------

// Tile [t0, t1) of a column whose sample 0 lies `phase` elements past a
// 16-byte boundary (t0 a multiple of kVec): its aligned middle [a, b) goes
// by one bulk copy, [t0, a) and [b, t1) by plain loads and stores; a == b
// == t1 when the tile holds no aligned 16 bytes (ops/sos_scan.py's
// _tile_split is the same arithmetic).
template <typename T>
struct Split {
  long long a, b;
  __device__ __forceinline__ Split(long long t0, long long t1, int phase) {
    constexpr int V = Ring<T>::kVec;
    a = t0 + (V - phase) % V;
    b = t1 - (phase + t1) % V;
    if (b <= a) a = b = t1;
  }
};

// --- a section's walk over one tile ----------------------------------------

template <typename T>
struct Section {
  T b0, b1, b2, a1, a2, z0, z1;

  __device__ __forceinline__ T step(T x) {
    using Op = ScanOps<T>;
    const T y = Op::add(Op::mul(b0, x), z0);
    z0 = Op::add(Op::sub(Op::mul(b1, x), Op::mul(a1, y)), z1);
    z1 = Op::sub(Op::mul(b2, x), Op::mul(a2, y));
    return y;
  }

  // Samples [0, chunks * kChunk) of a tile, each sample's input loaded a
  // chunk ahead.  Each step's load and store sit between its arithmetic
  // (in and out may alias as far as the compiler knows, so it keeps this
  // order): they fill the dependent chain's idle cycles instead of
  // bursts of their own.
  __device__ __forceinline__ void walk_chunks(const T* in, T* out,
                                              int chunks) {
    if (chunks <= 0) return;
    T cur[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) cur[i] = in[i];
#pragma unroll 1
    for (int c = 1; c < chunks; ++c) {
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const T v = cur[i];
        cur[i] = in[c * kChunk + i];
        out[(c - 1) * kChunk + i] = step(v);
      }
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i)
      out[(chunks - 1) * kChunk + i] = step(cur[i]);
  }

  // The same in float32 over 16-byte aligned in and out, four samples a
  // load and store: a quarter of the shared-memory instructions, whose
  // slots at the scheduler a second walker on it (k > 4) needs.
  // (Float64 in pairs measured slower than one at a time on the H100, so
  // it keeps walk_chunks.)
  __device__ __forceinline__ void walk_chunks_packed(const float* in,
                                                     float* out, int chunks) {
    using V = float4;
    constexpr int kPer = 4;
    constexpr int kPacks = kChunk / kPer;
    const V* vin = reinterpret_cast<const V*>(in);
    V* vout = reinterpret_cast<V*>(out);
    V cur[kPacks];
#pragma unroll
    for (int m = 0; m < kPacks; ++m) cur[m] = vin[m];
#pragma unroll 1
    for (int c = 1; c < chunks; ++c) {
#pragma unroll
      for (int m = 0; m < kPacks; ++m) {
        V v = cur[m];
        cur[m] = vin[c * kPacks + m];
#pragma unroll
        for (int e = 0; e < kPer; ++e) lane_of(v, e) = step(lane_of(v, e));
        vout[(c - 1) * kPacks + m] = v;
      }
    }
#pragma unroll
    for (int m = 0; m < kPacks; ++m) {
      V v = cur[m];
#pragma unroll
      for (int e = 0; e < kPer; ++e) lane_of(v, e) = step(lane_of(v, e));
      vout[(chunks - 1) * kPacks + m] = v;
    }
  }

  // Samples [from, to) of a tile, at a runtime length.
  __device__ __forceinline__ void walk(const T* in, T* out, int from,
                                       int to) {
    const int chunks = (to - from) / kChunk;
    walk_chunks(in + from, out + from, chunks);
#pragma unroll 1
    for (int u = from + chunks * kChunk; u < to; ++u) out[u] = step(in[u]);
  }
};

// --- the kernel ------------------------------------------------------------

template <typename T, bool kRecord>
__global__ void __launch_bounds__((kMaxSections + 2) * 32)
    sos_scan_kernel(const T* __restrict__ x, const T* __restrict__ sos,
                    const int* __restrict__ nsec, const T* __restrict__ zi,
                    const long long* __restrict__ n_valid, T* __restrict__ y,
                    T* __restrict__ zf, T* __restrict__ ysec, int R,
                    long long N, int kmax) {
  constexpr int kTile = Ring<T>::kTile;
  constexpr int kSlot = Ring<T>::kSlot;
  extern __shared__ __align__(16) unsigned char smem[];

  const int col = blockIdx.x;
  const int f = col / R, r = col % R;
  const int k = nsec[f];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles = (int)((N + kTile - 1) / kTile);

  T* rings = reinterpret_cast<T*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + (size_t)(kmax + 1) * kDepth * kSlot * sizeof(T));
  uint64_t* empty = full + (kmax + 1) * kDepth;

  // ring q's column in global memory: x for q = 0; then section q-1's
  // output, drained to ysec row (q-1, r) or, for the last, to y
  auto column = [&](int q) -> T* {
    if (q == 0) return const_cast<T*>(x) + (long long)r * N;
    if (kRecord) return ysec + ((long long)(q - 1) * R + r) * N;
    return q == k ? y + (long long)col * N : nullptr;
  };
  auto phase = [&](int q) -> int {
    const T* c = column(q);
    return c == nullptr ? 0 : (int)(((uintptr_t)c % kAlign) / sizeof(T));
  };
  auto drained = [&](int q) { return q >= 1 && (kRecord || q == k); };
  auto slot = [&](int q, int i) {
    return rings + ((size_t)q * kDepth + (i % kDepth)) * kSlot;
  };

  if (threadIdx.x == 0) {
    for (int q = 0; q <= k; ++q)
      for (int s = 0; s < kDepth; ++s) {
        mbar_init(&full[q * kDepth + s], 1);
        mbar_init(&empty[q * kDepth + s], (q < k) + drained(q));
      }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (lane != 0) return;

  if (warp < k) {
    // walker: section `warp` from ring `warp` to ring `warp + 1`
    const int j = warp;
    const T* c = sos + ((long long)f * kmax + j) * 6;
    const long long zo = (((long long)f * kmax + j) * 2) * R + r;
    Section<T> sec{c[0], c[1], c[2], c[4], c[5], zi[zo], zi[zo + R]};
    T s0 = sec.z0, s1 = sec.z1;
    const long long nv = n_valid[r];
    const int p_in = phase(j), p_out = phase(j + 1);
    const bool out_drained = drained(j + 1);
    // the slots' tiles start on 16-byte boundaries (every column aligned,
    // as the chain's rows are): whole float32 tiles go four samples a load
    // and store
    const bool packed = p_in == 0 && p_out == 0;
    uint64_t* full_in = &full[j * kDepth];
    uint64_t* empty_in = &empty[j * kDepth];
    uint64_t* full_out = &full[(j + 1) * kDepth];
    uint64_t* empty_out = &empty[(j + 1) * kDepth];
    for (int i = 0; i < tiles; ++i) {
      const int s = i % kDepth;
      const uint32_t round = i / kDepth;
      mbar_wait(&full_in[s], round & 1);
      if (round > 0) mbar_wait(&empty_out[s], (round - 1) & 1);
      const T* in = slot(j, i) + p_in;
      T* out = slot(j + 1, i) + p_out;
      const long long t0 = (long long)i * kTile;
      const int n = (int)(N - t0 < kTile ? N - t0 : kTile);
      if (n == kTile && (nv <= t0 || nv > t0 + kTile)) {
        if constexpr (sizeof(T) == 4) {
          if (packed) {
            sec.walk_chunks_packed(in, out, kTile / kChunk);
          } else {
            sec.walk_chunks(in, out, kTile / kChunk);
          }
        } else {
          sec.walk_chunks(in, out, kTile / kChunk);
        }
      } else {
        // the tile that holds the valid length, or the last partial one
        const long long cut = nv - t0;
        const int m = cut > 0 && cut <= n ? (int)cut : n;
        sec.walk(in, out, 0, m);
        if (cut > 0 && cut <= n) {
          s0 = sec.z0;
          s1 = sec.z1;
        }
        sec.walk(in, out, m, n);
      }
      if (out_drained) fence_proxy_async();
      mbar_arrive(&full_out[s]);
      mbar_arrive(&empty_in[s]);
    }
    zf[zo] = s0;
    zf[zo + R] = s1;
  } else if (warp == kmax) {
    // producer: x's tiles into ring 0
    const T* xc = column(0);
    const int p = phase(0);
    for (int i = 0; i < tiles; ++i) {
      const int s = i % kDepth;
      const uint32_t round = i / kDepth;
      if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);
      T* dst = slot(0, i) + p;
      const long long t0 = (long long)i * kTile;
      const long long t1 = N - t0 < kTile ? N : t0 + kTile;
      const Split<T> sp(t0, t1, p);
      for (long long t = t0; t < sp.a; ++t) dst[t - t0] = xc[t];
      for (long long t = sp.b; t < t1; ++t) dst[t - t0] = xc[t];
      const uint32_t bytes = (uint32_t)((sp.b - sp.a) * sizeof(T));
      if (bytes > 0) {
        mbar_arrive_tx(&full[s], bytes);
        bulk_load(dst + (sp.a - t0), xc + sp.a, bytes, &full[s]);
      } else {
        mbar_arrive(&full[s]);
      }
    }
  } else if (warp == kmax + 1) {
    // drainer: the drained rings to their columns, tile by tile
    const int q0 = kRecord ? 1 : k;
    for (int i = 0; i < tiles; ++i) {
      const int s = i % kDepth;
      const uint32_t round = i / kDepth;
      const long long t0 = (long long)i * kTile;
      const long long t1 = N - t0 < kTile ? N : t0 + kTile;
      for (int q = q0; q <= k; ++q) {
        mbar_wait(&full[q * kDepth + s], round & 1);
        T* dst = column(q);
        const int p = phase(q);
        const T* src = slot(q, i) + p;
        const Split<T> sp(t0, t1, p);
        for (long long t = t0; t < sp.a; ++t) dst[t] = src[t - t0];
        for (long long t = sp.b; t < t1; ++t) dst[t] = src[t - t0];
        if (sp.b > sp.a)
          bulk_store(dst + sp.a, src + (sp.a - t0),
                     (uint32_t)((sp.b - sp.a) * sizeof(T)));
      }
      bulk_commit();
      if (i > 0) {
        // tile i - 1's copies have read their slots: release them
        bulk_wait_read_all_but_one();
        for (int q = q0; q <= k; ++q)
          mbar_arrive(&empty[q * kDepth + (i - 1) % kDepth]);
      }
    }
    bulk_wait_all();
  }
}

template <typename T>
int launch_sos_scan(const T* x, const T* sos, const int* nsec, const T* zi,
                    const long long* n_valid, T* y, T* zf, T* ysec, int F,
                    int R, long long N, int kmax, int smem, void* stream) {
  if (F < 1 || R < 1 || N < 1 || (long long)F * R > 0x7fffffffLL ||
      kmax < 1 || kmax > kMaxSections || smem != smem_bytes<T>(kmax) ||
      (ysec != nullptr) == (y != nullptr) ||
      (ysec != nullptr && F != 1))
    return (int)cudaErrorInvalidValue;
  auto kernel = ysec != nullptr ? &sos_scan_kernel<T, true>
                                : &sos_scan_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<F * R, (kmax + 2) * 32, smem, (cudaStream_t)stream>>>(
      x, sos, nsec, zi, n_valid, y, zf, ysec, R, N, kmax);
  return (int)cudaGetLastError();
}

}  // namespace pam

// y (F, R, N) and zf (F, kmax, 2, R) from x (R, N); 1 <= nsec[f] <= kmax
// <= 8 (see the layout above); ysec null, or (kmax, R, N) with F = 1 and
// y null; smem the launch's dynamic shared memory (its only valid value
// is pam::smem_bytes<T>(kmax), ops/sos_scan.py's launch_plan).
extern "C" int pam_sos_scan_f32(const float* x, const float* sos,
                                const int* nsec, const float* zi,
                                const long long* n_valid, float* y, float* zf,
                                float* ysec, int F, int R, long long N,
                                int kmax, int smem, void* stream) {
  return pam::launch_sos_scan<float>(x, sos, nsec, zi, n_valid, y, zf, ysec,
                                     F, R, N, kmax, smem, stream);
}

extern "C" int pam_sos_scan_f64(const double* x, const double* sos,
                                const int* nsec, const double* zi,
                                const long long* n_valid, double* y,
                                double* zf, double* ysec, int F, int R,
                                long long N, int kmax, int smem,
                                void* stream) {
  return pam::launch_sos_scan<double>(x, sos, nsec, zi, n_valid, y, zf, ysec,
                                      F, R, N, kmax, smem, stream);
}
