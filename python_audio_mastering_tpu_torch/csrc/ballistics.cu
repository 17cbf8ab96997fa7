// The exact compressor ballistics: kernels over a band-major (B, T)
// control timeline cut into blocks of kBalBlock = 128 steps, all running
// the one step of ballistics.cuh.  The driver is ops/ballistics.py.
//
// Replace the TPU kernels of python_audio_mastering_tpu/ops/pallas_kernels.py:
//
//   pam_pass1_hull +  <- _pass1_bnd / _bnd_kernel: each block's outgoing
//   pam_pass1_runs       attenuation, as the serial walk of the whole
//                        timeline gives it (two launches, see below).
//   pam_replay        <- _replay / _replay_kernel: every block replayed from
//                        its exact incoming state, per-step attenuation out.
//   pam_replay_bnd    <- _replay_bnd / _replay_bnd_kernel: up to `rounds`
//                        rounds of the block-boundary fixed point (outgoing
//                        states only) in one cooperative launch, where the
//                        TPU loop (_run_collapse's lax.while_loop) runs one
//                        kernel a round.
//
// What bounds them on the H100: a dependent chain of ~4 float ops per
// step, never bandwidth (the timeline is 12 MB for a 3-min track).  The
// replay and the hull pass are 128-step chains, one thread per (band,
// block); a CTA of 64
// threads stages its 64 blocks (contiguous in the timeline) through shared
// memory, so the loads and stores are coalesced and each thread walks its
// own padded row of the tile without bank conflicts.  The TPU's 8-sublane
// / 128-lane padding, T padded to 128^2 and the time-major block
// transposes are not carried over: the timeline is read in place, padded
// only to whole blocks.
//
// The boundary walk (K5) is a segmented exact walk.  A serial walk is a
// chain of T dependent steps, milliseconds for a 3-min track; but most of
// that chain is not needed, because a block often forgets its incoming
// state: a clamp saturates (attack reaches m, release reaches 0) and every
// incoming state leaves the block in one same state.
//
//   (a) pam_pass1_hull, one thread per (band, block), laid out like the
//       replays: it walks the block's 128 steps on an interval [lo, hi] of
//       possible incoming states, starting from [0, H], H = max(att0,
//       max m) over the band (sound: attack gives <= m, release <= att,
//       and no step gives < 0).  The step f(att) = att <= m ? min(att +
//       m*ca, m) : max(att - m*cr, 0) is monotone non-decreasing on each
//       side of its branch point: round-to-nearest addition and
//       subtraction of a fixed operand, min and max with a fixed operand
//       are all monotone.  So f maps [lo, min(hi, m)] into [f(lo), f(min(hi,
//       m))] and [max(lo, m+), hi] into [f(max(lo, m+)), f(hi)] (m+ the
//       next float above m: the release branch takes att > m), and the
//       hull of the two holds every image (ballistics_hull_step).  A block
//       whose interval ends with lo == hi has collapsed: its outgoing state
//       is that float whatever comes in.  With m and att0 free of -0.0
//       (ballistics_rates_bt adds +0.0 to them) no state is ever -0.0, so
//       equal values are equal bits.
//   (b) pam_pass1_runs, one warp per (band, block): a collapsed block
//       writes its constant; a warp whose block starts a maximal run of
//       non-collapsed blocks walks the run serially with ballistics_step,
//       from the exact outgoing state of the collapsed block before it (or
//       att0 for block 0), writing every boundary of the run; every other
//       warp exits at once.  In the walk the 32 lanes load the next 128
//       steps coalesced while the current 128 are walked, every lane
//       walking the same values received by shuffles.  Runs go in
//       parallel, so the serial part is the longest run, not T.
//
// The result is bitwise the serial walk's: collapsed constants are exact
// by the argument above, and every run is walked from an exact state with
// the same arithmetic.  Worst case, no block collapses: one run of the
// whole timeline, a serial walk of all T steps plus the hull pass (about
// one K7 round).
//
// The fixed point (K7) runs every round in one launch.  A round is cheap
// (128 dependent steps a block, ~12 MB of targets for a 3-min track) and
// the rounds depend on each other only through the outgoing states, so
// one launch a round spent most of its time launching, and re-read every
// target from device memory each round.  Here a cooperative grid, sized to
// be resident (occupancy x SMs), holds the rounds:
//
//   - each CTA owns a contiguous range of the B * T/128 blocks, one thread
//     a block; where the whole timeline fits in the grid's shared memory
//     (~59 000 blocks on an H100: a one-shot track up to ~7 minutes at hop
//     8), each CTA stages its blocks' targets once, 16-byte loads into
//     padded rows, and every round walks them from there; a longer
//     timeline is staged again each round, kFixThreads blocks at a time
//     (on an H100 the 3-min track's fixed point takes 0.025 ms staged
//     once and 0.037 ms staged every round, though its 12 MB sit in L2);
//   - a round reads a block's incoming state from the outgoing states of
//     the round before (gathered through idx_ex, so from other CTAs'
//     blocks: two global buffers, ping-pong, read past L1) and counts its
//     changed boundaries into ctrl, in one counter for even rounds and one
//     for odd ones, totals that only grow inside the launch;
//   - after a grid barrier every thread reads the round's total, less the
//     total it saw two rounds before, and applies the loop's stopping rule
//     itself, so every CTA leaves the loop after the same round.  The
//     counter of round r is added to again only in round r + 2, after the
//     barrier that every thread reaches once it has read it.
//
// Its bound is reading the targets once and 16 bytes a block a round (the
// income index and the state in, the state out); what sets its time is
// each round's 128 dependent steps and the grid barrier after them.
//
// `ctrl` is an int32 record (kCtrl* below) that ops/ballistics.py never
// reads back: a launch on a stopped loop copies its input through, and the two
// K5 launches, given `ctrl`, run only when the fixed point did not
// certify.  When the loop stops, ctrl holds what that many one-round
// launches leave: active, the last two counts and the rounds run, its
// two counters back at 0.
#include <algorithm>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "ballistics.cuh"

namespace pam {

constexpr int kCtrlActive = 0;   // 1 while the fixed point iterates
constexpr int kCtrlCnt = 1;      // boundaries changed by the last round
constexpr int kCtrlCntPrev = 2;  // ... by the round before it
constexpr int kCtrlRound = 3;    // rounds run
constexpr int kCtrlChanged = 4;  // changed boundaries, even rounds, and
                                 // odd ones at 5: totals of one launch
                                 // (scratch, 0 between launches)
constexpr int kStallGrace = 4;   // rounds before the stall rule may stop

constexpr int kReplayRows = 64;            // blocks (= threads) per CTA
constexpr int kTileStride = kBalBlock + 1;  // padded: conflict-free walks

// Stage the CTA's blocks blk0 .. blk0 + rows - 1 of band b into the tile.
__device__ __forceinline__ void load_tile(const float* __restrict__ row,
                                          int blk0, int rows, float* tile) {
  const float* src = row + (size_t)blk0 * kBalBlock;
  for (int e = threadIdx.x; e < rows * kBalBlock; e += kReplayRows)
    tile[(e / kBalBlock) * kTileStride + e % kBalBlock] = src[e];
  __syncthreads();
}

__global__ void __launch_bounds__(kReplayRows)
pass1_hull_kernel(const float* __restrict__ m, const float* __restrict__ ca,
                  const float* __restrict__ cr,
                  const float* __restrict__ hmax, float* __restrict__ lo_out,
                  float* __restrict__ hi_out, const int* __restrict__ ctrl,
                  int T) {
  if (ctrl != nullptr && ctrl[kCtrlCnt] == 0) return;  // certified
  __shared__ float tile[kReplayRows * kTileStride];
  const int b = blockIdx.y;
  const int nblk = T / kBalBlock;
  const int blk0 = blockIdx.x * kReplayRows;
  const int rows = min(kReplayRows, nblk - blk0);
  load_tile(m + (size_t)b * T, blk0, rows, tile);
  const int t = threadIdx.x;
  if (t < rows) {
    const float a = ca[b];
    const float r = cr[b];
    float lo = 0.f;
    float hi = hmax[b];
    const float* v = tile + t * kTileStride;
#pragma unroll 8
    for (int j = 0; j < kBalBlock; ++j)
      ballistics_hull_step(lo, hi, v[j], a, r);
    const size_t at = (size_t)b * nblk + blk0 + t;
    lo_out[at] = lo;
    hi_out[at] = hi;
  }
}

// warps (one per block of the timeline) a CTA: few large CTAs, so that
// the warps holding a run are launched early
constexpr int kRunWarps = 32;

__global__ void __launch_bounds__(32 * kRunWarps)
pass1_runs_kernel(const float* __restrict__ m, const float* __restrict__ ca,
                  const float* __restrict__ cr,
                  const float* __restrict__ att0,
                  const float* __restrict__ lo, const float* __restrict__ hi,
                  float* __restrict__ bnd, const int* __restrict__ ctrl,
                  int T) {
  if (ctrl != nullptr && ctrl[kCtrlCnt] == 0) return;  // certified
  const int b = blockIdx.y;
  const int nblk = T / kBalBlock;
  const int k = blockIdx.x * kRunWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (k >= nblk) return;
  const float* l = lo + (size_t)b * nblk;
  const float* h = hi + (size_t)b * nblk;
  float* out = bnd + (size_t)b * nblk;
  if (l[k] == h[k]) {  // collapsed: the constant, whatever comes in
    if (lane == 0) out[k] = l[k];
    return;
  }
  if (k > 0 && l[k - 1] != h[k - 1]) return;  // inside a run: not its start
  const float a = ca[b];
  const float r = cr[b];
  float att = k == 0 ? att0[b] : l[k - 1];
  const float* row = m + (size_t)b * T;
  float cur[4], nxt[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    cur[i] = row[(size_t)k * kBalBlock + i * 32 + lane];
  for (int j = k;; ++j) {
    // the next block's steps and hull are read before this block's walk
    // (read even when the run ends there), so their latency hides in it
    const bool last = j + 1 >= nblk;
    const float next_lo = last ? 0.f : l[j + 1];
    const float next_hi = last ? 0.f : h[j + 1];
    if (!last) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        nxt[i] = row[(size_t)(j + 1) * kBalBlock + i * 32 + lane];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 32; ++jj)
        att = ballistics_step(att, __shfl_sync(0xffffffffu, cur[i], jj), a, r);
    if (lane == 0) out[j] = att;
    if (last || next_lo == next_hi) break;  // the run ends here
#pragma unroll
    for (int i = 0; i < 4; ++i) cur[i] = nxt[i];
  }
}

__global__ void __launch_bounds__(kReplayRows)
replay_kernel(const float* __restrict__ m, const float* __restrict__ ca,
              const float* __restrict__ cr,
              const float* __restrict__ incomes, float* __restrict__ out,
              int T) {
  __shared__ float tile[kReplayRows * kTileStride];
  const int b = blockIdx.y;
  const int nblk = T / kBalBlock;
  const int blk0 = blockIdx.x * kReplayRows;
  const int rows = min(kReplayRows, nblk - blk0);
  load_tile(m + (size_t)b * T, blk0, rows, tile);
  const int t = threadIdx.x;
  if (t < rows) {
    const float a = ca[b];
    const float r = cr[b];
    float att = incomes[(size_t)b * nblk + blk0 + t];
    float* v = tile + t * kTileStride;
#pragma unroll 8
    for (int j = 0; j < kBalBlock; ++j) {
      att = ballistics_step(att, v[j], a, r);
      v[j] = att;
    }
  }
  __syncthreads();
  float* dst = out + (size_t)b * T + (size_t)blk0 * kBalBlock;
  for (int e = threadIdx.x; e < rows * kBalBlock; e += kReplayRows)
    dst[e] = tile[(e / kBalBlock) * kTileStride + e % kBalBlock];
}

constexpr int kFixThreads = 128;  // threads (blocks walked at once) a CTA

// Stage the timeline's blocks g .. g + n - 1 (contiguous in m, band-major)
// into padded rows of `tile`: 16-byte loads, 32 threads a block.
__device__ __forceinline__ void stage_blocks(const float* __restrict__ m,
                                             size_t g, int n, float* tile) {
  const float4* src = reinterpret_cast<const float4*>(m + g * kBalBlock);
  for (int e = threadIdx.x; e < n * (kBalBlock / 4); e += kFixThreads) {
    const float4 v = src[e];
    float* d = tile + (e / (kBalBlock / 4)) * kTileStride +
               4 * (e % (kBalBlock / 4));
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
}

// Up to `rounds` fixed-point rounds (see the note above).  CTA i owns the
// blocks i * per .. i * per + per - 1 of the n_total = B * nblk; `tile`
// holds `per` rows when `resident`, else kFixThreads.  s_new and s_alt
// are the ping-pong buffers; the result ends in s_new.
__global__ void __launch_bounds__(kFixThreads)
replay_bnd_kernel(const float* __restrict__ m, const float* __restrict__ ca,
                  const float* __restrict__ cr,
                  const float* __restrict__ att0,
                  const long long* __restrict__ idx_ex, const float* s_out,
                  float* s_new, float* s_alt, int* ctrl, int nblk,
                  int n_total, int per, int resident, int iters,
                  int rounds) {
  extern __shared__ float4 tile4[];
  float* tile = reinterpret_cast<float*>(tile4);
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int tid = threadIdx.x;
  const int g0 = blockIdx.x * per;
  const int n_own = max(0, min(per, n_total - g0));
  const int chunk = resident ? per : kFixThreads;
  // the loop's state, the same in every thread: block 0 writes these
  // fields only after the last barrier.  The two counters are 0 on entry
  // (every launch leaves them so) and are never read here: other CTAs may
  // already be adding to them in round 0
  int active = ctrl[kCtrlActive];
  int cnt = ctrl[kCtrlCnt];
  int prev = ctrl[kCtrlCntPrev];
  int k = ctrl[kCtrlRound];
  int seen_even = 0;  // counter totals read so far
  int seen_odd = 0;
  if (resident && active) {
    stage_blocks(m, g0, n_own, tile);
    __syncthreads();
  }
  int ran = 0;
  for (; ran < rounds && active; ++ran) {
    const float* cur = ran == 0 ? s_out : ((ran - 1) & 1 ? s_alt : s_new);
    float* nxt = ran & 1 ? s_alt : s_new;
    int n_changed = 0;
    for (int c0 = 0; c0 < n_own; c0 += chunk) {
      const int nc = min(chunk, n_own - c0);
      if (!resident) {
        __syncthreads();  // the walks of the chunk before are done
        stage_blocks(m, (size_t)g0 + c0, nc, tile);
        __syncthreads();
      }
      for (int i0 = 0; i0 < nc; i0 += kFixThreads) {
        const int i = i0 + tid;
        bool changed = false;
        if (i < nc) {
          const int g = g0 + c0 + i;
          const int b = g / nblk;
          // incoming state: the outgoing state of the last non-frozen
          // block before this one (frozen blocks, m == 0 throughout, are
          // identities), written by any CTA in the round before
          const long long src = idx_ex[g];
          float att = src == 0 ? att0[b]
                               : __ldcg(cur + (size_t)b * nblk + src - 1);
          const float a = ca[b];
          const float r = cr[b];
          const float* v = tile + i * kTileStride;
#pragma unroll 8
          for (int j = 0; j < kBalBlock; ++j)
            att = ballistics_step(att, v[j], a, r);
          nxt[g] = att;
          changed = att != __ldcg(cur + g);
        }
        n_changed += __syncthreads_count(changed);
      }
    }
    int* counter = ctrl + kCtrlChanged + (ran & 1);
    if (tid == 0 && n_changed) atomicAdd(counter, n_changed);
    grid.sync();
    // the stopping rule of the one-round loop, in every thread
    const int total = __ldcg(counter);
    prev = cnt;
    if (ran & 1) {
      cnt = total - seen_odd;
      seen_odd = total;
    } else {
      cnt = total - seen_even;
      seen_even = total;
    }
    ++k;
    active = cnt != 0 && k < iters &&
             (k <= kStallGrace || 4LL * cnt < 3LL * (long long)prev);
  }
  // the result into s_new, each CTA its own blocks, by the threads that
  // wrote them: the input when no round ran, s_alt after an even count
  if (ran == 0 || (ran & 1) == 0) {
    const float* src = ran == 0 ? s_out : s_alt;
    for (int i = tid; i < n_own; i += kFixThreads)
      s_new[g0 + i] = __ldcg(src + g0 + i);
  }
  if (ran > 0) {
    grid.sync();  // every thread has read the counters
    if (blockIdx.x == 0 && tid == 0) {
      ctrl[kCtrlActive] = active;
      ctrl[kCtrlCnt] = cnt;
      ctrl[kCtrlCntPrev] = prev;
      ctrl[kCtrlRound] = k;
      ctrl[kCtrlChanged] = 0;
      ctrl[kCtrlChanged + 1] = 0;
    }
  }
}

}  // namespace pam

namespace {

bool bad_shape(int B, int T) {
  return B < 1 || B > 65535 || T < pam::kBalBlock || T % pam::kBalBlock != 0;
}

dim3 replay_grid(int B, int T) {
  const int nblk = T / pam::kBalBlock;
  return dim3((nblk + pam::kReplayRows - 1) / pam::kReplayRows, B);
}

}  // namespace

// lo, hi (B, T / 128): each block's hull of outgoing states, from [0,
// hmax[b]] coming in.  With ctrl not null it runs only when ctrl's last
// round count is not 0.  Returns the CUDA error code of the launch (0 on
// success).
extern "C" int pam_pass1_hull(const float* m, const float* ca, const float* cr,
                              const float* hmax, float* lo, float* hi,
                              const int* ctrl, int B, int T, void* stream) {
  if (bad_shape(B, T)) return (int)cudaErrorInvalidValue;
  pam::pass1_hull_kernel<<<replay_grid(B, T), pam::kReplayRows, 0,
                           (cudaStream_t)stream>>>(m, ca, cr, hmax, lo, hi,
                                                   ctrl, T);
  return (int)cudaGetLastError();
}

// bnd (B, T / 128): each block's outgoing attenuation, from the hulls of
// pam_pass1_hull.  Gated on ctrl as above.
extern "C" int pam_pass1_runs(const float* m, const float* ca, const float* cr,
                              const float* att0, const float* lo,
                              const float* hi, float* bnd, const int* ctrl,
                              int B, int T, void* stream) {
  if (bad_shape(B, T)) return (int)cudaErrorInvalidValue;
  const int nblk = T / pam::kBalBlock;
  const dim3 grid((nblk + pam::kRunWarps - 1) / pam::kRunWarps, B);
  pam::pass1_runs_kernel<<<grid, 32 * pam::kRunWarps, 0,
                           (cudaStream_t)stream>>>(m, ca, cr, att0, lo, hi,
                                                   bnd, ctrl, T);
  return (int)cudaGetLastError();
}

// out (B, T): per-step attenuation, block k starting from incomes[:, k].
extern "C" int pam_replay(const float* m, const float* ca, const float* cr,
                          const float* incomes, float* out, int B, int T,
                          void* stream) {
  if (bad_shape(B, T)) return (int)cudaErrorInvalidValue;
  pam::replay_kernel<<<replay_grid(B, T), pam::kReplayRows, 0,
                       (cudaStream_t)stream>>>(m, ca, cr, incomes, out, T);
  return (int)cudaGetLastError();
}

// Up to `rounds` fixed-point rounds in one cooperative launch: s_new (B,
// T / 128) from s_out, and ctrl updated (see above).  s_alt (B, T / 128)
// is scratch, needed when rounds > 1.  m must be 16-byte aligned.  The
// grid is as many CTAs as the card holds at once (it must be resident for
// the grid barrier), at most one a block.
extern "C" int pam_replay_bnd(const float* m, const float* ca, const float* cr,
                              const float* att0, const long long* idx_ex,
                              const float* s_out, float* s_new, float* s_alt,
                              int* ctrl, int B, int T, int iters, int rounds,
                              void* stream) {
  if (bad_shape(B, T) || iters < 1 || rounds < 1 ||
      (rounds > 1 && s_alt == nullptr) ||
      (long long)B * (T / pam::kBalBlock) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  int nblk = T / pam::kBalBlock;
  int n_total = B * nblk;
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  // resident: a CTA an SM holds the whole timeline in shared memory
  const size_t row_bytes = sizeof(float) * pam::kTileStride;
  const long long per_sm = (n_total + sms - 1) / sms;
  int resident = per_sm * (long long)row_bytes <= optin;
  size_t smem = resident ? per_sm * row_bytes : pam::kFixThreads * row_bytes;
  err = cudaFuncSetAttribute(pam::replay_bnd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  int occ = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &occ, pam::replay_bnd_kernel, pam::kFixThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (occ < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int grid = (int)std::min<long long>((long long)occ * sms, n_total);
  int per = (n_total + grid - 1) / grid;
  if (resident) smem = per * row_bytes;  // fewer rows: still resident
  void* args[] = {&m,    &ca,   &cr,   &att0,    &idx_ex,   &s_out,
                  &s_new, &s_alt, &ctrl, &nblk,  &n_total,  &per,
                  &resident, &iters, &rounds};
  err = cudaLaunchCooperativeKernel((const void*)pam::replay_bnd_kernel,
                                    dim3(grid), dim3(pam::kFixThreads), args,
                                    smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
