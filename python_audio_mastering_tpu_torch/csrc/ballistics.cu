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
//   pam_replay_bnd    <- _replay_bnd / _replay_bnd_kernel: one round of the
//                        block-boundary fixed point (outgoing states only).
//
// What bounds them on the H100: a dependent chain of ~4 float ops per
// step, never bandwidth (the timeline is 12 MB for a 3-min track).  The
// replays are 128-step chains, one thread per (band, block); a CTA of 64
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
// The fixed point's control stays on the device.  `ctrl` is an int32
// record (kCtrl* below); each round of pam_replay_bnd adds its changed
// boundaries to it, and its last CTA applies the loop's stopping rule, so
// the driver launches every round without reading anything back: a round
// launched after the loop stopped copies its input through and exits.
// The two K5 launches, given `ctrl`, run only when the fixed point did
// not certify.
#include <cuda_runtime.h>

#include "ballistics.cuh"

namespace pam {

constexpr int kCtrlActive = 0;   // 1 while the fixed point iterates
constexpr int kCtrlCnt = 1;      // boundaries changed by the last round
constexpr int kCtrlCntPrev = 2;  // ... by the round before it
constexpr int kCtrlRound = 3;    // rounds run
constexpr int kCtrlChanged = 4;  // this round's running count (scratch)
constexpr int kCtrlDone = 5;     // CTAs of this round finished (scratch)
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

__global__ void __launch_bounds__(kReplayRows)
replay_bnd_kernel(const float* __restrict__ m, const float* __restrict__ ca,
                  const float* __restrict__ cr,
                  const float* __restrict__ att0,
                  const long long* __restrict__ idx_ex,
                  const float* __restrict__ s_out, float* __restrict__ s_new,
                  int* __restrict__ ctrl, int T, int iters) {
  __shared__ float tile[kReplayRows * kTileStride];
  __shared__ bool last;
  const int b = blockIdx.y;
  const int nblk = T / kBalBlock;
  const int blk0 = blockIdx.x * kReplayRows;
  const int rows = min(kReplayRows, nblk - blk0);
  const int t = threadIdx.x;
  const size_t at = (size_t)b * nblk + blk0 + t;
  if (ctrl[kCtrlActive] == 0) {  // the loop has stopped: carry s through
    if (t < rows) s_new[at] = s_out[at];
    return;
  }
  load_tile(m + (size_t)b * T, blk0, rows, tile);
  bool changed = false;
  if (t < rows) {
    // incoming state: the outgoing state of the last non-frozen block
    // before this one (frozen blocks, m == 0 throughout, are identities)
    const long long src = idx_ex[at];
    float att = src == 0 ? att0[b] : s_out[(size_t)b * nblk + src - 1];
    const float a = ca[b];
    const float r = cr[b];
    const float* v = tile + t * kTileStride;
#pragma unroll 8
    for (int j = 0; j < kBalBlock; ++j) att = ballistics_step(att, v[j], a, r);
    s_new[at] = att;
    changed = att != s_out[at];
  }
  const int n_changed = __syncthreads_count(changed);
  if (t == 0) {
    if (n_changed) atomicAdd(&ctrl[kCtrlChanged], n_changed);
    __threadfence();
    last = atomicAdd(&ctrl[kCtrlDone], 1) == (int)(gridDim.x * gridDim.y) - 1;
  }
  __syncthreads();
  if (last && t == 0) {  // every CTA of the round has counted: stop rule
    __threadfence();
    const int cnt = atomicExch(&ctrl[kCtrlChanged], 0);
    const int prev = ctrl[kCtrlCnt];
    const int k = ctrl[kCtrlRound] + 1;
    ctrl[kCtrlDone] = 0;
    ctrl[kCtrlCntPrev] = prev;
    ctrl[kCtrlCnt] = cnt;
    ctrl[kCtrlRound] = k;
    ctrl[kCtrlActive] =
        cnt != 0 && k < iters &&
        (k <= kStallGrace || 4LL * cnt < 3LL * (long long)prev);
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

// One fixed-point round: s_new (B, T / 128) from s_out, and ctrl updated
// (see above).
extern "C" int pam_replay_bnd(const float* m, const float* ca, const float* cr,
                              const float* att0, const long long* idx_ex,
                              const float* s_out, float* s_new, int* ctrl,
                              int B, int T, int iters, void* stream) {
  if (bad_shape(B, T) || iters < 1) return (int)cudaErrorInvalidValue;
  pam::replay_bnd_kernel<<<replay_grid(B, T), pam::kReplayRows, 0,
                           (cudaStream_t)stream>>>(
      m, ca, cr, att0, idx_ex, s_out, s_new, ctrl, T, iters);
  return (int)cudaGetLastError();
}
