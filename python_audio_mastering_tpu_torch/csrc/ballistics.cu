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
// block); a CTA of 64 threads stages its 64 blocks (contiguous in the
// timeline) through shared memory, so the loads and stores are coalesced
// and each thread walks its own padded row of the tile without bank
// conflicts.  The TPU's 8-sublane
// / 128-lane padding, T padded to 128^2 and the time-major block
// transposes are not carried over: the timeline is read in place, padded
// only to whole blocks.
//
// The boundary walk (K5) is a segmented exact walk.  A serial walk is a
// chain of T dependent steps, milliseconds for a 3-min track; but most of
// that chain is not needed.  A block often forgets its incoming state: a
// clamp saturates (attack reaches m, release reaches 0) and every incoming
// state leaves the block in one same state.  And a block of zero targets
// (frozen) is the identity: for att >= 0 free of -0.0, m = 0 gives att <=
// 0 only at att = 0, where attack is min(0 + 0*ca, 0) = 0, and above 0
// release is max(att - 0*cr, 0) = att, bit for bit.
//
//   (a) pam_pass1_hull, one thread per (band, block), 64 blocks a CTA, the
//       CTA's targets staged into padded shared-memory rows by cp.async
//       (16-byte rows of 132 floats: a quarter-warp's float4 reads hit 8
//       distinct bank groups).  It walks the block's 128 steps on an
//       interval [lo, hi] of possible incoming states, starting from [0,
//       H], H = max(att0, max m) over the band (sound: attack gives <= m,
//       release <= att, and no step gives < 0).  The step f(att) = att <=
//       m ? min(att + m*ca, m) : max(att - m*cr, 0) is monotone
//       non-decreasing on each side of its branch point: round-to-nearest
//       addition and subtraction of a fixed operand, min and max with a
//       fixed operand are all monotone.  So f maps [lo, min(hi, m)] into
//       [f(lo), f(min(hi, m))] and [max(lo, m+), hi] into [f(max(lo, m+)),
//       f(hi)] (m+ the next float above m: the release branch takes att >
//       m), and the hull of the two holds every image
//       (ballistics_hull_step).  A block whose interval ends with lo == hi
//       has collapsed: its outgoing state is that float whatever comes in.
//       With m and att0 free of -0.0 (ballistics_rates_bt adds +0.0 to
//       them) no state is ever -0.0, so equal values are equal bits.  The
//       same pass marks each block that is live (some m != 0) or collapsed
//       as a stop: one bit a block, 32 blocks a word (a warp's ballot),
//       blocks past the band's end set.
//   (b) pam_pass1_runs, a cooperative grid of one CTA an SM, four warps a
//       CTA.  First every block, 32 to a warp: a collapsed block writes
//       its constant, and the first block of each maximal run of
//       non-collapsed blocks goes on a run list.  Then, after a grid
//       barrier, each run is walked by one warp, its lanes walking the
//       same values: from the exact outgoing state of the collapsed block
//       before it (or att0 for block 0), writing every boundary of the
//       run.  The walk goes from stop to stop.  The blocks between two
//       stops are frozen: the state passes through them unchanged (the
//       identity above), so no step is walked there, and the warp's 32
//       lanes store it to their boundaries.  A stop is a live block,
//       walked step by step, or a collapsed block (or the band's end),
//       where the run ends.  The next stop is found in the stop words: 32
//       lanes read 32 words (1024 blocks) at once and a ballot picks the
//       first set bit, word after word where a stretch is longer.
//
// The result is bitwise the serial walk's: collapsed constants are exact
// by the argument above, frozen blocks are identities, and every live
// block is walked from an exact state with the same arithmetic.  Runs go
// in parallel, so the serial part is the live blocks of the longest run,
// not T.  Worst case, no block collapses or freezes: one run of the whole
// timeline, a walk of all T steps.
//
// What bounds K5: the walk, a chain of dependent steps as long as the
// live steps of the longest run (the 3-min worker track: 52 blocks, 6 656
// steps).  Each step's chain is the add, the clamp and the select of
// ballistics_step (17 cycles in the SASS, scripts/k5_probe.py); its
// products and its compare are off the chain.  So the design keeps
// everything else off the chain:
//   - a walker warp has a scheduler to itself: run j goes to warp j /
//     #SMs of CTA j % #SMs, so the runs spread over the SMs first, then
//     over an SM's four schedulers (warps launched where their runs
//     start, ~300 of them on the worker track, lost their steps' issue
//     slots to each other where they shared a scheduler);
//   - the 32 lanes walk the same values (no shuffle a step): the live
//     block's 128 targets sit in a shared-memory slot, read as float4
//     broadcasts that the unrolled walk issues ahead of their steps;
//   - while a block is walked, the next stop, its targets (cp.async into
//     the other of the warp's two slots, 16 bytes a lane), its hull and
//     the stop words after it are already on their way: none of their
//     addresses depends on the state;
//   - the stores of a frozen stretch come after the block's walk, one a
//     lane, and nothing else stands between two live blocks but the
//     copies' wait and two warp barriers.
// Its bytes (m read once, the boundaries written once) take ~4 us on a
// 3-min track; the hull pass is parallel, one 128-step interval walk a
// thread.
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

// --- K5 ------------------------------------------------------------------

constexpr int kHullStride = kBalBlock + 4;  // 16-byte rows (cp.async)

// Words of 32 stop bits a band.
__device__ __forceinline__ int stop_words(int nblk) { return (nblk + 31) / 32; }

__device__ __forceinline__ void copy16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(smem)),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

__global__ void __launch_bounds__(kReplayRows)
pass1_hull_kernel(const float* __restrict__ m, const float* __restrict__ ca,
                  const float* __restrict__ cr,
                  const float* __restrict__ hmax, float* __restrict__ lo_out,
                  float* __restrict__ hi_out, unsigned* __restrict__ stops,
                  const int* __restrict__ ctrl, int T) {
  if (ctrl != nullptr && ctrl[kCtrlCnt] == 0) return;  // certified
  __shared__ __align__(16) float tile[kReplayRows * kHullStride];
  const int b = blockIdx.y;
  const int nblk = T / kBalBlock;
  const int blk0 = blockIdx.x * kReplayRows;
  const int rows = min(kReplayRows, nblk - blk0);
  const float* src = m + (size_t)b * T + (size_t)blk0 * kBalBlock;
  // every 16-byte piece of the CTA's blocks in flight at once
  for (int e = threadIdx.x; e < rows * (kBalBlock / 4); e += kReplayRows)
    copy16(tile + (e / (kBalBlock / 4)) * kHullStride +
               4 * (e % (kBalBlock / 4)),
           src + 4 * e);
  copy_commit();
  copy_wait<0>();
  __syncthreads();
  const int t = threadIdx.x;
  bool stop = true;  // past the band's end: every walk stops there
  if (t < rows) {
    const float a = ca[b];
    const float r = cr[b];
    float lo = 0.f;
    float hi = hmax[b];
    bool live = false;
    const float4* v = reinterpret_cast<const float4*>(tile + t * kHullStride);
#pragma unroll 2
    for (int i = 0; i < kBalBlock / 4; ++i) {
      const float4 q = v[i];
      live |= (q.x != 0.f) | (q.y != 0.f) | (q.z != 0.f) | (q.w != 0.f);
      ballistics_hull_step(lo, hi, q.x, a, r);
      ballistics_hull_step(lo, hi, q.y, a, r);
      ballistics_hull_step(lo, hi, q.z, a, r);
      ballistics_hull_step(lo, hi, q.w, a, r);
    }
    const size_t at = (size_t)b * nblk + blk0 + t;
    lo_out[at] = lo;
    hi_out[at] = hi;
    stop = live || lo == hi;
  }
  const unsigned word = __ballot_sync(0xffffffffu, stop);
  const int nw = stop_words(nblk);
  const int w = blk0 / 32 + t / 32;
  if (t % 32 == 0 && w < nw) stops[(size_t)b * nw + w] = word;
}

constexpr int kWalkWarps = 4;  // walker warps a CTA, one a scheduler
// more than half an SM's shared memory (unused): one CTA an SM
constexpr int kOneCtaAnSm = 120 * 1024;

// The first block at or after p whose stop bit is set, from the 32 words
// at p / 32 that the lanes hold, one each (q); -1 where they hold none.
__device__ __forceinline__ int first_stop(unsigned q, int p, int lane) {
  if (lane == 0) q &= ~0u << (p % 32);
  const unsigned any = __ballot_sync(0xffffffffu, q != 0u);
  if (any == 0u) return -1;
  const int at = __ffs(any) - 1;
  const unsigned word = __shfl_sync(0xffffffffu, q, at);
  return 32 * (p / 32 + at) + __ffs(word) - 1;
}

// The lane's word of the 32 stop words at p / 32 (all set past the last).
__device__ __forceinline__ unsigned stop_window(const unsigned* st, int nw,
                                                int p, int lane) {
  const int w = p / 32 + lane;
  return w < nw ? __ldg(st + w) : ~0u;
}

// The first stop at or after p (blocks past the band's end are stops).
__device__ __forceinline__ int next_stop(const unsigned* st, int nw, int p,
                                         int lane) {
  for (;; p = 32 * (p / 32 + 32)) {
    const int s = first_stop(stop_window(st, nw, p, lane), p, lane);
    if (s >= 0) return s;
  }
}

// One live block's 128 steps from its shared-memory slot, every lane
// walking the same values.
__device__ __forceinline__ float walk_block(float att, const float* slot,
                                            float a, float r) {
  const float4* v = reinterpret_cast<const float4*>(slot);
#pragma unroll
  for (int i = 0; i < kBalBlock / 4; ++i) {
    const float4 q = v[i];
    att = ballistics_step(att, q.x, a, r);
    att = ballistics_step(att, q.y, a, r);
    att = ballistics_step(att, q.z, a, r);
    att = ballistics_step(att, q.w, a, r);
  }
  return att;
}

// A block's 128 targets into a slot: 16 bytes a lane, one copy group.
__device__ __forceinline__ void stage_block(float* slot, const float* src,
                                            int lane) {
  copy16(slot + 4 * lane, src + 4 * lane);
  copy_commit();
}

// The run that starts at block g (band-major index), walked by the whole
// warp from stop to stop; `slots` is the warp's two 128-float slots.
__device__ __forceinline__ void walk_run(
    int g, const float* __restrict__ m, const float* __restrict__ ca,
    const float* __restrict__ cr, const float* __restrict__ att0,
    const float* __restrict__ lo, const float* __restrict__ hi,
    const unsigned* __restrict__ stops, float* __restrict__ bnd, int nblk,
    float* slots) {
  const int lane = threadIdx.x % 32;
  const int b = g / nblk;
  const int k = g % nblk;
  const float* l = lo + (size_t)b * nblk;
  const float* h = hi + (size_t)b * nblk;
  float* out = bnd + (size_t)b * nblk;
  const float* row = m + (size_t)b * nblk * kBalBlock;
  const int nw = stop_words(nblk);
  const unsigned* st = stops + (size_t)b * nw;
  const float a = ca[b];
  const float r = cr[b];
  float att = k == 0 ? att0[b] : l[k - 1];
  // the run's first stop; the blocks before it are frozen
  int s = next_stop(st, nw, k, lane);
  for (int q = k + lane; q < s; q += 32) out[q] = att;
  if (s >= nblk || l[s] == h[s]) return;  // the run ends there
  stage_block(slots, row + (size_t)s * kBalBlock, lane);
  unsigned win = stop_window(st, nw, s + 1, lane);
  for (int cur = 0;; cur ^= 1) {
    // s is live and its targets are on their way into slot cur; before
    // its walk: the next stop s2, its hull, its targets (into the other
    // slot) and the words after it
    int s2 = first_stop(win, s + 1, lane);
    if (s2 < 0) s2 = next_stop(st, nw, 32 * ((s + 1) / 32 + 32), lane);
    const bool more = s2 < nblk;
    float l2 = 0.f, h2 = 0.f;
    __syncwarp();  // every lane is done with the slot refilled here
    if (more) {
      l2 = l[s2];
      h2 = h[s2];
      stage_block(slots + (cur ^ 1) * kBalBlock,
                  row + (size_t)s2 * kBalBlock, lane);
      win = stop_window(st, nw, s2 + 1, lane);
      copy_wait<1>();
    } else {
      copy_wait<0>();
    }
    __syncwarp();  // every lane's part of s's targets has landed
    att = walk_block(att, slots + cur * kBalBlock, a, r);
    if (lane == 0) out[s] = att;
    for (int q = s + 1 + lane; q < s2; q += 32) out[q] = att;  // frozen
    if (!more || l2 == h2) return;  // the run ends at s2
    s = s2;
  }
}

// A cooperative grid of one CTA an SM (see the note above).  Phase 1:
// every block, a warp's 32 at a time: a collapsed block writes its
// constant, a run's first block goes on the run list (starts, count).
// Phase 2, after the grid barrier: run j on warp j / gridDim.x of CTA j %
// gridDim.x, so that the runs spread over the SMs first, then over an SM's
// four schedulers, one walker warp a scheduler while the runs last.
__global__ void __launch_bounds__(32 * kWalkWarps)
pass1_runs_kernel(const float* __restrict__ m, const float* __restrict__ ca,
                  const float* __restrict__ cr,
                  const float* __restrict__ att0,
                  const float* __restrict__ lo, const float* __restrict__ hi,
                  const unsigned* __restrict__ stops, float* __restrict__ bnd,
                  int* starts, int* count, const int* __restrict__ ctrl,
                  int nblk, int n_total) {
  if (ctrl != nullptr && ctrl[kCtrlCnt] == 0) return;  // certified
  __shared__ __align__(16) float ring[kWalkWarps][2][kBalBlock];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int g0 = (blockIdx.x * kWalkWarps + warp) * 32; g0 < n_total;
       g0 += gridDim.x * kWalkWarps * 32) {
    const int g = g0 + lane;
    bool first = false;
    if (g < n_total) {
      const float lg = lo[g];
      const float hg = hi[g];
      if (lg == hg) {  // collapsed: the constant, whatever comes in
        bnd[g] = lg;
      } else {
        first = g % nblk == 0 || lo[g - 1] == hi[g - 1];
      }
    }
    const unsigned mask = __ballot_sync(0xffffffffu, first);
    int base = 0;
    if (lane == 0 && mask != 0u) base = atomicAdd(count, __popc(mask));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (first) starts[base + __popc(mask & ((1u << lane) - 1u))] = g;
  }
  grid.sync();
  const int n_runs = __ldcg(count);
  for (int j = warp * gridDim.x + blockIdx.x; j < n_runs;
       j += gridDim.x * kWalkWarps)
    walk_run(__ldcg(starts + j), m, ca, cr, att0, lo, hi, stops, bnd, nblk,
             &ring[warp][0][0]);
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
// hmax[b]] coming in; stops (B, stop_words(T / 128)): bit j % 32 of word
// j / 32 set where block j is live or collapsed (or past the end).  m
// must be 16-byte aligned.  With ctrl not null it runs only when ctrl's
// last round count is not 0.  Returns the CUDA error code of the launch (0
// on success).
extern "C" int pam_pass1_hull(const float* m, const float* ca, const float* cr,
                              const float* hmax, float* lo, float* hi,
                              unsigned* stops, const int* ctrl, int B, int T,
                              void* stream) {
  if (bad_shape(B, T)) return (int)cudaErrorInvalidValue;
  pam::pass1_hull_kernel<<<replay_grid(B, T), pam::kReplayRows, 0,
                           (cudaStream_t)stream>>>(m, ca, cr, hmax, lo, hi,
                                                   stops, ctrl, T);
  return (int)cudaGetLastError();
}

// bnd (B, T / 128): each block's outgoing attenuation, from the hulls and
// stop words of pam_pass1_hull.  starts (at least B * ceil(T / 256) ints)
// is scratch; count (one int) must be 0.  m must be 16-byte aligned.  A
// cooperative launch of one-warp CTAs, as many as the card holds at once.
// Gated on ctrl as above.
extern "C" int pam_pass1_runs(const float* m, const float* ca, const float* cr,
                              const float* att0, const float* lo,
                              const float* hi, const unsigned* stops,
                              float* bnd, int* starts, int* count,
                              const int* ctrl, int B, int T, void* stream) {
  if (bad_shape(B, T) ||
      (long long)B * (T / pam::kBalBlock) >= (1LL << 31) - 32)
    return (int)cudaErrorInvalidValue;
  int nblk = T / pam::kBalBlock;
  int n_total = B * nblk;
  int dev = 0, sms = 0, occ = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int smem = pam::kOneCtaAnSm;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(pam::pass1_runs_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, pam::pass1_runs_kernel, 32 * pam::kWalkWarps, smem);
  if (err != cudaSuccess) return (int)err;
  if (occ != 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int grid = (int)std::min<long long>(
      sms, (n_total + 32 * pam::kWalkWarps - 1) / (32 * pam::kWalkWarps));
  void* args[] = {&m,  &ca,     &cr,    &att0,  &lo,    &hi,   &stops,
                  &bnd, &starts, &count, &ctrl, &nblk, &n_total};
  err = cudaLaunchCooperativeKernel((const void*)pam::pass1_runs_kernel,
                                    dim3(grid), dim3(32 * pam::kWalkWarps),
                                    args, smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
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
