// The exact compressor ballistics: three kernels over a band-major (B, T)
// control timeline cut into blocks of kBalBlock = 128 steps, all running
// the one step of ballistics.cuh.  The driver is ops/ballistics.py.
//
// Replace the TPU kernels of python_audio_mastering_tpu/ops/pallas_kernels.py:
//
//   pam_pass1_bnd  <- _pass1_bnd / _bnd_kernel: the serial walk of the whole
//                     timeline, emitting each block's outgoing attenuation.
//   pam_replay     <- _replay / _replay_kernel: every block replayed from its
//                     exact incoming state, per-step attenuation out.
//   pam_replay_bnd <- _replay_bnd / _replay_bnd_kernel: one round of the
//                     block-boundary fixed point (outgoing states only).
//
// What bounds them on the H100: a dependent chain of ~4 float ops per
// step, never bandwidth (the timeline is 12 MB for a 3-min track).  The
// serial walk is one such chain of T steps per band, so it runs one warp
// per band: the 32 lanes load the next 128 steps coalesced while the
// current 128 are walked, every lane walking the same values received by
// shuffles.  The replays are 128-step chains, one thread per (band,
// block); a CTA of 64 threads stages its 64 blocks (contiguous in the
// timeline) through shared memory, so the loads and stores are coalesced
// and each thread walks its own padded row of the tile without bank
// conflicts.  The TPU's 8-sublane / 128-lane padding, T padded to 128^2
// and the time-major block transposes are not carried over: the timeline
// is read in place, padded only to whole blocks.
//
// The fixed point's control stays on the device.  `ctrl` is an int32
// record (kCtrl* below); each round of pam_replay_bnd adds its changed
// boundaries to it, and its last CTA applies the loop's stopping rule, so
// the driver launches every round without reading anything back: a round
// launched after the loop stopped copies its input through and exits.
// pam_pass1_bnd, given `ctrl`, runs only when the fixed point did not
// certify.
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

__global__ void __launch_bounds__(32)
pass1_bnd_kernel(const float* __restrict__ m, const float* __restrict__ ca,
                 const float* __restrict__ cr, const float* __restrict__ att0,
                 float* __restrict__ bnd, const int* __restrict__ ctrl,
                 int T) {
  if (ctrl != nullptr && ctrl[kCtrlCnt] == 0) return;  // certified
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const float* row = m + (size_t)b * T;
  const int nblk = T / kBalBlock;
  const float a = ca[b];
  const float r = cr[b];
  float att = att0[b];
  float cur[4], nxt[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) cur[i] = row[i * 32 + lane];
  for (int k = 0; k < nblk; ++k) {
    if (k + 1 < nblk) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        nxt[i] = row[(size_t)(k + 1) * kBalBlock + i * 32 + lane];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 32; ++j)
        att = ballistics_step(att, __shfl_sync(0xffffffffu, cur[i], j), a, r);
    if (lane == 0) bnd[(size_t)b * nblk + k] = att;
#pragma unroll
    for (int i = 0; i < 4; ++i) cur[i] = nxt[i];
  }
}

// Stage the CTA's blocks blk0 .. blk0 + rows - 1 of band b into the tile.
__device__ __forceinline__ void load_tile(const float* __restrict__ row,
                                          int blk0, int rows, float* tile) {
  const float* src = row + (size_t)blk0 * kBalBlock;
  for (int e = threadIdx.x; e < rows * kBalBlock; e += kReplayRows)
    tile[(e / kBalBlock) * kTileStride + e % kBalBlock] = src[e];
  __syncthreads();
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

// bnd (B, T / 128): each block's outgoing attenuation.  With ctrl not null
// it runs only when ctrl's last round count is not 0.  Returns the CUDA
// error code of the launch (0 on success).
extern "C" int pam_pass1_bnd(const float* m, const float* ca, const float* cr,
                             const float* att0, float* bnd, const int* ctrl,
                             int B, int T, void* stream) {
  if (bad_shape(B, T)) return (int)cudaErrorInvalidValue;
  pam::pass1_bnd_kernel<<<B, 32, 0, (cudaStream_t)stream>>>(m, ca, cr, att0,
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
