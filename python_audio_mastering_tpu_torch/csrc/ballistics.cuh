// One step of the compressor ballistics, shared by the three ballistics
// kernels (ballistics.cu) so that they run identical arithmetic.
//
// The pydub contract reduces each control step to one input, the target
// attenuation m >= 0 (dB), and two per-band rate factors ca, cr:
//
//     attack  = min(att + m * ca, m)
//     release = max(att - m * cr, 0)
//     att     = att <= m ? attack : release
//
// The multiply and the add/subtract are written as round-to-nearest
// intrinsics, which nvcc never contracts into an FMA.  Eager PyTorch rounds
// each of its separate ops the same way, so the kernels agree with their
// plain versions, and with each other, bit for bit.  The block-parallel
// fixed point (ops/ballistics.py) certifies its result by comparing block
// boundaries bitwise, which holds only because every kernel computes the
// same bits.
#pragma once

#include <math_constants.h>

namespace pam {

constexpr int kBalBlock = 128;  // control steps per block of the timeline

__device__ __forceinline__ float ballistics_step(float att, float m, float ca,
                                                 float cr) {
  const float attack = fminf(__fadd_rn(att, __fmul_rn(m, ca)), m);
  const float release = fmaxf(__fsub_rn(att, __fmul_rn(m, cr)), 0.f);
  return att <= m ? attack : release;
}

// The next float above m, as nextafterf(m, +inf), without a branch.
__device__ __forceinline__ float next_float_up(float m) {
  const int b = __float_as_int(m);
  const int up = b >= 0 ? b + 1 : (b == (int)0x80000000 ? 1 : b - 1);
  return m != m || m == CUDART_INF_F ? m : __int_as_float(up);
}

// One step of the block hull pass (ballistics.cu): [lo, hi] holds every
// state the block may be in, and is mapped to an interval that holds
// every image.  The step is monotone non-decreasing on each side of its
// branch point (see the note in ballistics.cu), so the interval is split
// at m: [lo, min(hi, m)] takes the attack branch, [max(lo, m+), hi] the
// release branch (m+ the next float above m), and the new interval is the
// hull of the two parts' images (the plain twin steps all four ends).
// Where the interval lies on one side of m, its ends map to the ends;
// where it straddles m (lo <= m < hi), the attack part's upper end m maps
// to m itself (min(m + m*ca, m) = m) and the release part's lower end is
// m+, whose image does not depend on the interval: so two ends and m+ are
// stepped, with no branch, bit for bit the four-end hull.
__device__ __forceinline__ void ballistics_hull_step(float& lo, float& hi,
                                                     float m, float ca,
                                                     float cr) {
  const bool straddle = lo <= m && hi > m;
  const float s_lo = ballistics_step(lo, m, ca, cr);
  const float s_hi = ballistics_step(hi, m, ca, cr);
  const float s_up = ballistics_step(next_float_up(m), m, ca, cr);
  lo = straddle ? fminf(s_lo, s_up) : s_lo;
  hi = straddle ? fmaxf(m, s_hi) : s_hi;
}

}  // namespace pam
