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

// One step of the block hull pass (ballistics.cu): [lo, hi] holds every
// state the block may be in, and is mapped to an interval that holds
// every image.  The step is monotone non-decreasing on each side of its
// branch point (see the note in ballistics.cu), so the interval is split
// at m: [lo, min(hi, m)] takes the attack branch, [max(lo, m+), hi] the
// release branch (m+ the next float above m), and each part's two ends go
// through ballistics_step itself.  The new interval is the hull of the two
// images.  An empty part (lo > m, or hi <= m) is left out.
__device__ __forceinline__ void ballistics_hull_step(float& lo, float& hi,
                                                     float m, float ca,
                                                     float cr) {
  float nlo = CUDART_INF_F;
  float nhi = -CUDART_INF_F;
  if (lo <= m) {
    nlo = ballistics_step(lo, m, ca, cr);
    nhi = ballistics_step(fminf(hi, m), m, ca, cr);
  }
  if (hi > m) {
    nlo = fminf(nlo, ballistics_step(fmaxf(lo, nextafterf(m, CUDART_INF_F)),
                                     m, ca, cr));
    nhi = fmaxf(nhi, ballistics_step(hi, m, ca, cr));
  }
  lo = nlo;
  hi = nhi;
}

}  // namespace pam
