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

namespace pam {

constexpr int kBalBlock = 128;  // control steps per block of the timeline

__device__ __forceinline__ float ballistics_step(float att, float m, float ca,
                                                 float cr) {
  const float attack = fminf(__fadd_rn(att, __fmul_rn(m, ca)), m);
  const float release = fmaxf(__fsub_rn(att, __fmul_rn(m, cr)), 0.f);
  return att <= m ? attack : release;
}

}  // namespace pam
