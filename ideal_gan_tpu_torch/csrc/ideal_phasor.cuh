// Phasor helpers shared by the IDEAL kernels (ideal_fit.cu, ideal_cycle.cu,
// ideal_forward.cu; ideal_mag_fit.cu takes its block size and TE test).
//
// The phasor of echo e is exp(sign*2*pi*i*te_e*phi) * exp(-sign*te_e*r2):
// sign = -1 demodulates (and grows by exp(+te*R2*)), sign = +1 remodulates
// (and decays). With a uniformly spaced TE train the phasors follow the
// recurrence W_e = W_{e-1} * W(dTE), two sincos/exp per voxel instead of one
// per echo.
#pragma once

#include <cuda_runtime.h>

namespace ideal {

constexpr int kNs = 2;
constexpr int kThreads = 256;
constexpr float kTwoPi = 6.283185307179586f;

// (c, s) = exp(sign*2*pi*i*te*phi) * exp(-sign*te*r2)
__device__ __forceinline__ void phasor(float sign, float te, float phi,
                                       float r2, float& c, float& s) {
  float sn, cs;
  sincosf(sign * kTwoPi * te * phi, &sn, &cs);
  const float g = expf(-sign * te * r2);
  c = cs * g;
  s = sn * g;
}

// (c, s) *= (dc, ds), complex
__device__ __forceinline__ void rotate(float& c, float& s, float dc,
                                       float ds) {
  const float nc = c * dc - s * ds;
  s = c * ds + s * dc;
  c = nc;
}

// The JAX package's uniformity test (_te_is_uniform): every spacing within
// 1e-9 s of the first, in double.
template <int NE>
__device__ bool te_is_uniform(const float* t) {
  const double d0 = (double)t[1] - (double)t[0];
  bool uni = true;
  for (int e = 2; e < NE; ++e)
    uni = uni && fabs(((double)t[e] - (double)t[e - 1]) - d0) <= 1e-9;
  return uni;
}

}  // namespace ideal
