// The truncated normal of the MALA sweep kernels K4 (mala_sweep_k4.cu) and
// K4g (mala_sweep_k4g.cu): Phi by the plain version's formula, the box mass,
// the inverse-CDF sample and the proposal's log density, each following
// ops/mala_sweep.py and distributions.py operation by operation.

#pragma once

#include "mh_common.cuh"

namespace smcdet {

// Phi as the plain version computes it (distributions.py: ndtr, the JAX
// package's formula): (1 + erf(w)) / 2 for |w| < 1 / sqrt(2), w = z /
// sqrt(2), and erfc(|w|) / 2 (or 1 minus it) beyond. A drift far above the
// box leaves a mass of two values of Phi deep in its lower tail, which erfc
// keeps to f32's smallest numbers: its log is the true one, where
// (1 + erf(w)) / 2 flushes to 0 below z = -5.4 and the log mass to 0, which
// inflated the acceptance of such moves; a subnormal Phi is 0, as in the
// plain version. A drift far below the box leaves a mass of a few ulps of 1;
// computed alike, the kernel's and the plain version's masses round alike
// there.
__device__ __forceinline__ float phi_cdf(float z) {
  const float w = z * 0.70710678f;
  const float a = fabsf(w);
  const float y = a < 0.70710678f ? 0.5f * (1.f + erff(w))
                                  : 0.5f * (w > 0.f ? 2.f - erfcf(a)
                                                    : erfcf(a));
  return y < 1.17549435e-38f ? 0.f : y;
}

__device__ __forceinline__ float box_mass(float mu, float sigma, float lb,
                                          float ub) {
  return phi_cdf((ub - mu) / sigma) - phi_cdf((lb - mu) / sigma);
}

// Truncated-normal inverse-CDF sample with Phi above; *mass receives the box
// mass at mu.
__device__ __forceinline__ float box_sample(float u, float mu, float sigma,
                                            float lb, float ub,
                                            float* mass) {
  const float cdf_lb = phi_cdf((lb - mu) / sigma);
  *mass = phi_cdf((ub - mu) / sigma) - cdf_lb;
  const float p =
      fminf(fmaxf(cdf_lb + clip_unit(u) * *mass, kEps), kOneMinusEps);
  const float x = mu + sigma * normcdfinvf(p);
  return fminf(fmaxf(x, lb), ub);
}

// log density of the normal N(mu, sigma) truncated to the box of mass `mass`
__device__ __forceinline__ float tn_log_q(float x, float mu, float sigma,
                                         float log_sigma, float mass) {
  const float z = (x - mu) / sigma;
  return ((-0.5f * z) * z - log_sigma - kHalfLog2Pi) - log_mass(mass);
}

}  // namespace smcdet
