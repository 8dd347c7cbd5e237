// The tile model shared by kernels K2 (mh_sweep_k2.cu) and K3
// (mh_sweep_k3.cu): their scalar parameters, the PSF (Gaussian, SDSS with
// the beta = 3 wing, SDSS with the general wing), one star's unit-flux
// render at one pixel under the patch mask, the pixel log-likelihood
// (Gaussian noise, or Poisson noise with a Normal tail) and the flux prior's
// log-density (Pareto, Normal or none). Each follows the plain PyTorch
// version in models/ operation by operation; every variant is a branch that
// is uniform across the grid.

#pragma once

#include "mh_common.cuh"

// Scalar parameters, passed by value; the field order is mirrored by
// ops/mh_sweep.py:_K2Params.
struct K2Params {
  float locs_stdev, fluxes_stdev, flux_lo, flux_hi;
  float loc_low_y, loc_low_x, loc_high_y, loc_high_x;
  float adu, noise_add, noise_mult, psf_radius, normal_tail;
  float s1, s2, sp, beta, b, p0, norm;  // SDSS PSF
  float gauss_stdev, gauss_norm;        // Gaussian PSF: stdev, stdev sqrt(2 pi)
  float flux_a, flux_b, flux_c;  // Pareto: alpha, log-normaliser;
                                 // Normal: mean, stdev, log(stdev)
  int noise_kind;  // 0 Gaussian, 1 Poisson
  int psf_kind;    // 0 Gaussian, 1 SDSS beta = 3, 2 SDSS general beta
  int flux_kind;   // 0 none, 1 Pareto, 2 Normal
};

namespace smcdet {

__device__ __forceinline__ float psf_eval(float r2, const K2Params& P) {
  if (P.psf_kind == 0) {
    return expf((-0.5f * r2) / (P.gauss_stdev * P.gauss_stdev)) /
           P.gauss_norm;
  }
  const float t1 = expf(-r2 / (2.f * P.s1));
  const float t2 = P.b * expf(-r2 / (2.f * P.s2));
  const float q = 1.f + r2 / (P.beta * P.sp);
  const float t3 = P.psf_kind == 1 ? P.p0 * rsqrtf(q * q * q)
                                   : P.p0 * powf(q, -P.beta / 2.f);
  return ((t1 + t2 + t3) / (1.f + P.b + P.p0)) / P.norm;
}

template <int W>
__device__ __forceinline__ float star_pixel(int p, float ly, float lx,
                                            float fy, float fx,
                                            const K2Params& P) {
  const float h = (float)(p / W);
  const float w = (float)(p % W);
  const float dy = (h + 0.5f) - ly;
  const float dx = (w + 0.5f) - lx;
  const bool in_patch =
      (fabsf(h - fy) <= P.psf_radius) && (fabsf(w - fx) <= P.psf_radius);
  const float psi = psf_eval(dy * dy + dx * dx, P);
  return in_patch ? psi : 0.f;
}

__device__ __forceinline__ float pixel_loglik(float img, float lg, float rp,
                                              const K2Params& P) {
  const float diff = img - rp;
  if (P.noise_kind == 0) {
    const float var = P.noise_add + P.noise_mult * rp;
    return (-0.5f * (diff * diff)) / var - 0.5f * logf(var) - kHalfLog2Pi;
  }
  const float lr = logf(rp);
  if (rp > P.normal_tail) {
    return -0.5f * ((diff * diff) / rp) - 0.5f * lr - kHalfLog2Pi;
  }
  return img * lr - rp - lg;
}

__device__ __forceinline__ float flux_log_prob(float f, const K2Params& P) {
  if (P.flux_kind == 1) return P.flux_b - (P.flux_a + 1.f) * logf(f);
  if (P.flux_kind == 2) {
    const float z = (f - P.flux_a) / P.flux_b;
    return -0.5f * z * z - P.flux_c - kHalfLog2Pi;
  }
  return 0.f;
}

}  // namespace smcdet
