// The tile model shared by kernels K1-K3 (mh_sweep.cuh's body, in
// mh_sweep_k2.cu and mh_sweep_k3.cu) and K4 (mala_sweep_k4.cu): their
// scalar parameters, the PSF (Gaussian, SDSS with the beta = 3 wing, SDSS
// with the general wing),
// one star's unit-flux render at one pixel under the patch mask, the pixel
// log-likelihood (Gaussian noise, or Poisson noise with a Normal tail), the
// flux prior's log-density (Pareto, Normal or none), and K4's gradient
// pieces. Each follows its plain PyTorch version in models/ or ops/
// operation by operation; every variant is a branch that is uniform across
// the grid, or a template argument of the kernel that folds it.

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

// The PSF of K2Params with each division by a launch constant turned into a
// product with its reciprocal, worked out once per thread (K1-K4).
struct PsfRecip {
  int kind;      // K2Params::psf_kind
  float e1, e2;  // Gaussian: -1 / (2 stdev^2); SDSS: -1 / (2 s1), -1 / (2 s2)
  float wq;      // SDSS: 1 / (beta sp)
  float wing;    // SDSS general wing: -beta / 2
  float b, p0;   // SDSS
  float scale;   // Gaussian: 1 / (stdev sqrt(2 pi)); SDSS: 1 / ((1+b+p0) norm)
};

__device__ __forceinline__ PsfRecip psf_recip(const K2Params& P) {
  PsfRecip R;
  R.kind = P.psf_kind;
  R.b = P.b;
  R.p0 = P.p0;
  if (P.psf_kind == 0) {
    R.e1 = -0.5f / (P.gauss_stdev * P.gauss_stdev);
    R.e2 = R.wq = R.wing = 0.f;
    R.scale = 1.f / P.gauss_norm;
  } else {
    R.e1 = -1.f / (2.f * P.s1);
    R.e2 = -1.f / (2.f * P.s2);
    R.wq = 1.f / (P.beta * P.sp);
    R.wing = -0.5f * P.beta;
    R.scale = 1.f / ((1.f + P.b + P.p0) * P.norm);
  }
  return R;
}

__device__ __forceinline__ float psf_eval_recip(float r2, const PsfRecip& R) {
  if (R.kind == 0) return expf(r2 * R.e1) * R.scale;
  const float t1 = expf(r2 * R.e1);
  const float t2 = R.b * expf(r2 * R.e2);
  const float q = 1.f + r2 * R.wq;
  const float t3 = R.kind == 1 ? R.p0 * rsqrtf(q * q * q)
                               : R.p0 * exp2f(R.wing * log2f(q));
  return (t1 + t2 + t3) * R.scale;
}

// One star's unit-flux render at the pixel in row h, column w (as floats)
// under the patch mask (models/imaging.py: star_image_flat).
__device__ __forceinline__ float star_pixel_recip(float h, float w, float ly,
                                                  float lx, float fy,
                                                  float fx, float radius,
                                                  const PsfRecip& R) {
  const float dy = (h + 0.5f) - ly;
  const float dx = (w + 0.5f) - lx;
  const bool in_patch =
      (fabsf(h - fy) <= radius) && (fabsf(w - fx) <= radius);
  const float psi = psf_eval_recip(dy * dy + dx * dx, R);
  return in_patch ? psi : 0.f;
}

// Row and column of pixel p = lane + L * k of a W-wide tile whose pixels are
// dealt to L lanes: L <= W puts W / L of a lane's pixels in each row, L > W
// puts them L / W rows apart.
template <int W, int L>
__device__ __forceinline__ void pixel_rc(int lane, int k, float* h,
                                         float* w) {
  if constexpr (L <= W) {
    *h = (float)(k / (W / L));
    *w = (float)(lane + L * (k % (W / L)));
  } else {
    *h = (float)(k * (L / W) + lane / W);
    *w = (float)(lane % W);
  }
}

// The gradient pieces of K4 (mala_sweep_k4.cu), each following
// ops/mala_sweep.py operation by operation (that file's psf_and_deriv,
// noise_recip, pixel_loglik and dll_drate). The functions above serve K1-K3
// as they are.

// psi(r2) and dpsi/dr2 of the PSF, sharing the exponentials. wd = -1 / (2 sp)
// is the wing's factor: d/dr2 p0 q^(-beta/2) = wd p0 q^(-beta/2) / q. On the
// beta = 3 wing one rsqrt of q gives both q^(-3/2) and 1 / q.
__device__ __forceinline__ void psf_and_deriv_recip(float r2,
                                                    const PsfRecip& R,
                                                    float wd, float* psi,
                                                    float* dpsi) {
  if (R.kind == 0) {
    const float v = expf(r2 * R.e1) * R.scale;
    *psi = v;
    *dpsi = v * R.e1;
    return;
  }
  const float t1 = expf(r2 * R.e1);
  const float t2 = R.b * expf(r2 * R.e2);
  const float q = 1.f + r2 * R.wq;
  float t3, t3q;  // the wing, and the wing over q
  if (R.kind == 1) {
    const float rq = rsqrtf(q);
    const float inv_q = rq * rq;
    t3 = R.p0 * (inv_q * rq);
    t3q = t3 * inv_q;
  } else {
    const float lq = log2f(q);
    t3 = R.p0 * exp2f(R.wing * lq);
    t3q = R.p0 * exp2f((R.wing - 1.f) * lq);
  }
  *psi = (t1 + t2 + t3) * R.scale;
  *dpsi = (t1 * R.e1 + t2 * R.e2 + t3q * wd) * R.scale;
}

// One star's unit-flux render at the pixel in row h, column w (as floats),
// dpsi/dr2 there (both 0 outside the patch) and the pixel centre minus the
// location.
__device__ __forceinline__ void star_pixel_deriv_recip(
    float h, float w, float ly, float lx, float fy, float fx, float radius,
    const PsfRecip& R, float wd, float* psi, float* dpsi, float* dy,
    float* dx) {
  *dy = (h + 0.5f) - ly;
  *dx = (w + 0.5f) - lx;
  const bool in_patch =
      (fabsf(h - fy) <= radius) && (fabsf(w - fx) <= radius);
  float v, dv;
  psf_and_deriv_recip(*dy * *dy + *dx * *dx, R, wd, &v, &dv);
  *psi = in_patch ? v : 0.f;
  *dpsi = in_patch ? dv : 0.f;
}

// The one reciprocal that a pixel's log-likelihood and its derivative in the
// rate share: 1 / var (Gaussian noise) or 1 / rate (Poisson noise), rounded
// as an IEEE division of 1 by it.
__device__ __forceinline__ float noise_recip(float rate, const K2Params& P) {
  return __frcp_rn(P.noise_kind == 0 ? P.noise_add + P.noise_mult * rate
                                     : rate);
}

// pixel_loglik with inv = noise_recip(rp) in place of the divisions.
__device__ __forceinline__ float pixel_loglik_recip(float img, float lg,
                                                    float rp, float inv,
                                                    const K2Params& P) {
  const float diff = img - rp;
  if (P.noise_kind == 0) {
    const float var = P.noise_add + P.noise_mult * rp;
    return (-0.5f * (diff * diff)) * inv - 0.5f * logf(var) - kHalfLog2Pi;
  }
  const float lr = logf(rp);
  if (rp > P.normal_tail) {
    return -0.5f * ((diff * diff) * inv) - 0.5f * lr - kHalfLog2Pi;
  }
  return img * lr - rp - lg;
}

// d(pixel log-likelihood)/d(rate), by the likelihood's own branch rule, with
// inv = noise_recip(rate).
__device__ __forceinline__ float pixel_dll_recip(float img, float rate,
                                                 float inv,
                                                 const K2Params& P) {
  const float r = img - rate;
  if (P.noise_kind == 0) {
    const float m = P.noise_mult;
    return (r * inv + (((0.5f * r) * r) * m) * (inv * inv)) -
           (0.5f * m) * inv;
  }
  if (rate > P.normal_tail) {
    return (r * inv + ((0.5f * r) * r) * (inv * inv)) - 0.5f * inv;
  }
  return img * inv - 1.f;
}

// d(flux prior log-density)/df.
__device__ __forceinline__ float flux_log_prob_grad(float f,
                                                    const K2Params& P) {
  if (P.flux_kind == 1) return -(P.flux_a + 1.f) / f;
  if (P.flux_kind == 2) return -(f - P.flux_a) / (P.flux_b * P.flux_b);
  return 0.f;
}

}  // namespace smcdet
