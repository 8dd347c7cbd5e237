// Device helpers shared by the sweep kernels (K1-K3: mh_sweep.cuh's body,
// K4: mala_sweep_k4.cu): the Philox4x32-10 stream, its
// uniforms, and the truncated-normal random walk with its truncation
// masses. Each follows the plain PyTorch version in ops/mh_sweep.py and
// distributions.py operation by operation.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace smcdet {

constexpr float kHalfLog2Pi = 0.91893853320467274f;
constexpr float kEps = 1e-6f;
constexpr float kOneMinusEps = 0.999999f;

__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0,
                                              uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c[0]);
    const uint32_t lo0 = 0xD2511F53u * c[0];
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]);
    const uint32_t lo1 = 0xCD9E8D57u * c[2];
    c[0] = hi1 ^ c[1] ^ k0;
    c[1] = lo1;
    c[2] = hi0 ^ c[3] ^ k1;
    c[3] = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
}

__device__ __forceinline__ float unit_uniform(uint32_t bits) {
  return ((float)(bits >> 8) + 0.5f) * 5.9604644775390625e-08f;  // 2^-24
}

__device__ __forceinline__ float clip_unit(float u) {
  return fminf(fmaxf(u, kEps), kOneMinusEps);
}

__device__ __forceinline__ float log_mass(float mass) {
  // log of the truncation mass, 0 where it is not positive (nan_to_num)
  return mass > 0.f ? logf(mass) : 0.f;
}

__device__ __forceinline__ float tn_mass(float mu, float sigma, float lb,
                                         float ub) {
  return normcdff((ub - mu) / sigma) - normcdff((lb - mu) / sigma);
}

// Truncated-normal inverse-CDF sample; *mass receives the box mass at mu.
__device__ __forceinline__ float tn_sample(float u, float mu, float sigma,
                                           float lb, float ub, float* mass) {
  const float cdf_lb = normcdff((lb - mu) / sigma);
  const float cdf_ub = normcdff((ub - mu) / sigma);
  *mass = cdf_ub - cdf_lb;
  const float p =
      fminf(fmaxf(cdf_lb + clip_unit(u) * (cdf_ub - cdf_lb), kEps),
            kOneMinusEps);
  const float x = mu + sigma * normcdfinvf(p);
  return fminf(fmaxf(x, lb), ub);
}

}  // namespace smcdet
