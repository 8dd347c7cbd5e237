// Fused single-component Metropolis-Hastings sweep loop for Hopper (sm_90a).
//
// Replaces the TPU kernel smcdet_tpu/ops/pallas_sweep.py:_make_kernel in its
// main-path specialization (kernel K1): tile target, Gaussian noise with
// variance noise_add + noise_mult * rate, SDSS PSF with the beta = 3 wing,
// Pareto flux prior, 8x8-pixel tiles, no aggregation child term.
//
// What bounds it on this card: FP32 and SFU work. Each update renders the old
// and the proposed star over all 64 pixels (2 x 64 x (2 expf + 1 rsqrtf)) and
// evaluates the Gaussian likelihood of the proposed rate (64 x (logf + div)).
// State (locs, fluxes, the 64-float rate cache, pll, lp: ~340 B per particle)
// touches device memory once per call, not once per sweep, as in the Pallas
// kernel.
//
// Design: one thread per particle; the grid is (groups, ceil(N / block)), so a
// block shares one image (staged once in shared memory) and one temperature.
// The kernel is templated on the tile size and the slot count M, and every
// pixel and slot loop is unrolled, so the rate cache, the proposed rate and
// the catalog stay in registers. Slot j is read and written by compare-select
// over the unrolled slots (no dynamically indexed local memory).
//
// Random numbers: Philox4x32-10 keyed by the 64-bit per-call key, with the
// counter (particle, sweep, draw, particle >> 32), where particle is the
// global index g * N + n. The stream is a pure function of the key and the
// particle's place in the batch, independent of the launch geometry; the
// plain PyTorch version (ops/mh_sweep.py) draws the same stream.
//
// Arithmetic follows the plain version operation by operation (same
// association order, IEEE division, no fast-math), so the two agree particle
// by particle up to the library's expf/logf/normcdff rounding and the order of
// the 64-pixel likelihood sum.

#include "mh_common.cuh"

// Scalar parameters, passed by value; the field order is mirrored by
// ops/mh_sweep.py:_MHParams.
struct MHParams {
  float locs_stdev, fluxes_stdev, flux_lo, flux_hi;
  float loc_low_y, loc_low_x, loc_high_y, loc_high_x;
  float adu, noise_add, noise_mult, psf_radius;
  float s1, s2, sp, beta, b, p0, norm;
  float pareto_alpha, pareto_lognorm;
};

namespace {

using namespace smcdet;

__device__ __forceinline__ float sdss_psf_beta3(float r2, const MHParams& P) {
  const float t1 = expf(-r2 / (2.f * P.s1));
  const float t2 = P.b * expf(-r2 / (2.f * P.s2));
  const float q = 1.f + r2 / (P.beta * P.sp);
  const float t3 = P.p0 * rsqrtf(q * q * q);
  return ((t1 + t2 + t3) / (1.f + P.b + P.p0)) / P.norm;
}

template <int W>
__device__ __forceinline__ float star_pixel(int p, float ly, float lx,
                                            float fy, float fx,
                                            const MHParams& P) {
  const float h = (float)(p / W);
  const float w = (float)(p % W);
  const float dy = (h + 0.5f) - ly;
  const float dx = (w + 0.5f) - lx;
  const bool in_patch =
      (fabsf(h - fy) <= P.psf_radius) && (fabsf(w - fx) <= P.psf_radius);
  const float psi = sdss_psf_beta3(dy * dy + dx * dx, P);
  return in_patch ? psi : 0.f;
}

__device__ __forceinline__ float pareto_log_prob(float f, const MHParams& P) {
  return P.pareto_lognorm - (P.pareto_alpha + 1.f) * logf(f);
}

template <int H, int W, int M>
__global__ void __launch_bounds__(128)
mh_sweep_kernel(const int64_t* __restrict__ key,
                const float* __restrict__ image,
                const float* __restrict__ temperature,
                const int32_t* __restrict__ counts,
                const float* __restrict__ locs_in,
                const float* __restrict__ fluxes_in,
                const float* __restrict__ rate_in,
                const float* __restrict__ pll_in,
                const float* __restrict__ lp_in,
                float* __restrict__ locs_out, float* __restrict__ fluxes_out,
                float* __restrict__ rate_out, float* __restrict__ pll_out,
                float* __restrict__ lp_out, float* __restrict__ acc_out,
                int N, int num_iters, MHParams P) {
  constexpr int HW = H * W;
  __shared__ float s_img[HW];
  const int g = blockIdx.x;
  for (int p = threadIdx.x; p < HW; p += blockDim.x) {
    s_img[p] = image[(int64_t)g * HW + p];
  }
  __syncthreads();
  const int n = blockIdx.y * blockDim.x + threadIdx.x;
  if (n >= N) return;

  const int64_t pid = (int64_t)g * N + n;
  const uint32_t k0 = (uint32_t)key[0];
  const uint32_t k1 = (uint32_t)key[1];
  const float tau = temperature[g];
  const int count = counts[pid];

  float ly[M], lx[M], fl[M], rate[HW], rate_prop[HW];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    ly[m] = locs_in[(pid * M + m) * 2];
    lx[m] = locs_in[(pid * M + m) * 2 + 1];
    fl[m] = fluxes_in[pid * M + m];
  }
#pragma unroll
  for (int p = 0; p < HW; ++p) rate[p] = rate_in[pid * HW + p];
  float pll = pll_in[pid];
  float lp = lp_in[pid];
  int accepted = 0;

  // a particle with no occupied slot never moves (its proposals are not
  // applied), so it skips the loop and passes through bit-exactly
  const int iters = count > 0 ? num_iters : 0;
  const float count_f = (float)count;
  for (int it = 0; it < iters; ++it) {
    uint32_t r0[4] = {(uint32_t)pid, (uint32_t)it, 0u, (uint32_t)(pid >> 32)};
    uint32_t r1[4] = {(uint32_t)pid, (uint32_t)it, 1u, (uint32_t)(pid >> 32)};
    philox4x32_10(r0, k0, k1);
    philox4x32_10(r1, k0, k1);
    const float u_j = unit_uniform(r0[0]);
    const float u_acc = unit_uniform(r1[0]);

    // uniform slot over the occupied prefix 0..count-1
    const int j = min((int)floorf(u_j * count_f), count - 1);
    float ly_j = 0.f, lx_j = 0.f, f_j = 0.f;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      if (m == j) {
        ly_j = ly[m];
        lx_j = lx[m];
        f_j = fl[m];
      }
    }

    float mass_y, mass_x, mass_f;
    const float y_prop = tn_sample(unit_uniform(r0[1]), ly_j, P.locs_stdev,
                                   P.loc_low_y, P.loc_high_y, &mass_y);
    const float x_prop = tn_sample(unit_uniform(r0[2]), lx_j, P.locs_stdev,
                                   P.loc_low_x, P.loc_high_x, &mass_x);
    const float f_prop = tn_sample(unit_uniform(r0[3]), f_j, P.fluxes_stdev,
                                   P.flux_lo, P.flux_hi, &mass_f);

    // incremental rate update and the proposal's Gaussian log-likelihood
    const float fy_old = floorf(ly_j), fx_old = floorf(lx_j);
    const float fy_new = floorf(y_prop), fx_new = floorf(x_prop);
    float pll_prop = 0.f;
#pragma unroll
    for (int p = 0; p < HW; ++p) {
      const float psi_old = star_pixel<W>(p, ly_j, lx_j, fy_old, fx_old, P);
      const float psi_new = star_pixel<W>(p, y_prop, x_prop, fy_new, fx_new, P);
      const float d = P.adu * (f_prop * psi_new - f_j * psi_old);
      const float rp = rate[p] + d;
      rate_prop[p] = rp;
      const float var = P.noise_add + P.noise_mult * rp;
      const float diff = s_img[p] - rp;
      pll_prop += (-0.5f * (diff * diff)) / var - 0.5f * logf(var) -
                  kHalfLog2Pi;
    }
    const float lp_prop =
        lp + (pareto_log_prob(f_prop, P) - pareto_log_prob(f_j, P));

    // symmetric random walk: only the truncation masses remain
    const float log_q =
        (log_mass(mass_y) + log_mass(mass_x)) -
        (log_mass(tn_mass(y_prop, P.locs_stdev, P.loc_low_y, P.loc_high_y)) +
         log_mass(tn_mass(x_prop, P.locs_stdev, P.loc_low_x, P.loc_high_x))) +
        log_mass(mass_f) -
        log_mass(tn_mass(f_prop, P.fluxes_stdev, P.flux_lo, P.flux_hi));
    const float log_alpha =
        ((lp_prop + tau * pll_prop) - (lp + tau * pll)) + log_q;
    // NaN-propagating min(log_alpha, 0): a NaN target never accepts
    const float capped = log_alpha > 0.f ? 0.f : log_alpha;
    if (u_acc <= expf(capped)) {
#pragma unroll
      for (int m = 0; m < M; ++m) {
        if (m == j) {
          ly[m] = y_prop;
          lx[m] = x_prop;
          fl[m] = f_prop;
        }
      }
#pragma unroll
      for (int p = 0; p < HW; ++p) rate[p] = rate_prop[p];
      pll = pll_prop;
      lp = lp_prop;
      ++accepted;
    }
  }

#pragma unroll
  for (int m = 0; m < M; ++m) {
    locs_out[(pid * M + m) * 2] = ly[m];
    locs_out[(pid * M + m) * 2 + 1] = lx[m];
    fluxes_out[pid * M + m] = fl[m];
  }
#pragma unroll
  for (int p = 0; p < HW; ++p) rate_out[pid * HW + p] = rate[p];
  pll_out[pid] = pll;
  lp_out[pid] = lp;
  acc_out[pid] = (float)accepted / (float)num_iters;
}

template <int M>
cudaError_t launch_8x8(const int64_t* key, const float* image,
                       const float* temperature, const int32_t* counts,
                       const float* locs_in, const float* fluxes_in,
                       const float* rate_in, const float* pll_in,
                       const float* lp_in, float* locs_out, float* fluxes_out,
                       float* rate_out, float* pll_out, float* lp_out,
                       float* acc_out, int G, int N, int num_iters,
                       const MHParams& P, cudaStream_t stream) {
  constexpr int kBlock = 128;
  const dim3 grid(G, (N + kBlock - 1) / kBlock);
  mh_sweep_kernel<8, 8, M><<<grid, kBlock, 0, stream>>>(
      key, image, temperature, counts, locs_in, fluxes_in, rate_in, pll_in,
      lp_in, locs_out, fluxes_out, rate_out, pll_out, lp_out, acc_out, N,
      num_iters, P);
  return cudaGetLastError();
}

}  // namespace

// Launch K1 on `stream`. Tensors are contiguous: image [G, 64],
// temperature [G], counts [G, N] int32, locs [G, N, M, 2], fluxes [G, N, M],
// rate [G, N, 64], pll / lp / acc [G, N], key int64 [2]. Returns the CUDA
// error of the launch (0 on success); H and W must be 8 and 1 <= M <= 8.
extern "C" int smcdet_mh_sweeps_launch(
    const void* key, const void* image, const void* temperature,
    const void* counts, const void* locs_in, const void* fluxes_in,
    const void* rate_in, const void* pll_in, const void* lp_in,
    void* locs_out, void* fluxes_out, void* rate_out, void* pll_out,
    void* lp_out, void* acc_out, int G, int N, int M, int H, int W,
    int num_iters, MHParams params, void* stream) {
  if (H != 8 || W != 8 || G <= 0 || N <= 0 || num_iters <= 0 ||
      (N + 127) / 128 > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const auto* k = static_cast<const int64_t*>(key);
  const auto* img = static_cast<const float*>(image);
  const auto* tmp = static_cast<const float*>(temperature);
  const auto* cnt = static_cast<const int32_t*>(counts);
  const auto* li = static_cast<const float*>(locs_in);
  const auto* fi = static_cast<const float*>(fluxes_in);
  const auto* ri = static_cast<const float*>(rate_in);
  const auto* pi = static_cast<const float*>(pll_in);
  const auto* lpi = static_cast<const float*>(lp_in);
  auto* lo = static_cast<float*>(locs_out);
  auto* fo = static_cast<float*>(fluxes_out);
  auto* ro = static_cast<float*>(rate_out);
  auto* po = static_cast<float*>(pll_out);
  auto* lpo = static_cast<float*>(lp_out);
  auto* ao = static_cast<float*>(acc_out);
  auto s = static_cast<cudaStream_t>(stream);
#define SMCDET_LAUNCH(MM)                                                    \
  case MM:                                                                   \
    return (int)launch_8x8<MM>(k, img, tmp, cnt, li, fi, ri, pi, lpi, lo, fo, \
                               ro, po, lpo, ao, G, N, num_iters, params, s)
  switch (M) {
    SMCDET_LAUNCH(1);
    SMCDET_LAUNCH(2);
    SMCDET_LAUNCH(3);
    SMCDET_LAUNCH(4);
    SMCDET_LAUNCH(5);
    SMCDET_LAUNCH(6);
    SMCDET_LAUNCH(7);
    SMCDET_LAUNCH(8);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SMCDET_LAUNCH
}
