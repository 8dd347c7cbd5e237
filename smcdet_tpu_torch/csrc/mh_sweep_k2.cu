// Fused single-component Metropolis-Hastings sweep loop for Hopper (sm_90a),
// every tile target outside K1 (kernel K2).
//
// Replaces the TPU kernel smcdet_tpu/ops/pallas_sweep.py:_make_kernel in its
// remaining tile-target specializations: Gaussian noise, or Poisson noise
// with a Normal tail above normal_tail; Gaussian PSF, SDSS PSF with the
// beta = 3 wing, or SDSS PSF with the general wing (1 + r2/(beta sp))^(-beta/2);
// Pareto / truncated Pareto, Normal or no flux prior; 8x8 and 16x16 tiles
// with up to 16 slots. No aggregation child term (that is kernel K3).
//
// What bounds it on this card: FP32 and SFU work, as in K1. Each update
// renders the old and the proposed star over every pixel and evaluates the
// likelihood of the proposed rate (one logf per pixel, and a division or a
// lgamma-free Poisson term). A 16x16 rate cache (1 KiB per particle) does not
// fit in one thread's registers, which is what K1's design needs.
//
// Design: L lanes per particle (L = 8 for 8x8, a whole warp for 16x16), each
// lane holding HW / L = 8 pixels of the rate cache in registers (pixel
// p = lane + L * k, so the cache loads and stores are coalesced). Every lane
// of a particle draws the same Philox words and does the same scalar work
// (the slot choice, the truncated-normal proposals, the accept test), which
// costs a SIMT lane nothing extra; the pixel log-likelihood is summed by a
// __shfl_xor_sync butterfly, which leaves the bit-identical total in every
// lane, so every lane takes the same accept decision. The catalog (slot
// locations and fluxes) sits in shared memory, read by slot index and written
// by the particle's first lane on accept. A block of 256 threads shares one
// group (one image, one temperature): the image and, for Poisson noise,
// lgamma(image + 1) are staged in shared memory once per launch, as the TPU
// kernel precomputes lgamma outside its body. The noise, PSF and flux-prior
// variants are branches that are uniform across the grid.
//
// Random numbers and arithmetic are K1's (mh_common.cuh): Philox4x32-10
// keyed by the per-call key with the counter (particle, sweep, draw,
// particle >> 32), so the stream is that of the plain PyTorch version
// (ops/mh_sweep.py), and the two agree particle by particle up to the
// library's expf/logf/powf/lgammaf rounding and the order of the pixel sum.
// The tile model (PSF, pixel likelihood, flux prior) is in mh_pixel.cuh,
// shared with K3.

#include "mh_common.cuh"
#include "mh_pixel.cuh"

namespace {

using namespace smcdet;

constexpr int kBlock = 256;
constexpr int kMaxSlots = 16;

template <int H, int W, int L>
__global__ void __launch_bounds__(kBlock)
mh_sweep_k2_kernel(const int64_t* __restrict__ key,
                   const float* __restrict__ image,
                   const float* __restrict__ temperature,
                   const int32_t* __restrict__ counts,
                   const float* __restrict__ locs_in,
                   const float* __restrict__ fluxes_in,
                   const float* __restrict__ rate_in,
                   const float* __restrict__ pll_in,
                   const float* __restrict__ lp_in,
                   float* __restrict__ locs_out,
                   float* __restrict__ fluxes_out,
                   float* __restrict__ rate_out, float* __restrict__ pll_out,
                   float* __restrict__ lp_out, float* __restrict__ acc_out,
                   int N, int M, int num_iters, K2Params P) {
  constexpr int HW = H * W;
  constexpr int PPL = HW / L;        // pixels per lane
  constexpr int PPB = kBlock / L;    // particles per block
  static_assert(HW % L == 0 && 32 % L == 0, "L must divide HW and 32");
  extern __shared__ float smem[];
  float* s_img = smem;                 // [HW]
  float* s_lg = smem + HW;             // [HW] lgamma(image + 1), Poisson
  float* s_cat = smem + 2 * HW;        // [PPB][M][3]: y, x, flux

  const int g = blockIdx.x;
  for (int p = threadIdx.x; p < HW; p += blockDim.x) {
    const float v = image[(int64_t)g * HW + p];
    s_img[p] = v;
    s_lg[p] = P.noise_kind == 1 ? lgammaf(v + 1.f) : 0.f;
  }

  const int local = threadIdx.x / L;  // particle within the block
  const int lane = threadIdx.x % L;   // lane within the particle
  const int n = blockIdx.y * PPB + local;
  const bool valid = n < N;
  const int64_t pid = (int64_t)g * N + n;
  const int count = valid ? counts[pid] : 0;
  float* cat = s_cat + local * M * 3;
  if (valid) {
    for (int m = lane; m < M; m += L) {
      cat[m * 3] = locs_in[(pid * M + m) * 2];
      cat[m * 3 + 1] = locs_in[(pid * M + m) * 2 + 1];
      cat[m * 3 + 2] = fluxes_in[pid * M + m];
    }
  }
  float rate[PPL], rate_prop[PPL];
#pragma unroll
  for (int k = 0; k < PPL; ++k) {
    rate[k] = valid ? rate_in[pid * HW + lane + L * k] : 0.f;
  }
  float pll = valid ? pll_in[pid] : 0.f;
  float lp = valid ? lp_in[pid] : 0.f;
  __syncthreads();

  const uint32_t k0 = (uint32_t)key[0];
  const uint32_t k1 = (uint32_t)key[1];
  const float tau = temperature[g];
  const bool active = count > 0;
  const float count_f = (float)count;
  int accepted = 0;
  // A particle with no occupied slot never moves (its proposals are not
  // applied), so it passes through bit-exactly; a warp of such particles
  // skips the loop. Every lane of a warp runs the same number of sweeps, so
  // the warp-wide shuffles and __syncwarp below are safe.
  const int iters = __all_sync(0xffffffffu, !active) ? 0 : num_iters;
  for (int it = 0; it < iters; ++it) {
    uint32_t r0[4] = {(uint32_t)pid, (uint32_t)it, 0u, (uint32_t)(pid >> 32)};
    uint32_t r1[4] = {(uint32_t)pid, (uint32_t)it, 1u, (uint32_t)(pid >> 32)};
    philox4x32_10(r0, k0, k1);
    philox4x32_10(r1, k0, k1);
    const float u_j = unit_uniform(r0[0]);
    const float u_acc = unit_uniform(r1[0]);

    // uniform slot over the occupied prefix 0..count-1
    const int j = max(min((int)floorf(u_j * count_f), count - 1), 0);
    const float ly_j = active ? cat[j * 3] : 0.f;
    const float lx_j = active ? cat[j * 3 + 1] : 0.f;
    const float f_j = active ? cat[j * 3 + 2] : 0.f;

    float mass_y, mass_x, mass_f;
    const float y_prop = tn_sample(unit_uniform(r0[1]), ly_j, P.locs_stdev,
                                   P.loc_low_y, P.loc_high_y, &mass_y);
    const float x_prop = tn_sample(unit_uniform(r0[2]), lx_j, P.locs_stdev,
                                   P.loc_low_x, P.loc_high_x, &mass_x);
    const float f_prop = tn_sample(unit_uniform(r0[3]), f_j, P.fluxes_stdev,
                                   P.flux_lo, P.flux_hi, &mass_f);

    // incremental rate update of this lane's pixels and their likelihood
    const float fy_old = floorf(ly_j), fx_old = floorf(lx_j);
    const float fy_new = floorf(y_prop), fx_new = floorf(x_prop);
    float pll_prop = 0.f;
#pragma unroll
    for (int k = 0; k < PPL; ++k) {
      const int p = lane + L * k;
      const float psi_old = star_pixel<W>(p, ly_j, lx_j, fy_old, fx_old, P);
      const float psi_new = star_pixel<W>(p, y_prop, x_prop, fy_new, fx_new, P);
      const float d = P.adu * (f_prop * psi_new - f_j * psi_old);
      const float rp = rate[k] + d;
      rate_prop[k] = rp;
      pll_prop += pixel_loglik(s_img[p], s_lg[p], rp, P);
    }
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1) {
      pll_prop += __shfl_xor_sync(0xffffffffu, pll_prop, off);
    }
    const float lp_prop =
        lp + (flux_log_prob(f_prop, P) - flux_log_prob(f_j, P));

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
    if (active && u_acc <= expf(capped)) {
      if (lane == 0) {
        cat[j * 3] = y_prop;
        cat[j * 3 + 1] = x_prop;
        cat[j * 3 + 2] = f_prop;
      }
#pragma unroll
      for (int k = 0; k < PPL; ++k) rate[k] = rate_prop[k];
      pll = pll_prop;
      lp = lp_prop;
      ++accepted;
    }
    __syncwarp();  // the slot write is seen by every lane's next read
  }

  if (!valid) return;
  for (int m = lane; m < M; m += L) {
    locs_out[(pid * M + m) * 2] = cat[m * 3];
    locs_out[(pid * M + m) * 2 + 1] = cat[m * 3 + 1];
    fluxes_out[pid * M + m] = cat[m * 3 + 2];
  }
#pragma unroll
  for (int k = 0; k < PPL; ++k) rate_out[pid * HW + lane + L * k] = rate[k];
  if (lane == 0) {
    pll_out[pid] = pll;
    lp_out[pid] = lp;
    acc_out[pid] = (float)accepted / (float)num_iters;
  }
}

template <int H, int W, int L>
cudaError_t launch(const int64_t* key, const float* image,
                   const float* temperature, const int32_t* counts,
                   const float* locs_in, const float* fluxes_in,
                   const float* rate_in, const float* pll_in,
                   const float* lp_in, float* locs_out, float* fluxes_out,
                   float* rate_out, float* pll_out, float* lp_out,
                   float* acc_out, int G, int N, int M, int num_iters,
                   const K2Params& P, cudaStream_t stream) {
  constexpr int PPB = kBlock / L;
  const dim3 grid(G, (N + PPB - 1) / PPB);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (2 * H * W + PPB * M * 3);
  mh_sweep_k2_kernel<H, W, L><<<grid, kBlock, smem, stream>>>(
      key, image, temperature, counts, locs_in, fluxes_in, rate_in, pll_in,
      lp_in, locs_out, fluxes_out, rate_out, pll_out, lp_out, acc_out, N, M,
      num_iters, P);
  return cudaGetLastError();
}

}  // namespace

// Launch K2 on `stream`. Tensors are contiguous: image [G, H*W],
// temperature [G], counts [G, N] int32, locs [G, N, M, 2], fluxes [G, N, M],
// rate [G, N, H*W], pll / lp / acc [G, N], key int64 [2]. Returns the CUDA
// error of the launch (0 on success); H x W must be 8x8 or 16x16 and
// 1 <= M <= 16.
extern "C" int smcdet_mh_sweeps_k2_launch(
    const void* key, const void* image, const void* temperature,
    const void* counts, const void* locs_in, const void* fluxes_in,
    const void* rate_in, const void* pll_in, const void* lp_in,
    void* locs_out, void* fluxes_out, void* rate_out, void* pll_out,
    void* lp_out, void* acc_out, int G, int N, int M, int H, int W,
    int num_iters, K2Params params, void* stream) {
  if (G <= 0 || N <= 0 || num_iters <= 0 || M < 1 || M > kMaxSlots) {
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
  if (H == 8 && W == 8) {
    return (int)launch<8, 8, 8>(k, img, tmp, cnt, li, fi, ri, pi, lpi, lo, fo,
                                ro, po, lpo, ao, G, N, M, num_iters, params,
                                s);
  }
  if (H == 16 && W == 16) {
    return (int)launch<16, 16, 32>(k, img, tmp, cnt, li, fi, ri, pi, lpi, lo,
                                   fo, ro, po, lpo, ao, G, N, M, num_iters,
                                   params, s);
  }
  return (int)cudaErrorInvalidValue;
}
