// Fused single-component MALA sweep loop for Hopper (sm_90a), the tile and
// the aggregation bridge targets (kernel K4).
//
// Replaces the TPU kernel smcdet_tpu/ops/pallas_sweep.py:_make_mala_kernel
// (reached through pallas_mala_sweeps). Per sweep and particle, one occupied
// slot j moves: its location and flux are drawn from normals truncated to the
// prior's box around the drifted means x + step^2 / 2 * grad, with the slot
// target's gradient in closed form,
//   dG/df  = flux_lp'(f) + sum_px g adu psi,
//   dG/dly = sum_px g adu f dpsi/dr2 (-2 dy)   (and lx with dx),
// g = tau dll/drate(rate), plus (1 - tau) dll/drate(child rate) w on the
// bridge (w the star's child window); the move is accepted with the tempered
// ratio that carries both truncated-normal proposal densities. The target is
// lp + tau pll on a tile and lp + tau pll + (1 - tau) cll on the bridge (the
// child window of the slot's origin tag, or of the side of the star's
// location, as in K3). Every noise, PSF and flux-prior variant of K2
// (mh_pixel.cuh); the tile target on 8x8 and 16x16 tiles with up to 16 slots,
// the bridge on the joined 16x8 (up to 16 slots) and 16x16 (up to 32) tiles.
//
// What bounds it on this card: FP32 and SFU work. An update evaluates the PSF
// and its derivative at the current and the proposed location over every
// pixel, dll/drate at both (one division each, two on the bridge), and the
// likelihood at the proposal (one logf per pixel and term), so it needs
// about twice K2's (or K3's) work per pixel.
//
// Design: K2's and K3's layout. L lanes per particle (8 on 8x8, 16 on the
// 16x8 bridge, a whole warp on 16x16), each lane holding HW / L = 8 pixels of
// the rate cache (and on the bridge the child rate) in registers, pixel
// p = lane + L * k. The first pixel pass removes the star from the caches
// (kept in the proposal arrays) and sums the lane's three forward gradient
// terms; one __shfl_xor_sync butterfly sums all three. The second pass adds
// the proposed star, sums the likelihood(s) at the proposal and the three
// reverse gradient terms; one more butterfly sums those four (five on the
// bridge). A butterfly leaves the bit-identical totals in every lane, so
// every lane draws the same proposal and takes the same accept decision. The
// catalog sits in shared memory (room for 32 slots), lgamma(image + 1) is
// staged once per block, the tags ride as one 32-bit mask per particle, and
// noise, PSF and flux prior are grid-uniform branches. Padded particles
// (n >= N) start from rate = child rate = 1 and never move.
//
// Random numbers are K1-K3's (mh_common.cuh): Philox4x32-10 keyed by the
// per-call key with the counter (particle, sweep, draw, particle >> 32); draw
// 0 gives the slot, y, x and flux uniforms, draw 1 the accept uniform. The
// plain PyTorch version (ops/mala_sweep.py) draws the same stream. MALA's
// drift amplifies a last-bit difference over the sweeps, so the two are
// kept bit-close where they can be: this file is compiled with -fmad=false
// (_build.py: SOURCE_FLAGS), so every multiply and add rounds on its own as
// the plain version's separate tensor ops do; the plain version sums the
// pixels in this kernel's lane order (ops/mala_sweep.py: lane_sum); and the
// truncated normal's Phi is the plain version's formula (phi_cdf). What
// differs is the inverse CDF (normcdfinvf against torch's ndtri) and the
// rounding inside the library functions.

#include "mh_common.cuh"
#include "mh_pixel.cuh"

// The parameters, passed by value; mirrored by ops/mh_sweep.py:_K3Params.
// The MALA steps ride in base.locs_stdev / base.fluxes_stdev; child_axis is
// -1 on the tile target.
struct K4Params {
  K2Params base;
  float boundary;     // pixels with coord < boundary form the even child
  int child_axis;     // 0: the children split the rows, 1: the columns
  int side_from_tag;  // 1: slot origin tags, 0: the side of the location
};

namespace {

using namespace smcdet;

constexpr int kBlock = 256;
constexpr int kMaxSlots = 32;

// Phi as the plain version computes it: torch.special.ndtr is
// (1 + erf(z / sqrt(2))) / 2. A drift far outside the box leaves a
// truncation mass of a few ulps of 1, the difference of two values of Phi
// near 1; computed alike, the kernel's and the plain version's masses round
// alike there, where K1-K3's normcdff and torch's ndtr differ by whole ulps
// and their logs by nats.
__device__ __forceinline__ float phi_cdf(float z) {
  return (1.f + erff(z * 0.70710678118654752f)) * 0.5f;
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

template <int H, int W, int L, bool CHILD>
__global__ void __launch_bounds__(kBlock)
mala_sweep_k4_kernel(const int64_t* __restrict__ key,
                     const float* __restrict__ image,
                     const float* __restrict__ temperature,
                     const int32_t* __restrict__ counts,
                     const float* __restrict__ locs_in,
                     const float* __restrict__ fluxes_in,
                     const float* __restrict__ rate_in,
                     const float* __restrict__ pll_in,
                     const float* __restrict__ lp_in,
                     const float* __restrict__ crate_in,
                     const float* __restrict__ cll_in,
                     const int64_t* __restrict__ tags,
                     float* __restrict__ locs_out,
                     float* __restrict__ fluxes_out,
                     float* __restrict__ rate_out,
                     float* __restrict__ pll_out, float* __restrict__ lp_out,
                     float* __restrict__ acc_out,
                     float* __restrict__ crate_out,
                     float* __restrict__ cll_out, int N, int M,
                     int num_iters, K4Params Q) {
  constexpr int HW = H * W;
  constexpr int PPL = HW / L;      // pixels per lane
  constexpr int PPB = kBlock / L;  // particles per block
  static_assert(HW % L == 0 && 32 % L == 0, "L must divide HW and 32");
  static_assert(PPL <= 32, "one bit per pixel of a lane");
  const K2Params& P = Q.base;
  extern __shared__ float smem[];
  float* s_img = smem;           // [HW]
  float* s_lg = smem + HW;       // [HW] lgamma(image + 1), Poisson
  float* s_cat = smem + 2 * HW;  // [PPB][M][3]: y, x, flux

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
  const uint32_t side_bits =
      (CHILD && valid && Q.side_from_tag) ? (uint32_t)tags[pid] : 0u;
  float* cat = s_cat + local * M * 3;
  if (valid) {
    for (int m = lane; m < M; m += L) {
      cat[m * 3] = locs_in[(pid * M + m) * 2];
      cat[m * 3 + 1] = locs_in[(pid * M + m) * 2 + 1];
      cat[m * 3 + 2] = fluxes_in[pid * M + m];
    }
  }
  // the caches, and the caches at the proposal (first the star-removed ones)
  float rate[PPL], rate_prop[PPL];
  float crate[CHILD ? PPL : 1], crate_prop[CHILD ? PPL : 1];
  uint32_t even_bits = 0;  // bit k: pixel lane + L k is in the even child
#pragma unroll
  for (int k = 0; k < PPL; ++k) {
    const int p = lane + L * k;
    rate[k] = valid ? rate_in[pid * HW + p] : 1.f;
    if constexpr (CHILD) {
      crate[k] = valid ? crate_in[pid * HW + p] : 1.f;
      const int coord = Q.child_axis == 0 ? p / W : p % W;
      even_bits |= ((float)coord < Q.boundary ? 1u : 0u) << k;
    }
  }
  float pll = valid ? pll_in[pid] : 0.f;
  float cll = (CHILD && valid) ? cll_in[pid] : 0.f;
  float lp = valid ? lp_in[pid] : 0.f;
  __syncthreads();

  const uint32_t k0 = (uint32_t)key[0];
  const uint32_t k1 = (uint32_t)key[1];
  const float tau = temperature[g];
  const float one_minus_tau = 1.f - tau;
  const bool active = count > 0;
  const float count_f = (float)count;
  const float aeff = active ? P.adu : 0.f;
  const float ls = P.locs_stdev, fs = P.fluxes_stdev;
  const float half_ls2 = (0.5f * ls) * ls;
  const float half_fs2 = (0.5f * fs) * fs;
  const float log_ls = logf(ls), log_fs = logf(fs);
  int accepted = 0;
  // As in K2 and K3: a particle with no occupied slot never moves and passes
  // through bit-exactly; a warp of such particles skips the loop, and every
  // lane of a warp runs the same number of sweeps, so the shuffles and
  // __syncwarp below see the whole warp.
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
    // an inactive particle proposes from the flux floor (never applied)
    const float f_safe = active ? f_j : P.flux_lo;
    const float af_old = aeff * f_safe;

    bool side_old = false;
    if constexpr (CHILD) {
      side_old = Q.side_from_tag
                     ? (bool)((side_bits >> j) & 1u)
                     : (Q.child_axis == 0 ? ly_j : lx_j) <= Q.boundary;
    }

    // pass 1: remove the star from the caches, and the forward gradient
    // sums at the current point (the cached full rates)
    const float fy_old = floorf(ly_j), fx_old = floorf(lx_j);
    float sy = 0.f, sx = 0.f, sf = 0.f;
#pragma unroll
    for (int k = 0; k < PPL; ++k) {
      const int p = lane + L * k;
      float psi, dpsi, dy, dx;
      star_pixel_deriv<W>(p, ly_j, lx_j, fy_old, fx_old, P, &psi, &dpsi, &dy,
                          &dx);
      float gk = tau * pixel_dll_drate(s_img[p], rate[k], P);
      rate_prop[k] = rate[k] - af_old * psi;
      if constexpr (CHILD) {
        const bool w = (bool)((even_bits >> k) & 1u) == side_old;
        if (w) {
          gk += one_minus_tau * pixel_dll_drate(s_img[p], crate[k], P);
        }
        crate_prop[k] = crate[k] - (w ? af_old * psi : 0.f);
      }
      const float gd = gk * dpsi;
      sy += gd * (-2.f * dy);
      sx += gd * (-2.f * dx);
      sf += gk * psi;
    }
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1) {
      sy += __shfl_xor_sync(0xffffffffu, sy, off);
      sx += __shfl_xor_sync(0xffffffffu, sx, off);
      sf += __shfl_xor_sync(0xffffffffu, sf, off);
    }
    const float gf =
        sf * aeff + (active ? flux_log_prob_grad(f_safe, P) : 0.f);
    const float mu_y = ly_j + half_ls2 * (sy * af_old);
    const float mu_x = lx_j + half_ls2 * (sx * af_old);
    const float mu_f = f_safe + half_fs2 * gf;

    float mass_y, mass_x, mass_f;
    const float y_prop = box_sample(unit_uniform(r0[1]), mu_y, ls,
                                    P.loc_low_y, P.loc_high_y, &mass_y);
    const float x_prop = box_sample(unit_uniform(r0[2]), mu_x, ls,
                                    P.loc_low_x, P.loc_high_x, &mass_x);
    const float f_prop = box_sample(unit_uniform(r0[3]), mu_f, fs, P.flux_lo,
                                    P.flux_hi, &mass_f);
    const float af_new = aeff * f_prop;
    bool side_new = side_old;
    if (CHILD && !Q.side_from_tag) {  // location mode: the proposal's side
      side_new = (Q.child_axis == 0 ? y_prop : x_prop) <= Q.boundary;
    }

    // pass 2: add the proposed star, the likelihood(s) at the proposal and
    // the reverse gradient sums there
    const float fy_new = floorf(y_prop), fx_new = floorf(x_prop);
    float pll_prop = 0.f, cll_prop = 0.f;
    float ry = 0.f, rx = 0.f, rf = 0.f;
#pragma unroll
    for (int k = 0; k < PPL; ++k) {
      const int p = lane + L * k;
      float psi, dpsi, dy, dx;
      star_pixel_deriv<W>(p, y_prop, x_prop, fy_new, fx_new, P, &psi, &dpsi,
                          &dy, &dx);
      const float rp = rate_prop[k] + af_new * psi;
      rate_prop[k] = rp;
      pll_prop += pixel_loglik(s_img[p], s_lg[p], rp, P);
      float gk = tau * pixel_dll_drate(s_img[p], rp, P);
      if constexpr (CHILD) {
        const bool w = (bool)((even_bits >> k) & 1u) == side_new;
        const float crp = crate_prop[k] + (w ? af_new * psi : 0.f);
        crate_prop[k] = crp;
        cll_prop += pixel_loglik(s_img[p], s_lg[p], crp, P);
        if (w) gk += one_minus_tau * pixel_dll_drate(s_img[p], crp, P);
      }
      const float gd = gk * dpsi;
      ry += gd * (-2.f * dy);
      rx += gd * (-2.f * dx);
      rf += gk * psi;
    }
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1) {
      pll_prop += __shfl_xor_sync(0xffffffffu, pll_prop, off);
      ry += __shfl_xor_sync(0xffffffffu, ry, off);
      rx += __shfl_xor_sync(0xffffffffu, rx, off);
      rf += __shfl_xor_sync(0xffffffffu, rf, off);
      if constexpr (CHILD) {
        cll_prop += __shfl_xor_sync(0xffffffffu, cll_prop, off);
      }
    }
    const float lp_prop =
        lp + (active ? flux_log_prob(f_prop, P) - flux_log_prob(f_safe, P)
                     : 0.f);
    const float gf_r =
        rf * aeff + (active ? flux_log_prob_grad(f_prop, P) : 0.f);
    const float mu_y_r = y_prop + half_ls2 * (ry * af_new);
    const float mu_x_r = x_prop + half_ls2 * (rx * af_new);
    const float mu_f_r = f_prop + half_fs2 * gf_r;

    // the two proposal densities; the forward masses come from the sampling
    const float log_q_fwd =
        (tn_log_q(y_prop, mu_y, ls, log_ls, mass_y) +
         tn_log_q(x_prop, mu_x, ls, log_ls, mass_x)) +
        tn_log_q(f_prop, mu_f, fs, log_fs, mass_f);
    const float log_q_rev =
        (tn_log_q(ly_j, mu_y_r, ls, log_ls,
                  box_mass(mu_y_r, ls, P.loc_low_y, P.loc_high_y)) +
         tn_log_q(lx_j, mu_x_r, ls, log_ls,
                  box_mass(mu_x_r, ls, P.loc_low_x, P.loc_high_x))) +
        tn_log_q(f_safe, mu_f_r, fs, log_fs,
                 box_mass(mu_f_r, fs, P.flux_lo, P.flux_hi));
    float target_old = lp + tau * pll;
    float target_new = lp_prop + tau * pll_prop;
    if constexpr (CHILD) {
      target_old += one_minus_tau * cll;
      target_new += one_minus_tau * cll_prop;
    }
    const float log_alpha = ((target_new - target_old) + log_q_rev) - log_q_fwd;
    // NaN-propagating min(log_alpha, 0): a NaN target never accepts
    const float capped = log_alpha > 0.f ? 0.f : log_alpha;
    if (active && u_acc <= expf(capped)) {
      if (lane == 0) {
        cat[j * 3] = y_prop;
        cat[j * 3 + 1] = x_prop;
        cat[j * 3 + 2] = f_prop;
      }
#pragma unroll
      for (int k = 0; k < PPL; ++k) {
        rate[k] = rate_prop[k];
        if constexpr (CHILD) crate[k] = crate_prop[k];
      }
      pll = pll_prop;
      cll = cll_prop;
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
  for (int k = 0; k < PPL; ++k) {
    rate_out[pid * HW + lane + L * k] = rate[k];
    if constexpr (CHILD) crate_out[pid * HW + lane + L * k] = crate[k];
  }
  if (lane == 0) {
    pll_out[pid] = pll;
    lp_out[pid] = lp;
    acc_out[pid] = (float)accepted / (float)num_iters;
    if constexpr (CHILD) cll_out[pid] = cll;
  }
}

struct Buffers {
  const int64_t* key;
  const float *image, *temperature;
  const int32_t* counts;
  const float *locs_in, *fluxes_in, *rate_in, *pll_in, *lp_in, *crate_in,
      *cll_in;
  const int64_t* tags;
  float *locs_out, *fluxes_out, *rate_out, *pll_out, *lp_out, *acc_out,
      *crate_out, *cll_out;
};

template <int H, int W, int L, bool CHILD>
cudaError_t launch(const Buffers& b, int G, int N, int M, int num_iters,
                   const K4Params& Q, cudaStream_t stream) {
  constexpr int PPB = kBlock / L;
  const dim3 grid(G, (N + PPB - 1) / PPB);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (2 * H * W + PPB * M * 3);
  mala_sweep_k4_kernel<H, W, L, CHILD><<<grid, kBlock, smem, stream>>>(
      b.key, b.image, b.temperature, b.counts, b.locs_in, b.fluxes_in,
      b.rate_in, b.pll_in, b.lp_in, b.crate_in, b.cll_in, b.tags,
      b.locs_out, b.fluxes_out, b.rate_out, b.pll_out, b.lp_out, b.acc_out,
      b.crate_out, b.cll_out, N, M, num_iters, Q);
  return cudaGetLastError();
}

}  // namespace

// Launch K4 on `stream`. Tensors are contiguous: image [G, H*W],
// temperature [G], counts [G, N] int32, locs [G, N, M, 2], fluxes [G, N, M],
// rate [G, N, H*W], pll / lp / acc [G, N], key int64 [2]; on the bridge
// (child_axis 0 or 1) also the child rate [G, N, H*W], the child ll [G, N]
// and the origin tags int64 [G, N] (bit m = slot m's tag; null in location
// mode), which are null on the tile target (child_axis -1). Returns the CUDA
// error of the launch (0 on success); the tile target takes 8x8 and 16x16
// with 1 <= M <= 16, the bridge 16x8 with 1 <= M <= 16 and 16x16 with
// 1 <= M <= 32.
extern "C" int smcdet_mala_sweeps_k4_launch(
    const void* key, const void* image, const void* temperature,
    const void* counts, const void* locs_in, const void* fluxes_in,
    const void* rate_in, const void* pll_in, const void* lp_in,
    const void* crate_in, const void* cll_in, const void* tags,
    void* locs_out, void* fluxes_out, void* rate_out, void* pll_out,
    void* lp_out, void* acc_out, void* crate_out, void* cll_out, int G,
    int N, int M, int H, int W, int num_iters, K4Params params,
    void* stream) {
  const bool child = params.child_axis >= 0;
  if (G <= 0 || N <= 0 || num_iters <= 0 || M < 1 || M > kMaxSlots ||
      params.child_axis > 1 ||
      (child && (crate_in == nullptr || cll_in == nullptr ||
                 crate_out == nullptr || cll_out == nullptr ||
                 (params.side_from_tag && tags == nullptr)))) {
    return (int)cudaErrorInvalidValue;
  }
  const Buffers b{
      static_cast<const int64_t*>(key),
      static_cast<const float*>(image),
      static_cast<const float*>(temperature),
      static_cast<const int32_t*>(counts),
      static_cast<const float*>(locs_in),
      static_cast<const float*>(fluxes_in),
      static_cast<const float*>(rate_in),
      static_cast<const float*>(pll_in),
      static_cast<const float*>(lp_in),
      static_cast<const float*>(crate_in),
      static_cast<const float*>(cll_in),
      static_cast<const int64_t*>(tags),
      static_cast<float*>(locs_out),
      static_cast<float*>(fluxes_out),
      static_cast<float*>(rate_out),
      static_cast<float*>(pll_out),
      static_cast<float*>(lp_out),
      static_cast<float*>(acc_out),
      static_cast<float*>(crate_out),
      static_cast<float*>(cll_out),
  };
  auto s = static_cast<cudaStream_t>(stream);
  if (!child) {
    if (M > 16) return (int)cudaErrorInvalidValue;
    if (H == 8 && W == 8) {
      return (int)launch<8, 8, 8, false>(b, G, N, M, num_iters, params, s);
    }
    if (H == 16 && W == 16) {
      return (int)launch<16, 16, 32, false>(b, G, N, M, num_iters, params, s);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (H == 16 && W == 8 && M <= 16) {
    return (int)launch<16, 8, 16, true>(b, G, N, M, num_iters, params, s);
  }
  if (H == 16 && W == 16) {
    return (int)launch<16, 16, 32, true>(b, G, N, M, num_iters, params, s);
  }
  return (int)cudaErrorInvalidValue;
}
