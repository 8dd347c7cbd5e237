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
// What bounds it on this card: instruction issue, as in K2. An update
// evaluates the PSF and its derivative at the current and the proposed
// location over every pixel, dll/drate at both, and the likelihood at the
// proposal (one logf per pixel and term), about twice K2's (or K3's) work per
// pixel, and a scalar part larger than K2's: three truncated-normal samples
// around the drifted means, three reverse box masses, six proposal
// log-densities, the flux prior and its gradient at both fluxes.
//
// Design: K2's layout and its four means of keeping a warp's issue slots on
// the pixels (mh_sweep_k2.cu). L lanes per particle (kLanes* below, chosen
// by time on the H100), each lane holding HW / L pixels of the rate cache
// (and on the bridge the child rate) in registers, pixel p = lane + L * k.
//
// - The first pixel pass removes the star from the caches (kept in the
//   proposal arrays) and sums the lane's three forward gradient terms; one
//   __shfl_xor_sync butterfly sums them. The second pass adds the proposed
//   star, sums the likelihood(s) at the proposal and the three reverse
//   gradient terms; one more butterfly sums those four (five on the bridge).
//   A butterfly leaves the bit-identical totals in every lane.
// - The scalar part is split across the particle's lanes: lane c < 3 takes
//   coordinate c (y, x, flux; lanes above 2 repeat the flux), draws its one
//   truncated-normal sample around its drifted mean, and after the second
//   butterfly works out its reverse drifted mean, that mean's box mass and
//   both of its proposal log-densities; even lanes take the flux prior at the
//   proposed flux and odd lanes at the current one. __shfl_sync inside the
//   lane group hands the proposals and the terms to every lane, which add
//   them in the plain version's order, so every lane takes the same accept
//   decision.
// - The Philox words are drawn ahead: lane 2 s + d draws word set d of sweep
//   base + s for the next L / 2 sweeps, and each sweep fetches its five
//   uniforms by shuffle.
// - No IEEE division by a launch constant on the pixel path: the PSF's
//   widths and normalisers are reciprocals worked out once per thread
//   (mh_pixel.cuh: PsfRecip), the wing's derivative multiplies by 1 / q from
//   the rsqrt that gives the wing (beta = 3), and the likelihood and its
//   derivative at a pixel share one reciprocal of the variance or rate.
// - One instantiation per noise and PSF kind (launch_kinds), so the unrolled
//   pixel passes carry no branch on them.
//
// The catalog sits in shared memory (room for 32 slots), lgamma(image + 1) is
// staged once per block, the tags ride as one 32-bit mask per particle, and
// the flux prior is a grid-uniform branch. Padded particles (n >= N) start
// from rate = child rate = 1 and never move; a particle with no occupied
// slot never moves; every lane of a warp runs the same sweeps, so every
// shuffle sees all its lanes.
//
// Random numbers are K1-K3's (mh_common.cuh): Philox4x32-10 keyed by the
// per-call key with the counter (particle, sweep, draw, particle >> 32); draw
// 0 gives the slot, y, x and flux uniforms, draw 1 the accept uniform. The
// plain PyTorch version (ops/mala_sweep.py) draws the same stream. MALA's
// drift amplifies a last-bit difference over the sweeps, so the two are
// kept bit-close where they can be: this file is compiled with -fmad=false
// (_build.py: SOURCE_FLAGS), so every multiply and add rounds on its own as
// the plain version's separate tensor ops do; the plain version sums the
// pixels in this kernel's lane order (ops/mala_sweep.py: lane_sum, with the
// lane counts of K4_LANES) and works out the same reciprocals; and the
// truncated normal's Phi is the plain version's formula (phi_cdf). What
// differs is the inverse CDF (normcdfinvf against torch's ndtri) and the
// rounding inside the library functions.

#include "mala_common.cuh"
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
// Lanes per particle on each target, as timed on the H100 at the launch
// shapes of the paths (PERF.md); ops/mala_sweep.py: K4_LANES mirrors them.
constexpr int kLanes8x8 = 4;
constexpr int kLanes16x16 = 16;
constexpr int kLanesBridge16x8 = 16;
constexpr int kLanesBridge16x16 = 32;
// Blocks per SM that __launch_bounds__ asks ptxas to leave room for: two
// blocks of 256 threads hold every instantiation at 128 registers or fewer.
constexpr int kMinBlocks = 2;
constexpr unsigned kFull = 0xffffffffu;

// NOISE and PSF fix K2Params' noise_kind and psf_kind at compile time.
template <int H, int W, int L, bool CHILD, int NOISE, int PSF>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
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
                     int num_iters, const K4Params Q) {
  constexpr int HW = H * W;
  constexpr int PPL = HW / L;        // pixels per lane
  constexpr int PPB = kBlock / L;    // particles per block
  constexpr int AHEAD = L / 2;       // sweeps per Philox draw-ahead
  static_assert(HW % L == 0 && 32 % L == 0 && L >= 4 &&
                    (W % L == 0 || L % W == 0),
                "L must divide HW and 32, hold the three proposals, and "
                "divide the row or be a multiple of it");
  static_assert(PPL <= 32, "one bit per pixel of a lane");
  K2Params P = Q.base;
  P.noise_kind = NOISE;
  P.psf_kind = PSF;
  const PsfRecip R = psf_recip(P);
  // the wing's derivative factor -1 / (2 sp) (SDSS PSF only)
  const float wd = PSF == 0 ? 0.f : -1.f / (2.f * P.sp);
  extern __shared__ float smem[];
  float* s_img = smem;           // [HW]
  float* s_lg = smem + HW;       // [HW] lgamma(image + 1), Poisson
  float* s_cat = smem + 2 * HW;  // [PPB][M][3]: y, x, flux

  const int g = blockIdx.x;
  for (int p = threadIdx.x; p < HW; p += blockDim.x) {
    const float v = image[(int64_t)g * HW + p];
    s_img[p] = v;
    s_lg[p] = NOISE == 1 ? lgammaf(v + 1.f) : 0.f;
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
      float h, w;
      pixel_rc<W, L>(lane, k, &h, &w);
      const float coord = Q.child_axis == 0 ? h : w;
      even_bits |= (coord < Q.boundary ? 1u : 0u) << k;
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
  // this lane's coordinate: 0 y, 1 x, 2 flux (lanes above 2 repeat the
  // flux), with its step, half its squared step, the log of its step and its
  // box
  const int c = min(lane, 2);
  const float sigma_c = c < 2 ? ls : fs;
  const float half_c = (0.5f * sigma_c) * sigma_c;
  const float log_sigma_c = logf(sigma_c);
  const float lb_c = c == 0 ? P.loc_low_y : c == 1 ? P.loc_low_x : P.flux_lo;
  const float ub_c =
      c == 0 ? P.loc_high_y : c == 1 ? P.loc_high_x : P.flux_hi;
  int accepted = 0;
  // A particle with no occupied slot never moves and passes through
  // bit-exactly; a warp of such particles skips the loop, and every lane of
  // a warp runs the same number of sweeps, so the shuffles and __syncwarp
  // below see the whole warp.
  const int iters = __all_sync(kFull, !active) ? 0 : num_iters;
  for (int base = 0; base < iters; base += AHEAD) {
    // lane 2 s + d holds draw d of sweep base + s as four uniforms
    uint32_t r[4] = {(uint32_t)pid, (uint32_t)(base + (lane >> 1)),
                     (uint32_t)(lane & 1), (uint32_t)(pid >> 32)};
    philox4x32_10(r, k0, k1);
    const float w0 = unit_uniform(r[0]), w1 = unit_uniform(r[1]);
    const float w2 = unit_uniform(r[2]), w3 = unit_uniform(r[3]);
    const int batch = min(AHEAD, iters - base);
    for (int s = 0; s < batch; ++s) {
      const float u_j = __shfl_sync(kFull, w0, 2 * s, L);
      const float u_y = __shfl_sync(kFull, w1, 2 * s, L);
      const float u_x = __shfl_sync(kFull, w2, 2 * s, L);
      const float u_f = __shfl_sync(kFull, w3, 2 * s, L);
      const float u_acc = __shfl_sync(kFull, w0, 2 * s + 1, L);

      // uniform slot over the occupied prefix 0..count-1
      const int j = max(min((int)floorf(u_j * count_f), count - 1), 0);
      const float ly_j = active ? cat[j * 3] : 0.f;
      const float lx_j = active ? cat[j * 3 + 1] : 0.f;
      const float f_j = active ? cat[j * 3 + 2] : 0.f;
      // an inactive particle proposes from the flux floor (never applied)
      const float f_safe = active ? f_j : P.flux_lo;
      const float af_old = aeff * f_safe;
      const float v_c = c == 0 ? ly_j : c == 1 ? lx_j : f_safe;

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
        float h, w, psi, dpsi, dy, dx;
        pixel_rc<W, L>(lane, k, &h, &w);
        star_pixel_deriv_recip(h, w, ly_j, lx_j, fy_old, fx_old,
                               P.psf_radius, R, wd, &psi, &dpsi, &dy, &dx);
        const float img = s_img[p];
        float gk =
            tau * pixel_dll_recip(img, rate[k], noise_recip(rate[k], P), P);
        rate_prop[k] = rate[k] - af_old * psi;
        if constexpr (CHILD) {
          const bool win = (bool)((even_bits >> k) & 1u) == side_old;
          if (win) {
            gk += one_minus_tau *
                  pixel_dll_recip(img, crate[k], noise_recip(crate[k], P), P);
          }
          crate_prop[k] = crate[k] - (win ? af_old * psi : 0.f);
        }
        const float gd = gk * dpsi;
        sy += gd * (-2.f * dy);
        sx += gd * (-2.f * dx);
        sf += gk * psi;
      }
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1) {
        sy += __shfl_xor_sync(kFull, sy, off);
        sx += __shfl_xor_sync(kFull, sx, off);
        sf += __shfl_xor_sync(kFull, sf, off);
      }

      // lane c's drifted mean and its proposal; every lane gets the three
      const float grad_c =
          c == 0 ? sy * af_old
          : c == 1
              ? sx * af_old
              : sf * aeff + (active ? flux_log_prob_grad(f_safe, P) : 0.f);
      const float mu_c = v_c + half_c * grad_c;
      float mass_c;
      const float prop_c = box_sample(c == 0 ? u_y : c == 1 ? u_x : u_f,
                                      mu_c, sigma_c, lb_c, ub_c, &mass_c);
      const float y_prop = __shfl_sync(kFull, prop_c, 0, L);
      const float x_prop = __shfl_sync(kFull, prop_c, 1, L);
      const float f_prop = __shfl_sync(kFull, prop_c, 2, L);
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
        float h, w, psi, dpsi, dy, dx;
        pixel_rc<W, L>(lane, k, &h, &w);
        star_pixel_deriv_recip(h, w, y_prop, x_prop, fy_new, fx_new,
                               P.psf_radius, R, wd, &psi, &dpsi, &dy, &dx);
        const float img = s_img[p];
        const float rp = rate_prop[k] + af_new * psi;
        rate_prop[k] = rp;
        const float inv = noise_recip(rp, P);
        pll_prop += pixel_loglik_recip(img, s_lg[p], rp, inv, P);
        float gk = tau * pixel_dll_recip(img, rp, inv, P);
        if constexpr (CHILD) {
          const bool win = (bool)((even_bits >> k) & 1u) == side_new;
          const float crp = crate_prop[k] + (win ? af_new * psi : 0.f);
          crate_prop[k] = crp;
          const float cinv = noise_recip(crp, P);
          cll_prop += pixel_loglik_recip(img, s_lg[p], crp, cinv, P);
          if (win) gk += one_minus_tau * pixel_dll_recip(img, crp, cinv, P);
        }
        const float gd = gk * dpsi;
        ry += gd * (-2.f * dy);
        rx += gd * (-2.f * dx);
        rf += gk * psi;
      }
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1) {
        pll_prop += __shfl_xor_sync(kFull, pll_prop, off);
        ry += __shfl_xor_sync(kFull, ry, off);
        rx += __shfl_xor_sync(kFull, rx, off);
        rf += __shfl_xor_sync(kFull, rf, off);
        if constexpr (CHILD) {
          cll_prop += __shfl_xor_sync(kFull, cll_prop, off);
        }
      }

      // the flux prior at the proposed flux (even lanes) and the current one
      // (odd lanes)
      const float flp = flux_log_prob((lane & 1) ? f_safe : f_prop, P);
      const float flp_new = __shfl_sync(kFull, flp, 0, L);
      const float flp_old = __shfl_sync(kFull, flp, 1, L);
      const float lp_prop = lp + (active ? flp_new - flp_old : 0.f);
      // lane c's reverse drifted mean at the proposal, and its forward and
      // reverse proposal log-densities (the forward mass from the sampling)
      const float grad_r_c =
          c == 0 ? ry * af_new
          : c == 1
              ? rx * af_new
              : rf * aeff + (active ? flux_log_prob_grad(f_prop, P) : 0.f);
      const float mu_r_c = prop_c + half_c * grad_r_c;
      const float fwd_c = tn_log_q(prop_c, mu_c, sigma_c, log_sigma_c, mass_c);
      const float rev_c = tn_log_q(v_c, mu_r_c, sigma_c, log_sigma_c,
                                   box_mass(mu_r_c, sigma_c, lb_c, ub_c));
      const float log_q_fwd = (__shfl_sync(kFull, fwd_c, 0, L) +
                               __shfl_sync(kFull, fwd_c, 1, L)) +
                              __shfl_sync(kFull, fwd_c, 2, L);
      const float log_q_rev = (__shfl_sync(kFull, rev_c, 0, L) +
                               __shfl_sync(kFull, rev_c, 1, L)) +
                              __shfl_sync(kFull, rev_c, 2, L);
      float target_old = lp + tau * pll;
      float target_new = lp_prop + tau * pll_prop;
      if constexpr (CHILD) {
        target_old += one_minus_tau * cll;
        target_new += one_minus_tau * cll_prop;
      }
      const float log_alpha =
          ((target_new - target_old) + log_q_rev) - log_q_fwd;
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

template <int H, int W, int L, bool CHILD, int NOISE, int PSF>
cudaError_t launch(const Buffers& b, int G, int N, int M, int num_iters,
                   const K4Params& Q, cudaStream_t stream) {
  constexpr int PPB = kBlock / L;
  const dim3 grid(G, (N + PPB - 1) / PPB);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (2 * H * W + PPB * M * 3);
  mala_sweep_k4_kernel<H, W, L, CHILD, NOISE, PSF>
      <<<grid, kBlock, smem, stream>>>(
          b.key, b.image, b.temperature, b.counts, b.locs_in, b.fluxes_in,
          b.rate_in, b.pll_in, b.lp_in, b.crate_in, b.cll_in, b.tags,
          b.locs_out, b.fluxes_out, b.rate_out, b.pll_out, b.lp_out,
          b.acc_out, b.crate_out, b.cll_out, N, M, num_iters, Q);
  return cudaGetLastError();
}

// One instantiation per noise and PSF kind, so that the unrolled pixel
// passes branch on neither (as K2's launch_kinds).
template <int H, int W, int L, bool CHILD>
cudaError_t launch_kinds(const Buffers& b, int G, int N, int M,
                         int num_iters, const K4Params& Q, cudaStream_t s) {
  switch (Q.base.noise_kind * 3 + Q.base.psf_kind) {
    case 0: return launch<H, W, L, CHILD, 0, 0>(b, G, N, M, num_iters, Q, s);
    case 1: return launch<H, W, L, CHILD, 0, 1>(b, G, N, M, num_iters, Q, s);
    case 2: return launch<H, W, L, CHILD, 0, 2>(b, G, N, M, num_iters, Q, s);
    case 3: return launch<H, W, L, CHILD, 1, 0>(b, G, N, M, num_iters, Q, s);
    case 4: return launch<H, W, L, CHILD, 1, 1>(b, G, N, M, num_iters, Q, s);
    case 5: return launch<H, W, L, CHILD, 1, 2>(b, G, N, M, num_iters, Q, s);
  }
  return cudaErrorInvalidValue;
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
      params.child_axis > 1 || params.base.noise_kind < 0 ||
      params.base.noise_kind > 1 || params.base.psf_kind < 0 ||
      params.base.psf_kind > 2 ||
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
      return (int)launch_kinds<8, 8, kLanes8x8, false>(b, G, N, M, num_iters,
                                                       params, s);
    }
    if (H == 16 && W == 16) {
      return (int)launch_kinds<16, 16, kLanes16x16, false>(
          b, G, N, M, num_iters, params, s);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (H == 16 && W == 8 && M <= 16) {
    return (int)launch_kinds<16, 8, kLanesBridge16x8, true>(
        b, G, N, M, num_iters, params, s);
  }
  if (H == 16 && W == 16) {
    return (int)launch_kinds<16, 16, kLanesBridge16x16, true>(
        b, G, N, M, num_iters, params, s);
  }
  return (int)cudaErrorInvalidValue;
}
