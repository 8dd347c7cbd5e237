// The wide route of kernel K4g (mala_sweep_k4g.cu): tiles above 4096 pixels,
// and shapes where not even one warp of particles' caches and proposals fits
// a block's shared memory beside the image (a few pixels with thousands of
// slots).
//
// Replaces, with K4g's pixel classes, the TPU kernel
// smcdet_tpu/ops/pallas_sweep.py:_make_mala_kernel at those shapes. The
// design is mh_sweep_generic.cuh's (one warp per particle, pixel p = lane +
// 32 k in a loop, the caches in the particle's rows of the output buffers,
// the catalogs in dynamic shared memory, H, W and M at run time, NOISE and
// PSF as template arguments), with K4's scalar part split over lanes 0-2 and
// K4's operations per pixel. A sweep takes two pixel passes: the first sums
// the forward gradient terms at the cached rates; the second takes the star
// out of the caches, adds the proposed one, and sums the likelihood(s) and
// the reverse gradient terms there. On accept a third pass works the
// proposed caches out again and writes them. Compiled with -fmad=false
// (_build.py: SOURCE_FLAGS): the third pass gives the second's bits, and the
// plain version (ops/mala_sweep.py, its pixel sums in this body's order,
// lane_sum with GENERIC_LANES = 32 lanes) follows it operation by operation.
// No path of the repository runs a tile this large; tests/test_torch_gpu.py
// holds it against the plain version.

#include "mala_common.cuh"
#include "mh_sweep_generic.cuh"

namespace {

using namespace smcdet;

template <int NOISE, int PSF, bool CHILD>
__global__ void __launch_bounds__(kGenericBlock)
mala_sweep_k4g_kernel_wide(const GenericBuffers B, int N, int M, int H,
                           int W, int num_iters, const GenericParams Q) {
  constexpr unsigned kFull = 0xffffffffu;
  constexpr int AHEAD = 16;  // sweeps per Philox draw-ahead
  const int HW = H * W;
  K2Params P = Q.base;
  P.noise_kind = NOISE;
  P.psf_kind = PSF;
  const PsfRecip R = psf_recip(P);
  // the wing's derivative factor -1 / (2 sp) (SDSS PSF only)
  const float wd = PSF == 0 ? 0.f : -1.f / (2.f * P.sp);

  const int lane = threadIdx.x % 32;
  const int n = blockIdx.y * kGenericWarps + threadIdx.x / 32;
  const bool valid = n < N;
  const int64_t pid = (int64_t)blockIdx.x * N + n;
  float *s_img, *s_lg;
  float* cat = stage_generic<NOISE>(B, HW, M, pid, valid, lane, &s_img,
                                    &s_lg);
  __syncthreads();
  if (!valid) return;  // a whole warp: no shuffle below misses a lane

  const int count = B.counts[pid];
  float* rate = B.rate_out + pid * HW;
  float* crate = CHILD ? B.crate_out + pid * HW : nullptr;
  for (int p = lane; p < HW; p += 32) {
    rate[p] = B.rate_in[pid * HW + p];
    if constexpr (CHILD) crate[p] = B.crate_in[pid * HW + p];
  }
  float pll = B.pll_in[pid];
  float lp = B.lp_in[pid];
  float cll = CHILD ? B.cll_in[pid] : 0.f;
  const uint8_t* tags = (CHILD && Q.side_from_tag) ? B.tags + pid * M
                                                   : nullptr;

  const uint32_t k0 = (uint32_t)B.key[0];
  const uint32_t k1 = (uint32_t)B.key[1];
  const float tau = B.temperature[blockIdx.x];
  const float one_minus_tau = 1.f - tau;
  const bool active = count > 0;
  const float count_f = (float)count;
  const float aeff = active ? P.adu : 0.f;
  // this lane's coordinate: 0 y, 1 x, 2 flux (lanes above 2 repeat the
  // flux), with its step, half its squared step, the log of its step and its
  // box
  const int c = min(lane, 2);
  const float sigma_c = c < 2 ? P.locs_stdev : P.fluxes_stdev;
  const float half_c = (0.5f * sigma_c) * sigma_c;
  const float log_sigma_c = logf(sigma_c);
  const float lb_c = c == 0 ? P.loc_low_y : c == 1 ? P.loc_low_x : P.flux_lo;
  const float ub_c =
      c == 0 ? P.loc_high_y : c == 1 ? P.loc_high_x : P.flux_hi;
  int accepted = 0;
  // a particle with no occupied slot never moves: it passes through
  // bit-exactly
  const int iters = active ? num_iters : 0;
  for (int base = 0; base < iters; base += AHEAD) {
    uint32_t r[4] = {(uint32_t)pid, (uint32_t)(base + (lane >> 1)),
                     (uint32_t)(lane & 1), (uint32_t)(pid >> 32)};
    philox4x32_10(r, k0, k1);
    const float w0 = unit_uniform(r[0]), w1 = unit_uniform(r[1]);
    const float w2 = unit_uniform(r[2]), w3 = unit_uniform(r[3]);
    const int batch = min(AHEAD, iters - base);
    for (int s = 0; s < batch; ++s) {
      const float u_j = __shfl_sync(kFull, w0, 2 * s);
      const float u_y = __shfl_sync(kFull, w1, 2 * s);
      const float u_x = __shfl_sync(kFull, w2, 2 * s);
      const float u_f = __shfl_sync(kFull, w3, 2 * s);
      const float u_acc = __shfl_sync(kFull, w0, 2 * s + 1);

      const int j = max(min((int)floorf(u_j * count_f), count - 1), 0);
      const float ly_j = cat[j * 3];
      const float lx_j = cat[j * 3 + 1];
      const float f_j = cat[j * 3 + 2];
      const float af_old = aeff * f_j;
      const float v_c = c == 0 ? ly_j : c == 1 ? lx_j : f_j;
      bool side_old = false;
      if constexpr (CHILD) {
        side_old = Q.side_from_tag
                       ? tags[j] != 0
                       : (Q.child_axis == 0 ? ly_j : lx_j) <= Q.boundary;
      }
      const float fy_old = floorf(ly_j), fx_old = floorf(lx_j);

      // pass 1: the forward gradient sums at the current point (the cached
      // full rates)
      float sy = 0.f, sx = 0.f, sf = 0.f;
      for (int p = lane; p < HW; p += 32) {
        float h, w, psi, dpsi, dy, dx;
        pixel_hw(p, W, &h, &w);
        star_pixel_deriv_recip(h, w, ly_j, lx_j, fy_old, fx_old,
                               P.psf_radius, R, wd, &psi, &dpsi, &dy, &dx);
        const float img = s_img[p];
        const float rk = rate[p];
        float gk = tau * pixel_dll_recip(img, rk, noise_recip(rk, P), P);
        if constexpr (CHILD) {
          const bool even = (Q.child_axis == 0 ? h : w) < Q.boundary;
          if (even == side_old) {
            const float ck = crate[p];
            gk += one_minus_tau * pixel_dll_recip(img, ck, noise_recip(ck, P),
                                                  P);
          }
        }
        const float gd = gk * dpsi;
        sy += gd * (-2.f * dy);
        sx += gd * (-2.f * dx);
        sf += gk * psi;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        sy += __shfl_xor_sync(kFull, sy, off);
        sx += __shfl_xor_sync(kFull, sx, off);
        sf += __shfl_xor_sync(kFull, sf, off);
      }

      // lane c's drifted mean and its proposal; every lane gets the three
      const float grad_c = c == 0   ? sy * af_old
                           : c == 1 ? sx * af_old
                                    : sf * aeff + flux_log_prob_grad(f_j, P);
      const float mu_c = v_c + half_c * grad_c;
      float mass_c;
      const float prop_c = box_sample(c == 0 ? u_y : c == 1 ? u_x : u_f,
                                      mu_c, sigma_c, lb_c, ub_c, &mass_c);
      const float y_prop = __shfl_sync(kFull, prop_c, 0);
      const float x_prop = __shfl_sync(kFull, prop_c, 1);
      const float f_prop = __shfl_sync(kFull, prop_c, 2);
      const float af_new = aeff * f_prop;
      bool side_new = side_old;
      if (CHILD && !Q.side_from_tag) {  // location mode: the proposal's side
        side_new = (Q.child_axis == 0 ? y_prop : x_prop) <= Q.boundary;
      }
      const float fy_new = floorf(y_prop), fx_new = floorf(x_prop);

      // the caches at the proposal at pixel p (the same bits on every call),
      // with the proposed star's render, its derivative and offsets there,
      // and whether the pixel is in its child window
      auto proposed = [&](int p, float* rp, float* crp, float* psi,
                          float* dpsi, float* dy, float* dx, bool* win) {
        float h, w, psi_o, dpsi_o, dy_o, dx_o;
        pixel_hw(p, W, &h, &w);
        star_pixel_deriv_recip(h, w, ly_j, lx_j, fy_old, fx_old,
                               P.psf_radius, R, wd, &psi_o, &dpsi_o, &dy_o,
                               &dx_o);
        star_pixel_deriv_recip(h, w, y_prop, x_prop, fy_new, fx_new,
                               P.psf_radius, R, wd, psi, dpsi, dy, dx);
        *rp = (rate[p] - af_old * psi_o) + af_new * *psi;
        if constexpr (CHILD) {
          const bool even = (Q.child_axis == 0 ? h : w) < Q.boundary;
          *win = even == side_new;
          const float cwo = crate[p] - (even == side_old ? af_old * psi_o
                                                         : 0.f);
          *crp = cwo + (*win ? af_new * *psi : 0.f);
        }
      };

      // pass 2: the likelihood(s) at the proposal and the reverse gradient
      // sums there
      float pll_prop = 0.f, cll_prop = 0.f;
      float ry = 0.f, rx = 0.f, rf = 0.f;
      for (int p = lane; p < HW; p += 32) {
        float rp, crp, psi, dpsi, dy, dx;
        bool win;
        proposed(p, &rp, &crp, &psi, &dpsi, &dy, &dx, &win);
        const float img = s_img[p];
        const float inv = noise_recip(rp, P);
        pll_prop += pixel_loglik_recip(img, s_lg[p], rp, inv, P);
        float gk = tau * pixel_dll_recip(img, rp, inv, P);
        if constexpr (CHILD) {
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
      for (int off = 16; off > 0; off >>= 1) {
        pll_prop += __shfl_xor_sync(kFull, pll_prop, off);
        ry += __shfl_xor_sync(kFull, ry, off);
        rx += __shfl_xor_sync(kFull, rx, off);
        rf += __shfl_xor_sync(kFull, rf, off);
        if constexpr (CHILD) cll_prop += __shfl_xor_sync(kFull, cll_prop, off);
      }

      // the flux prior at the proposed flux (even lanes) and the current one
      // (odd lanes)
      const float flp = flux_log_prob((lane & 1) ? f_j : f_prop, P);
      const float lp_prop =
          lp + (__shfl_sync(kFull, flp, 0) - __shfl_sync(kFull, flp, 1));
      // lane c's reverse drifted mean at the proposal, and its forward and
      // reverse proposal log-densities (the forward mass from the sampling)
      const float grad_r_c = c == 0   ? ry * af_new
                             : c == 1 ? rx * af_new
                                      : rf * aeff +
                                            flux_log_prob_grad(f_prop, P);
      const float mu_r_c = prop_c + half_c * grad_r_c;
      const float fwd_c = tn_log_q(prop_c, mu_c, sigma_c, log_sigma_c, mass_c);
      const float rev_c = tn_log_q(v_c, mu_r_c, sigma_c, log_sigma_c,
                                   box_mass(mu_r_c, sigma_c, lb_c, ub_c));
      const float log_q_fwd = (__shfl_sync(kFull, fwd_c, 0) +
                               __shfl_sync(kFull, fwd_c, 1)) +
                              __shfl_sync(kFull, fwd_c, 2);
      const float log_q_rev = (__shfl_sync(kFull, rev_c, 0) +
                               __shfl_sync(kFull, rev_c, 1)) +
                              __shfl_sync(kFull, rev_c, 2);
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
      if (u_acc <= expf(capped)) {
        // pass 3: write the caches at the proposal
        for (int p = lane; p < HW; p += 32) {
          float rp, crp, psi, dpsi, dy, dx;
          bool win;
          proposed(p, &rp, &crp, &psi, &dpsi, &dy, &dx, &win);
          rate[p] = rp;
          if constexpr (CHILD) crate[p] = crp;
        }
        if (lane == 0) {
          cat[j * 3] = y_prop;
          cat[j * 3 + 1] = x_prop;
          cat[j * 3 + 2] = f_prop;
        }
        pll = pll_prop;
        cll = cll_prop;
        lp = lp_prop;
        ++accepted;
      }
      __syncwarp();  // the slot write is seen by every lane's next read
    }
  }

  store_catalog(B, cat, M, pid, lane);
  if (lane == 0) {
    B.pll_out[pid] = pll;
    B.lp_out[pid] = lp;
    if constexpr (CHILD) B.cll_out[pid] = cll;
    B.acc_out[pid] = (float)accepted / (float)num_iters;
  }
}

// the kernel of a noise and PSF kind on the bridge (CHILD) or the tile target
struct Wide {
  template <int NOISE, int PSF, bool CHILD>
  static constexpr auto get() {
    return mala_sweep_k4g_kernel_wide<NOISE, PSF, CHILD>;
  }
};

}  // namespace

namespace smcdet {

int launch_mala_wide(const GenericBuffers& B, int G, int N, int M, int H,
                     int W, int num_iters, const GenericParams& Q,
                     bool child, cudaStream_t s) {
  return launch_wide_kinds<Wide>(B, G, N, M, H, W, num_iters, Q, child, s);
}

}  // namespace smcdet
