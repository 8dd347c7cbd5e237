// Fused single-component MALA sweep loop for Hopper (sm_90a) at any tile
// shape and slot count, on the tile and the aggregation bridge targets
// (kernel K4g).
//
// Replaces the TPU kernel smcdet_tpu/ops/pallas_sweep.py:_make_mala_kernel
// wherever K4 (mala_sweep_k4.cu: the tile target on 8x8 and 16x16 with up to
// 16 slots, the bridge on 16x8 with up to 16 and 16x16 with up to 32) is not
// built for the shape: levels 2 and up of a larger tile grid and the
// single-tile run of a whole image. It computes what K4 computes: one
// occupied slot moves a sweep, drawn from normals truncated to the prior's
// box around the drifted means x + step^2 / 2 * grad with the closed-form
// slot gradient, accepted with the tempered ratio that carries both
// proposal densities (mala_common.cuh: Phi by the plain version's formula).
//
// What bounds it on this card: instruction issue, as K4. Each update renders
// the old star with its derivative and sums the forward gradient terms at
// the cached rates, then renders the proposed star with its derivative and
// sums the likelihood(s) and the reverse gradient terms at the proposal; and
// does K4's scalar part once per particle.
//
// Design: K4's body (two pixel passes a sweep, the scalar part split across
// lanes 0-2, Philox drawn ahead) on the pixel classes of K2g and K3g
// (mh_sweep_classes.cuh), with the tile's shape a run-time value.
//
// - Pixel classes. A tile of H W pixels takes the smallest class of
//   CAP = 64, 128, ..., 4096 pixels that holds it. A class fixes its lanes
//   per particle L (K2g's and K3g's, mh_sweep_classes.cuh: class_lanes)
//   and PPL = CAP / L
//   pixels per lane at compile time: lane l holds pixels p = l + L k, the
//   pixel loops unroll kUnroll pixels at a time, rows and columns advance by
//   a carry, not a division, and a ragged tile (24x24 in the 1024 class)
//   reads a clamped index and adds 0 for the missing pixels with a select,
//   so the sums are those of the plain version's lane_sum.
// - Caches and proposals in shared memory, double-buffered: the rate cache
//   and its proposal (on the bridge also the child rate and its proposal),
//   read from the inputs once and written to the outputs after the last
//   sweep. A warp's particles interleave their lanes' columns (32 floats a
//   row), so no two lanes of a warp share a bank at any L.
// - Two pixel passes a sweep, one render of each star. Pass 1 renders the
//   old star with its derivative, sums the forward gradient terms at the
//   cached rates and writes rate - af_old psi_old (on the bridge also the
//   child rate less the star inside its child window) into the proposal
//   buffer. Pass 2 renders the proposed star with its derivative, adds it
//   into that buffer in place, and sums the likelihood(s) and the reverse
//   gradient terms there. An accept swaps the buffers' roles, a reject
//   leaves them: nothing is rendered a third time. The expressions and their
//   rounding order are the plain version's (ops/mala_sweep.py: (rate -
//   af_old psi_o) + af_new psi), and the file is compiled with -fmad=false
//   (_build.py: SOURCE_FLAGS), as K4, so each multiply and add rounds on its
//   own as the plain version's tensor ops do: MALA's drift amplifies a
//   last-bit difference over the sweeps.
// - The rest is K4's: lane c < 3 draws coordinate c's proposal around its
//   drifted mean and after the second butterfly works out its reverse drift,
//   box mass and both proposal densities; even lanes take the flux prior at
//   the proposed flux and odd lanes at the current one; __shfl_sync inside
//   the lane group hands them round; lane 2 s + d draws Philox word set d of
//   sweep base + s for the next L / 2 sweeps; the PSF and its derivative by
//   reciprocals (PsfRecip); one instantiation per noise and PSF kind. A
//   block holds up to kClassBlock / L particles, the number that keeps the
//   most particles resident on an SM by the occupancy calculator
//   (mh_sweep_classes.cuh: launch_classed), at least one warp's.
//
// The bridge (CHILD): the target is lp + tau pll + (1 - tau) cll on a joined
// tile; the child rate renders each star only into its child tile's pixel
// window: the window of the slot's fixed origin tag (tag mode; one uint8 per
// slot, any slot count), or of the side of the star's location, coord <=
// boundary along child_axis (location mode); a pixel's side of the split is
// one compare of its row or column. Padded particles (n >= N) start from
// rate = child rate = 1 and never move; a particle with no occupied slot
// never moves and passes through bit-exactly.
//
// Tiles above 4096 pixels, and shapes where not even one warp of particles'
// caches and proposals fits beside the image, take the wide route
// (mala_sweep_wide.cu: one warp a particle, the caches in the output rows).
// The plain version (ops/mala_sweep.py) sums a particle's pixels in this
// kernel's lane order at every class (lane_sum with GENERIC_CLASS_LANES,
// which repeats kLanesTile* and kLanesBridge*; GENERIC_LANES on the wide
// route).
//
// The class kernels of the tile target are instantiated in mala_sweep_k4g.cu
// (with the entry point), those of the bridge in mala_sweep_k4g_bridge.cu,
// so that the two compile at once.

#pragma once

#include "mala_common.cuh"
#include "mh_sweep_classes.cuh"

namespace smcdet {

// The wide route of K4g (mala_sweep_wide.cu); the arguments are the entry
// point's.
int launch_mala_wide(const GenericBuffers& B, int G, int N, int M, int H,
                     int W, int num_iters, const GenericParams& Q,
                     bool child, cudaStream_t stream);

// K4g on the bridge target (mala_sweep_k4g_bridge.cu): launch_classes of the
// bridge's class kernels; the arguments are the entry point's.
int launch_k4g_bridge(
    const void* key, const void* image, const void* temperature,
    const void* counts, const void* locs_in, const void* fluxes_in,
    const void* rate_in, const void* pll_in, const void* lp_in,
    const void* crate_in, const void* cll_in, const void* tags,
    void* locs_out, void* fluxes_out, void* rate_out, void* pll_out,
    void* lp_out, void* acc_out, void* crate_out, void* cll_out, int G,
    int N, int M, int H, int W, int num_iters, const GenericParams& Q,
    void* stream);

}  // namespace smcdet

namespace {

using namespace smcdet;

// The blocks of kClassBlock threads an SM that __launch_bounds__ names (at
// most 128 registers a thread) and the pixels a lane's loops unroll
constexpr int kMinBlocks = 2;
constexpr int kUnroll = 4;

template <int CAP, int L, int NOISE, int PSF, bool CHILD>
__global__ void __launch_bounds__(kClassBlock, kMinBlocks)
mala_sweep_k4g_kernel(const GenericBuffers B, int N, int M, int H, int W,
                      int num_iters, const GenericParams Q) {
  constexpr unsigned kFull = 0xffffffffu;
  constexpr int PPL = CAP / L;   // pixels per lane
  constexpr int AHEAD = L / 2;   // sweeps per Philox draw-ahead
  constexpr int NC = CHILD ? 2 : 1;  // caches: the rate (and child rate)
  constexpr int ROW = 32;  // floats a buffer row: one per lane of a warp
  static_assert(32 % L == 0 && L >= 4,
                "L must divide a warp and hold the three proposals");
  const int HW = H * W;
  K2Params P = Q.base;
  P.noise_kind = NOISE;
  P.psf_kind = PSF;
  const PsfRecip R = psf_recip(P);
  // the wing's derivative factor -1 / (2 sp) (SDSS PSF only)
  const float wd = PSF == 0 ? 0.f : -1.f / (2.f * P.sp);
  extern __shared__ float smem[];
  const int ppb = blockDim.x / L;  // particles a block
  float* s_img = smem;             // [HW]
  float* s_lg = smem + HW;         // [HW] lgamma(image + 1), Poisson
  float* s_cat = smem + 2 * HW;    // [ppb][M][3]: y, x, flux

  const int g = blockIdx.x;
  for (int p = threadIdx.x; p < HW; p += blockDim.x) {
    const float v = B.image[(int64_t)g * HW + p];
    s_img[p] = v;
    s_lg[p] = NOISE == 1 ? lgammaf(v + 1.f) : 0.f;
  }

  const int local = threadIdx.x / L;  // particle within the block
  const int lane = threadIdx.x % L;   // lane within the particle
  const int n = blockIdx.y * ppb + local;
  const bool valid = n < N;
  const int64_t pid = (int64_t)g * N + n;
  const int count = valid ? B.counts[pid] : 0;
  float* cat = s_cat + local * M * 3;
  if (valid) {
    for (int m = lane; m < M; m += L) {
      cat[m * 3] = B.locs_in[(pid * M + m) * 2];
      cat[m * 3 + 1] = B.locs_in[(pid * M + m) * 2 + 1];
      cat[m * 3 + 2] = B.fluxes_in[pid * M + m];
    }
  }
  // this thread's column of its warp's caches, [NC][2][PPL][ROW]: cache c's
  // buffer b at pixel k is s_buf[((c * 2 + b) * PPL + k) * ROW]; buffer
  // `cur` holds the caches, the other one the proposals
  float* s_buf = s_cat + ppb * M * 3 +
                 (threadIdx.x / 32) * (NC * 2 * PPL * ROW) + threadIdx.x % 32;
  int cur = 0;

  // pixel lane + L k sits in row h_k, column w_k: the first from one
  // division, each next one L / W rows and L % W columns on, with a carry
  const int h0 = lane / W;
  const float h0f = (float)h0, w0f = (float)(lane - h0 * W);
  const int sh = L / W;
  const float shf = (float)sh, swf = (float)(L - sh * W), wf = (float)W;
  // this lane's pixels inside the tile: k < nk
  const int nk = lane < HW ? (HW - lane + L - 1) / L : 0;

  // padded particles (n >= N) and pixels past the tile hold 1: no log(0)
#pragma unroll (kUnroll)
  for (int k = 0; k < PPL; ++k) {
    const bool in = valid && k < nk;
    const int64_t at = pid * HW + lane + L * k;
    s_buf[k * ROW] = in ? B.rate_in[at] : 1.f;
    if constexpr (CHILD) {
      s_buf[(2 * PPL + k) * ROW] = in ? B.crate_in[at] : 1.f;
    }
  }
  float pll = valid ? B.pll_in[pid] : 0.f;
  float lp = valid ? B.lp_in[pid] : 0.f;
  float cll = 0.f;
  const uint8_t* tags = nullptr;
  if constexpr (CHILD) {
    cll = valid ? B.cll_in[pid] : 0.f;
    if (Q.side_from_tag) tags = B.tags + pid * M;
  }
  __syncthreads();

  const uint32_t k0 = (uint32_t)B.key[0];
  const uint32_t k1 = (uint32_t)B.key[1];
  const float tau = B.temperature[g];
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
  // A particle with no occupied slot never moves (its proposals are not
  // applied), so it passes through bit-exactly; a warp of such particles
  // skips the loop. Every lane of a warp runs the same number of sweeps, so
  // the shuffles and __syncwarp below are safe.
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

      // the child tile that renders the moved star now: its origin tag
      // (fixed), or the side of its location
      bool side_old = false;
      if constexpr (CHILD) {
        side_old = Q.side_from_tag
                       ? active && tags[j] != 0
                       : (Q.child_axis == 0 ? ly_j : lx_j) <= Q.boundary;
      }

      // the caches (buffer cur) and the proposals (the other one)
      const int nxt = cur ^ 1;
      const float* r_cur = s_buf + cur * PPL * ROW;
      float* r_new = s_buf + nxt * PPL * ROW;
      const float* c_cur = s_buf + (2 + cur) * PPL * ROW;
      float* c_new = s_buf + (2 + nxt) * PPL * ROW;

      // pass 1: the forward gradient sums at the current point (the cached
      // full rates), and the caches without the star into the proposals
      const float fy_old = floorf(ly_j), fx_old = floorf(lx_j);
      float sy = 0.f, sx = 0.f, sf = 0.f;
      float h = h0f, w = w0f;
#pragma unroll (kUnroll)
      for (int k = 0; k < PPL; ++k) {
        const bool in = k < nk;
        const int p = min(lane + L * k, HW - 1);
        float psi, dpsi, dy, dx;
        star_pixel_deriv_recip(h, w, ly_j, lx_j, fy_old, fx_old,
                               P.psf_radius, R, wd, &psi, &dpsi, &dy, &dx);
        const float img = s_img[p];
        const float rk = r_cur[k * ROW];
        float gk = tau * pixel_dll_recip(img, rk, noise_recip(rk, P), P);
        r_new[k * ROW] = rk - af_old * psi;
        if constexpr (CHILD) {
          // the pixel is in the moved star's child window
          const bool win =
              ((Q.child_axis == 0 ? h : w) < Q.boundary) == side_old;
          const float ck = c_cur[k * ROW];
          if (win) {
            gk += one_minus_tau * pixel_dll_recip(img, ck, noise_recip(ck, P),
                                                  P);
          }
          c_new[k * ROW] = ck - (win ? af_old * psi : 0.f);
        }
        const float gd = gk * dpsi;
        sy += in ? gd * (-2.f * dy) : 0.f;
        sx += in ? gd * (-2.f * dx) : 0.f;
        sf += in ? gk * psi : 0.f;
        w += swf;
        h += shf;
        if (w >= wf) {
          w -= wf;
          h += 1.f;
        }
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

      // pass 2: add the proposed star into the proposals, the likelihood(s)
      // there and the reverse gradient sums
      const float fy_new = floorf(y_prop), fx_new = floorf(x_prop);
      float pll_prop = 0.f, cll_prop = 0.f;
      float ry = 0.f, rx = 0.f, rf = 0.f;
      h = h0f;
      w = w0f;
#pragma unroll (kUnroll)
      for (int k = 0; k < PPL; ++k) {
        const bool in = k < nk;
        const int p = min(lane + L * k, HW - 1);
        float psi, dpsi, dy, dx;
        star_pixel_deriv_recip(h, w, y_prop, x_prop, fy_new, fx_new,
                               P.psf_radius, R, wd, &psi, &dpsi, &dy, &dx);
        const float img = s_img[p], lg = s_lg[p];
        const float rp = r_new[k * ROW] + af_new * psi;
        r_new[k * ROW] = rp;
        const float inv = noise_recip(rp, P);
        const float ll = pixel_loglik_recip(img, lg, rp, inv, P);
        pll_prop += in ? ll : 0.f;
        float gk = tau * pixel_dll_recip(img, rp, inv, P);
        if constexpr (CHILD) {
          const bool win =
              ((Q.child_axis == 0 ? h : w) < Q.boundary) == side_new;
          const float crp = c_new[k * ROW] + (win ? af_new * psi : 0.f);
          c_new[k * ROW] = crp;
          const float cinv = noise_recip(crp, P);
          const float cl = pixel_loglik_recip(img, lg, crp, cinv, P);
          cll_prop += in ? cl : 0.f;
          if (win) gk += one_minus_tau * pixel_dll_recip(img, crp, cinv, P);
        }
        const float gd = gk * dpsi;
        ry += in ? gd * (-2.f * dy) : 0.f;
        rx += in ? gd * (-2.f * dx) : 0.f;
        rf += in ? gk * psi : 0.f;
        w += swf;
        h += shf;
        if (w >= wf) {
          w -= wf;
          h += 1.f;
        }
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
        cur = nxt;  // the proposals become the caches
        pll = pll_prop;
        lp = lp_prop;
        if constexpr (CHILD) cll = cll_prop;
        ++accepted;
      }
      __syncwarp();  // the slot write is seen by every lane's next read
    }
  }

  if (!valid) return;
  for (int m = lane; m < M; m += L) {
    B.locs_out[(pid * M + m) * 2] = cat[m * 3];
    B.locs_out[(pid * M + m) * 2 + 1] = cat[m * 3 + 1];
    B.fluxes_out[pid * M + m] = cat[m * 3 + 2];
  }
#pragma unroll (kUnroll)
  for (int k = 0; k < PPL; ++k) {
    if (k < nk) {
      const int64_t at = pid * HW + lane + L * k;
      B.rate_out[at] = s_buf[(cur * PPL + k) * ROW];
      if constexpr (CHILD) {
        B.crate_out[at] = s_buf[((2 + cur) * PPL + k) * ROW];
      }
    }
  }
  if (lane == 0) {
    B.pll_out[pid] = pll;
    B.lp_out[pid] = lp;
    if constexpr (CHILD) B.cll_out[pid] = cll;
    B.acc_out[pid] = (float)accepted / (float)num_iters;
  }
}

template <bool CHILD>
struct Kernels {
  static constexpr int lanes(int cap) { return class_lanes(cap, CHILD); }
  // the rate cache and its proposals (and on the bridge the child rate's):
  // 2 CAP floats a particle, 4 CAP on the bridge
  static constexpr int extra(int cap) { return (CHILD ? 4 : 2) * cap; }
  // the wide route: mala_sweep_wide.cu
  static int wide(const GenericBuffers& B, int G, int N, int M, int H, int W,
                  int num_iters, const GenericParams& Q, bool child,
                  cudaStream_t s) {
    return launch_mala_wide(B, G, N, M, H, W, num_iters, Q, child, s);
  }
  template <int CAP, int NOISE, int PSF>
  static constexpr auto get() {
    return mala_sweep_k4g_kernel<CAP, lanes(CAP), NOISE, PSF, CHILD>;
  }
};

}  // namespace

