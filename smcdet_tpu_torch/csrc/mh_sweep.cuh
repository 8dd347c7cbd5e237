// The fused single-component Metropolis-Hastings sweep loop for Hopper
// (sm_90a), shared by kernels K1 and K2 (mh_sweep_k2.cu, the tile targets)
// and K3 (mh_sweep_k3.cu, the aggregation bridge target): one device body,
// inlined into each kernel, with the bridge's child term under
// `if constexpr (CHILD)`.
//
// What bounds it on this card: instruction issue. Each update renders the
// old and the proposed star over every pixel and evaluates the likelihood of
// the proposed rate (one logf per pixel, and a division or a lgamma-free
// Poisson term; on the bridge a second likelihood, of the child rate), and
// does a scalar part once per particle: the slot choice, three
// truncated-normal proposals (two Phi and an inverse Phi each), three
// reverse truncation masses (two Phi each), six logs of masses, the flux
// prior at both fluxes and the accept test. The data sheet's bound counts
// the SFU results of that work; the kernel issues several instructions per
// SFU result.
//
// Design: L lanes per particle (each kernel's kLanes* constants, chosen by
// time on the H100, PERF.md), each lane holding HW / L pixels of the rate
// cache (and on the bridge of the child rate) in registers (pixel p = lane +
// L * k, so the cache loads and stores are coalesced). A warp holds 32 / L
// particles. Four things keep the warp's issue slots on the pixels:
//
// - The scalar part is split across the particle's lanes instead of being
//   repeated on each: lane c < 3 proposes coordinate c (y, x, flux) with one
//   tn_sample and takes the log of its forward and of its reverse truncation
//   mass; even lanes take the flux prior at the proposed flux and odd lanes
//   at the old one. __shfl_sync inside the lane group (width L) hands the
//   proposals and the terms to every lane, which combine log_q and log_alpha
//   in the order of the plain version. Each piece is the same function of
//   the same inputs as before, so each value is unchanged; lanes above 2
//   repeat lane 2's flux proposal, which costs no issue slot.
// - The Philox words are drawn ahead. Their counters (particle, sweep, draw,
//   particle >> 32) never depend on the chain, so lane 2 s + d draws word set
//   d of sweep base + s for the next L / 2 sweeps at once, and each sweep
//   fetches its five uniforms by shuffle: one Philox4x32-10 per lane per
//   L / 2 sweeps instead of two per lane per sweep.
// - No IEEE division by a launch constant on the pixel path: the PSF's
//   widths and normalisers become reciprocals once per thread (PsfRecip) and
//   the render multiplies by them. The general wing's q^(-beta/2) is
//   exp2(-beta/2 log2 q). Divisions by per-pixel data (Gaussian noise's
//   variance, the Poisson tail's rate) stay divisions.
// - One instantiation per noise and PSF kind (each kernel's launch_kinds),
//   so the unrolled pixel loop carries no branch on them and the compiler
//   interleaves the pixels' independent work.
//
// The pixel log-likelihood (on the bridge both of them) is summed by a
// __shfl_xor_sync butterfly, which leaves the bit-identical total in every
// lane, so every lane takes the same accept decision. The catalog (slot
// locations and fluxes) sits in shared memory, read by slot index and
// written by the particle's first lane on accept. A block of 256 threads
// shares one group (one image, one temperature): the image and, for Poisson
// noise, lgamma(image + 1) are staged in shared memory once per launch, as
// the TPU kernel precomputes lgamma outside its body. The flux-prior
// variants are branches that are uniform across the grid. Every lane of a
// warp runs the same number of sweeps, so every shuffle sees all its lanes.
//
// The bridge (CHILD): the target is lp + tau pll + (1 - tau) cll on a joined
// tile, where the child rate renders each star only into the pixel window of
// its own child tile: the window of the slot's fixed origin tag (tag mode;
// the particle keeps its tags as one 32-bit mask, slot m's tag is bit m), or
// the side of the star's location, coord <= boundary along child_axis
// (location mode, from the shuffled proposals). The child cache moves by
// adu (f' psi' w' - f psi w). Each lane keeps one bit per pixel for the even
// child's window, so the window costs two compares per pixel. The frozen
// ghost rate of the stars the merge dropped is part of the child cache the
// caller seeds; the kernel carries it and never renders it. Padded particles
// (n >= N) start from rate = child rate = 1 and never move, so no lane takes
// log(0).
//
// Random numbers (mh_common.cuh): Philox4x32-10 keyed by the per-call key
// with the counter (particle, sweep, draw, particle >> 32), so the stream is
// that of the plain PyTorch version (ops/mh_sweep.py), and the two agree
// particle by particle up to the library's expf/logf/lgammaf rounding, the
// reciprocals and exp2/log2 of the render, and the order of the pixel sums.

#pragma once

#include "mh_common.cuh"
#include "mh_pixel.cuh"

namespace smcdet {

// The bridge's buffers and split (unused on a tile target).
struct ChildArgs {
  const float* crate_in;
  const float* cll_in;
  const int64_t* tags;  // [G, N] bit m = slot m's origin tag (tag mode)
  float* crate_out;
  float* cll_out;
  float boundary;     // pixels with coord < boundary form the even child
  int child_axis;     // 0: the children split the rows, 1: the columns
  int side_from_tag;  // 1: slot origin tags, 0: the side of the location
};

// NOISE and PSF fix K2Params' noise_kind and psf_kind at compile time; a
// block of kBlock threads holds kBlock / L particles of group blockIdx.x.
template <int H, int W, int L, int NOISE, int PSF, bool CHILD, int kBlock>
__device__ __forceinline__ void mh_sweep_body(
    const int64_t* key, const float* image, const float* temperature,
    const int32_t* counts, const float* locs_in, const float* fluxes_in,
    const float* rate_in, const float* pll_in, const float* lp_in,
    float* locs_out, float* fluxes_out, float* rate_out, float* pll_out,
    float* lp_out, float* acc_out, int N, int M, int num_iters,
    const K2Params& P0, const ChildArgs& C) {
  constexpr unsigned kFull = 0xffffffffu;
  constexpr int HW = H * W;
  constexpr int PPL = HW / L;        // pixels per lane
  constexpr int PPB = kBlock / L;    // particles per block
  constexpr int AHEAD = L / 2;       // sweeps per Philox draw-ahead
  static_assert(HW % L == 0 && 32 % L == 0 && L >= 4 &&
                    (W % L == 0 || L % W == 0),
                "L must divide HW and 32, hold the three proposals, and "
                "divide the row or be a multiple of it");
  static_assert(!CHILD || PPL <= 32, "one bit per pixel of a lane");
  K2Params P = P0;
  P.noise_kind = NOISE;
  PsfRecip R = psf_recip(P);
  R.kind = PSF;
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
  // a padded particle's caches: 0 on a tile, 1 on the bridge (no log(0))
  constexpr float kPad = CHILD ? 1.f : 0.f;
  float rate[PPL], rate_prop[PPL];
  float crate[CHILD ? PPL : 1], crate_prop[CHILD ? PPL : 1];
  uint32_t even_bits = 0;  // bit k: pixel lane + L k is in the even child
#pragma unroll
  for (int k = 0; k < PPL; ++k) {
    rate[k] = valid ? rate_in[pid * HW + lane + L * k] : kPad;
    if constexpr (CHILD) {
      crate[k] = valid ? C.crate_in[pid * HW + lane + L * k] : kPad;
      float h, w;
      pixel_rc<W, L>(lane, k, &h, &w);
      even_bits |= ((C.child_axis == 0 ? h : w) < C.boundary ? 1u : 0u)
                   << k;
    }
  }
  float pll = valid ? pll_in[pid] : 0.f;
  float lp = valid ? lp_in[pid] : 0.f;
  float cll = 0.f;
  uint32_t side_bits = 0;  // bit m: slot m's origin tag (tag mode)
  if constexpr (CHILD) {
    cll = valid ? C.cll_in[pid] : 0.f;
    side_bits = (valid && C.side_from_tag) ? (uint32_t)C.tags[pid] : 0u;
  }
  __syncthreads();

  const uint32_t k0 = (uint32_t)key[0];
  const uint32_t k1 = (uint32_t)key[1];
  const float tau = temperature[g];
  const float one_minus_tau = 1.f - tau;
  const bool active = count > 0;
  const float count_f = (float)count;
  // this lane's proposal coordinate: 0 y, 1 x, 2 flux (lanes above 2 repeat
  // the flux), with its random-walk scale and box
  const int c = min(lane, 2);
  const float sigma_c = c < 2 ? P.locs_stdev : P.fluxes_stdev;
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

      // lane c proposes coordinate c; every lane gets the three proposals
      float mass_c;
      const float prop_c =
          tn_sample(c == 0 ? u_y : c == 1 ? u_x : u_f,
                    c == 0 ? ly_j : c == 1 ? lx_j : f_j, sigma_c, lb_c, ub_c,
                    &mass_c);
      const float y_prop = __shfl_sync(kFull, prop_c, 0, L);
      const float x_prop = __shfl_sync(kFull, prop_c, 1, L);
      const float f_prop = __shfl_sync(kFull, prop_c, 2, L);

      // the child tile that renders the moved star, before and after the
      // move: its origin tag (fixed), or the side of its old and proposed
      // location
      bool side_old = false, side_new = false;
      if constexpr (CHILD) {
        if (C.side_from_tag) {
          side_old = side_new = (side_bits >> j) & 1u;
        } else {
          side_old = (C.child_axis == 0 ? ly_j : lx_j) <= C.boundary;
          side_new = (C.child_axis == 0 ? y_prop : x_prop) <= C.boundary;
        }
      }

      // incremental rate update of this lane's pixels and their likelihood
      const float fy_old = floorf(ly_j), fx_old = floorf(lx_j);
      const float fy_new = floorf(y_prop), fx_new = floorf(x_prop);
      float pll_prop = 0.f, cll_prop = 0.f;
#pragma unroll
      for (int k = 0; k < PPL; ++k) {
        const int p = lane + L * k;
        float h, w;
        pixel_rc<W, L>(lane, k, &h, &w);
        const float psi_old = star_pixel_recip(h, w, ly_j, lx_j, fy_old,
                                               fx_old, P.psf_radius, R);
        const float psi_new = star_pixel_recip(h, w, y_prop, x_prop, fy_new,
                                               fx_new, P.psf_radius, R);
        const float d = P.adu * (f_prop * psi_new - f_j * psi_old);
        const float rp = rate[k] + d;
        rate_prop[k] = rp;
        pll_prop += pixel_loglik(s_img[p], s_lg[p], rp, P);
        if constexpr (CHILD) {
          const bool even = (even_bits >> k) & 1u;
          const float w_old = even == side_old ? 1.f : 0.f;
          const float w_new = even == side_new ? 1.f : 0.f;
          const float dc =
              P.adu * (f_prop * (psi_new * w_new) - f_j * (psi_old * w_old));
          const float crp = crate[k] + dc;
          crate_prop[k] = crp;
          cll_prop += pixel_loglik(s_img[p], s_lg[p], crp, P);
        }
      }
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1) {
        pll_prop += __shfl_xor_sync(kFull, pll_prop, off);
        if constexpr (CHILD) {
          cll_prop += __shfl_xor_sync(kFull, cll_prop, off);
        }
      }

      // the flux prior at the proposed flux (even lanes) and the old one
      // (odd lanes)
      const float flp = flux_log_prob((lane & 1) ? f_j : f_prop, P);
      const float lp_prop = lp + (__shfl_sync(kFull, flp, 0, L) -
                                  __shfl_sync(kFull, flp, 1, L));
      // lane c's forward truncation mass, around the old value, and its
      // reverse one, around the proposal; symmetric random walk: only the
      // truncation masses remain
      const float lm = log_mass(mass_c);
      const float lm_rev = log_mass(tn_mass(prop_c, sigma_c, lb_c, ub_c));
      const float log_q = (__shfl_sync(kFull, lm, 0, L) +
                           __shfl_sync(kFull, lm, 1, L)) -
                          (__shfl_sync(kFull, lm_rev, 0, L) +
                           __shfl_sync(kFull, lm_rev, 1, L)) +
                          __shfl_sync(kFull, lm, 2, L) -
                          __shfl_sync(kFull, lm_rev, 2, L);
      float log_alpha;
      if constexpr (CHILD) {
        log_alpha = (((lp_prop + tau * pll_prop) + one_minus_tau * cll_prop) -
                     ((lp + tau * pll) + one_minus_tau * cll)) +
                    log_q;
      } else {
        log_alpha = ((lp_prop + tau * pll_prop) - (lp + tau * pll)) + log_q;
      }
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
        if constexpr (CHILD) {
#pragma unroll
          for (int k = 0; k < PPL; ++k) crate[k] = crate_prop[k];
          cll = cll_prop;
        }
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
  for (int k = 0; k < PPL; ++k) rate_out[pid * HW + lane + L * k] = rate[k];
  if constexpr (CHILD) {
#pragma unroll
    for (int k = 0; k < PPL; ++k) {
      C.crate_out[pid * HW + lane + L * k] = crate[k];
    }
  }
  if (lane == 0) {
    pll_out[pid] = pll;
    lp_out[pid] = lp;
    if constexpr (CHILD) C.cll_out[pid] = cll;
    acc_out[pid] = (float)accepted / (float)num_iters;
  }
}

}  // namespace smcdet
