// The fused single-component Metropolis-Hastings sweep loop at any tile
// shape and slot count for Hopper (sm_90a), by pixel class: the body of
// kernels K2g (mh_sweep_k2g.cu, the tile target) and K3g (mh_sweep_k3g.cu,
// the aggregation bridge target), with the bridge's child term under
// `if constexpr (CHILD)`. It computes what
// smcdet_tpu/ops/pallas_sweep.py:_make_kernel computes, for the targets and
// shapes K1-K3 are not built for. H, W and M are run-time arguments; the
// pixels a lane holds are not.
//
// What bounds it on this card: instruction issue, as K1-K3 (mh_sweep.cuh):
// each update renders the old and the proposed star over every pixel and
// takes the likelihood of the proposed rate (on the bridge also of the
// proposed child rate), and does a scalar part once per particle.
//
// Design: mh_sweep.cuh's, with the tile's shape a run-time value.
//
// - Pixel classes. A tile of H W pixels takes the smallest class of
//   CAP = 64, 128, ..., 4096 pixels that holds it. A class has its
//   lanes per particle L (class_lanes) and PPL = CAP / L
//   pixels per lane, both template arguments: lane l holds pixels p = l +
//   L k, k < PPL, and the pixel loop is unrolled UNROLL pixels at a time, so
//   the compiler interleaves the pixels' independent work as in K1-K3. A
//   tile smaller than its class (a ragged one, such as 24x24 in the 1024
//   class) computes the missing pixels on a clamped index and adds 0 for
//   them with a select, never a branch: the sums are those of the plain
//   version's lane_sum, which pads with zeros in the same order.
// - Row and column without a division: a lane's first pixel is row lane / W
//   (one division per thread, outside the sweeps), and each step of L pixels
//   moves L / W rows and L % W columns, with one carry when the column passes
//   W. As floats, exact for any tile a block holds.
// - The caches off device memory: each particle's rate cache (and on the
//   bridge its child rate cache) is read from the input once and written to
//   the output once, after the last sweep. In between they live in the
//   block's dynamic shared memory, each lane its own column (no bank
//   conflicts, no synchronisation). Not in registers: a lane's caches and
//   proposals there, with the fully unrolled loop's interleaving, took
//   150-255 registers and spilled from 32 pixels a lane on the bridge, and
//   the occupancy that left was slower at every class timed (PERF.md).
// - One render a sweep: the likelihood pass writes the proposed rate (and
//   child rate) into a second buffer; an accept swaps the roles of the two
//   buffers, a reject leaves them. Nothing is rendered twice. K2g and K3g
//   are compiled with -fmad=false all the same (_build.py: SOURCE_FLAGS):
//   each multiply and add rounds on its own, as the plain version's tensor
//   ops do, which keeps the caches as close to a fresh render as the
//   two-pass body (mh_sweep_generic.cuh) keeps them; contracted, they
//   drifted further (PERF.md).
// - The rest is mh_sweep.cuh's: the scalar part split across lanes 0-2
//   (lane c < 3 proposes coordinate c with one tn_sample and takes the logs
//   of its forward and reverse truncation masses, even lanes take the flux
//   prior at the proposed flux and odd lanes at the old one, __shfl_sync
//   inside the lane group hands them round), Philox drawn ahead (lane 2 s +
//   d draws word set d of sweep base + s for the next L / 2 sweeps), the PSF
//   by reciprocals (PsfRecip), one instantiation per noise and PSF kind, the
//   pixel sums a lane's pixels in turn and then a __shfl_xor_sync
//   butterfly, the catalogs and the image (with lgamma(image + 1)) in
//   dynamic shared memory. A block holds up to kClassBlock / L particles:
//   the number that keeps the most particles resident on an SM by the
//   occupancy calculator (launch_classed), at least one warp's, so every M
//   that mh_sweep_generic.cuh's 8 particles a block fit, fits.
//
// The bridge (CHILD): the target is lp + tau pll + (1 - tau) cll on a joined
// tile; the child rate renders each star only into its child tile's pixel
// window: the window of the slot's fixed origin tag (tag mode; one uint8 per
// slot, any slot count), or of the side of the star's location, coord <=
// boundary along child_axis (location mode); a pixel's side of the split is
// one compare of its row or column. The frozen ghost rate the merge left is
// part of the child cache the caller seeds.
//
// Tiles above 4096 pixels take mh_sweep_generic.cuh's body (caches in the
// output rows, one warp a particle; mh_sweep_wide.cu): a 64x64 bridge's
// caches and proposals take 64 KB of shared memory a particle, a larger
// class's would leave a block no room for its image.
//
// Random numbers (mh_common.cuh): Philox4x32-10 keyed by the per-call key
// with the counter (particle, sweep, draw, particle >> 32), the stream of the
// plain PyTorch version (ops/mh_sweep.py) and of K1-K3.

#pragma once

#include "mh_sweep_generic.cuh"

namespace smcdet {

constexpr int kClassMaxPixels = 4096;
constexpr int kClassBlock = 256;  // threads a block at most

// The smallest class that holds HW pixels (0 above kClassMaxPixels).
inline int pixel_class(int HW) {
  for (int cap = 64; cap <= kClassMaxPixels; cap *= 2) {
    if (HW <= cap) return cap;
  }
  return 0;
}

// Dynamic shared memory of one block of `ppb` particles: the image,
// lgamma(image + 1), the catalogs (y, x, flux per slot) and `extra` floats
// of caches and proposals per particle.
inline size_t classed_smem_bytes(int HW, int M, int ppb, int extra) {
  return sizeof(float) *
         (2 * (size_t)HW + (size_t)ppb * (3 * (size_t)M + (size_t)extra));
}

// Lanes per particle by pixel class, of K2g's and K4g's tile target
// (kLanesTile*) and of K3g's and K4g's bridge (kLanesBridge*). The class of
// 64 pixels holds an 8x8 tile, 128 16x8, 256 16x16, 512 32x16, 1024 32x32
// and 24x24, 2048 40x40 (64x32 on the bridge), 4096 64x64. One warp from 512
// pixels on the tile target and from 256 on the bridge, 16 lanes at 32x16
// being slower by time on the H100; below, K1's, K2's and K3's lanes at the
// same pixel counts (PERF.md). ops/mh_sweep.py:GENERIC_CLASS_LANES repeats
// them.
constexpr int kLanesTile64 = 4;
constexpr int kLanesTile128 = 8;
constexpr int kLanesTile256 = 16;
constexpr int kLanesTile512 = 32;
constexpr int kLanesTile1024 = 32;
constexpr int kLanesTile2048 = 32;
constexpr int kLanesTile4096 = 32;
constexpr int kLanesBridge64 = 8;
constexpr int kLanesBridge128 = 16;
constexpr int kLanesBridge256 = 32;
constexpr int kLanesBridge512 = 32;
constexpr int kLanesBridge1024 = 32;
constexpr int kLanesBridge2048 = 32;
constexpr int kLanesBridge4096 = 32;

// The lanes of class `cap` on the bridge (`child`) or the tile target.
constexpr int class_lanes(int cap, bool child) {
  if (child) {
    return cap == 64     ? kLanesBridge64
           : cap == 128  ? kLanesBridge128
           : cap == 256  ? kLanesBridge256
           : cap == 512  ? kLanesBridge512
           : cap == 1024 ? kLanesBridge1024
           : cap == 2048 ? kLanesBridge2048
                         : kLanesBridge4096;
  }
  return cap == 64     ? kLanesTile64
         : cap == 128  ? kLanesTile128
         : cap == 256  ? kLanesTile256
         : cap == 512  ? kLanesTile512
         : cap == 1024 ? kLanesTile1024
         : cap == 2048 ? kLanesTile2048
                       : kLanesTile4096;
}

// NOISE and PSF fix K2Params' noise_kind and psf_kind at compile time; a
// block of blockDim.x threads holds blockDim.x / L particles of group
// blockIdx.x.
template <int L, int PPL, int NOISE, int PSF, bool CHILD, int UNROLL>
__device__ __forceinline__ void mh_sweep_classed_body(
    const GenericBuffers& B, int N, int M, int H, int W, int num_iters,
    const GenericParams& Q) {
  constexpr unsigned kFull = 0xffffffffu;
  constexpr int AHEAD = L / 2;  // sweeps per Philox draw-ahead
  constexpr int NC = CHILD ? 2 : 1;  // caches: the rate (and child rate)
  static_assert(32 % L == 0 && L >= 4,
                "L must divide a warp and hold the three proposals");
  const int HW = H * W;
  K2Params P = Q.base;
  P.noise_kind = NOISE;
  PsfRecip R = psf_recip(P);
  R.kind = PSF;
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
  // this lane's column of the particle's caches, [NC][2][PPL][L]: cache
  // c's buffer b at pixel k is s_buf[((c * 2 + b) * PPL + k) * L]; buffer
  // `cur` holds the caches, the other one the proposals
  float* s_buf = s_cat + ppb * M * 3 + local * NC * 2 * PPL * L + lane;
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
#pragma unroll (UNROLL)
  for (int k = 0; k < PPL; ++k) {
    const bool in = valid && k < nk;
    const int64_t at = pid * HW + lane + L * k;
    s_buf[k * L] = in ? B.rate_in[at] : 1.f;
    if constexpr (CHILD) s_buf[(2 * PPL + k) * L] = in ? B.crate_in[at] : 1.f;
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
        if (Q.side_from_tag) {
          side_old = side_new = active && tags[j] != 0;
        } else {
          side_old = (Q.child_axis == 0 ? ly_j : lx_j) <= Q.boundary;
          side_new = (Q.child_axis == 0 ? y_prop : x_prop) <= Q.boundary;
        }
      }

      // the proposed caches of this lane's pixels and their likelihood
      const float fy_old = floorf(ly_j), fx_old = floorf(lx_j);
      const float fy_new = floorf(y_prop), fx_new = floorf(x_prop);
      float pll_prop = 0.f, cll_prop = 0.f;
      float h = h0f, w = w0f;
      // the caches (buffer cur) and the proposals (the other one)
      const int nxt = cur ^ 1;
      const float* r_cur = s_buf + cur * PPL * L;
      float* r_new = s_buf + nxt * PPL * L;
      const float* c_cur = s_buf + (2 + cur) * PPL * L;
      float* c_new = s_buf + (2 + nxt) * PPL * L;
#pragma unroll (UNROLL)
      for (int k = 0; k < PPL; ++k) {
        const bool in = k < nk;
        const int p = min(lane + L * k, HW - 1);
        const float psi_old = star_pixel_recip(h, w, ly_j, lx_j, fy_old,
                                               fx_old, P.psf_radius, R);
        const float psi_new = star_pixel_recip(h, w, y_prop, x_prop, fy_new,
                                               fx_new, P.psf_radius, R);
        const float rp =
            r_cur[k * L] + P.adu * (f_prop * psi_new - f_j * psi_old);
        r_new[k * L] = rp;
        const float img = s_img[p], lg = s_lg[p];
        const float ll = pixel_loglik(img, lg, rp, P);
        pll_prop += in ? ll : 0.f;
        if constexpr (CHILD) {
          // the pixel is in the even child's window
          const bool even = (Q.child_axis == 0 ? h : w) < Q.boundary;
          const float w_old = even == side_old ? 1.f : 0.f;
          const float w_new = even == side_new ? 1.f : 0.f;
          const float crp =
              c_cur[k * L] + P.adu * (f_prop * (psi_new * w_new) -
                                      f_j * (psi_old * w_old));
          c_new[k * L] = crp;
          const float cl = pixel_loglik(img, lg, crp, P);
          cll_prop += in ? cl : 0.f;
        }
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
#pragma unroll (UNROLL)
  for (int k = 0; k < PPL; ++k) {
    if (k < nk) {
      const int64_t at = pid * HW + lane + L * k;
      B.rate_out[at] = s_buf[(cur * PPL + k) * L];
      if constexpr (CHILD) B.crate_out[at] = s_buf[((2 + cur) * PPL + k) * L];
    }
  }
  if (lane == 0) {
    B.pll_out[pid] = pll;
    B.lp_out[pid] = lp;
    if constexpr (CHILD) B.cll_out[pid] = cll;
    B.acc_out[pid] = (float)accepted / (float)num_iters;
  }
}

// Launch `kernel` (a class kernel of L lanes a particle, `extra` floats of
// caches and proposals per particle in shared memory) over the grid (G,
// ceil(N / ppb)): ppb whole warps of particles, up to kClassBlock / L, that
// keep the most particles resident on an
// SM by the card's occupancy calculator (the kernel's registers and the
// block's shared memory; the larger block on a tie). Returns the launch's
// error: cudaErrorInvalidConfiguration where not even one warp's catalogs
// fit.
template <typename Kernel>
cudaError_t launch_classed(Kernel kernel, int L, int extra,
                           const GenericBuffers& B, int G, int N, int M,
                           int H, int W, int num_iters,
                           const GenericParams& Q, cudaStream_t stream) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err != cudaSuccess) return err;
  const int step = 32 / L;  // particles a warp
  int ppb = 0, resident = 0;
  for (int p = kClassBlock / L; p > 0; p -= step) {
    const size_t bytes = classed_smem_bytes(H * W, M, p, extra);
    if (bytes > (size_t)optin) continue;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        p * L, bytes);
    if (err != cudaSuccess) return err;
    if (blocks * p > resident || ppb == 0) {
      ppb = p;
      resident = blocks * p;
    }
  }
  if (ppb <= 0) return cudaErrorInvalidConfiguration;
  const size_t smem = classed_smem_bytes(H * W, M, ppb, extra);
  const dim3 grid(G, (N + ppb - 1) / ppb);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  kernel<<<grid, ppb * L, smem, stream>>>(B, N, M, H, W, num_iters, Q);
  return cudaGetLastError();
}

// Launch the class kernel `Kernels::get<CAP, NOISE, PSF>()` of the
// parameters' noise and PSF kinds (lanes Kernels::lanes(CAP), caches and
// proposals Kernels::extra(CAP) floats a particle). Returns the CUDA error
// (0 on success).
template <class Kernels, int CAP>
cudaError_t launch_class_kinds(const GenericBuffers& B, int G, int N, int M,
                               int H, int W, int num_iters,
                               const GenericParams& Q, cudaStream_t s) {
  const int L = Kernels::lanes(CAP), extra = Kernels::extra(CAP);
  switch (Q.base.noise_kind * 3 + Q.base.psf_kind) {
    case 0:
      return launch_classed(Kernels::template get<CAP, 0, 0>(), L, extra, B,
                            G, N, M, H, W, num_iters, Q, s);
    case 1:
      return launch_classed(Kernels::template get<CAP, 0, 1>(), L, extra, B,
                            G, N, M, H, W, num_iters, Q, s);
    case 2:
      return launch_classed(Kernels::template get<CAP, 0, 2>(), L, extra, B,
                            G, N, M, H, W, num_iters, Q, s);
    case 3:
      return launch_classed(Kernels::template get<CAP, 1, 0>(), L, extra, B,
                            G, N, M, H, W, num_iters, Q, s);
    case 4:
      return launch_classed(Kernels::template get<CAP, 1, 1>(), L, extra, B,
                            G, N, M, H, W, num_iters, Q, s);
    case 5:
      return launch_classed(Kernels::template get<CAP, 1, 2>(), L, extra, B,
                            G, N, M, H, W, num_iters, Q, s);
  }
  return cudaErrorInvalidValue;
}

// The wide route of K2g and K3g (mh_sweep_wide.cu): mh_sweep_generic.cuh's
// body for tiles above kClassMaxPixels; the arguments are the entry points'.
int launch_mh_wide(const GenericBuffers& B, int G, int N, int M, int H,
                   int W, int num_iters, const GenericParams& Q, bool child,
                   cudaStream_t stream);

// The wide route of K2g's and K3g's Kernels (launch_classes).
struct MhWideRoute {
  static int wide(const GenericBuffers& B, int G, int N, int M, int H, int W,
                  int num_iters, const GenericParams& Q, bool child,
                  cudaStream_t s) {
    return launch_mh_wide(B, G, N, M, H, W, num_iters, Q, child, s);
  }
};

// The entry points' body (K2g and K4g's tile target: child false; K3g and
// K4g's bridge: true): check the launch, then take the tile's class kernel
// or the wide route, Kernels::wide (mh_sweep_wide.cu, mala_sweep_wide.cu):
// above kClassMaxPixels, and where not even one warp of particles'
// catalogs, caches and proposals fit a block (a few pixels with thousands
// of slots), which the wide route's 8 catalogs may. Returns the CUDA error
// (0 on success).
template <class Kernels>
int launch_classes(
    const void* key, const void* image, const void* temperature,
    const void* counts, const void* locs_in, const void* fluxes_in,
    const void* rate_in, const void* pll_in, const void* lp_in,
    const void* crate_in, const void* cll_in, const void* tags,
    void* locs_out, void* fluxes_out, void* rate_out, void* pll_out,
    void* lp_out, void* acc_out, void* crate_out, void* cll_out, int G,
    int N, int M, int H, int W, int num_iters, const GenericParams& Q,
    bool child, void* stream) {
  const GenericBuffers B{
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
      static_cast<const uint8_t*>(tags),
      static_cast<float*>(locs_out),
      static_cast<float*>(fluxes_out),
      static_cast<float*>(rate_out),
      static_cast<float*>(pll_out),
      static_cast<float*>(lp_out),
      static_cast<float*>(acc_out),
      static_cast<float*>(crate_out),
      static_cast<float*>(cll_out),
  };
  cudaError_t err = check_generic(G, N, M, H, W, num_iters, Q, child, B);
  if (err != cudaSuccess) return (int)err;
  auto s = static_cast<cudaStream_t>(stream);
  int cap = pixel_class(H * W), dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (cap != 0 &&
      classed_smem_bytes(H * W, M, 32 / Kernels::lanes(cap),
                         Kernels::extra(cap)) > (size_t)optin) {
    cap = 0;
  }
  switch (cap) {
    case 64:
      return (int)launch_class_kinds<Kernels, 64>(B, G, N, M, H, W,
                                                  num_iters, Q, s);
    case 128:
      return (int)launch_class_kinds<Kernels, 128>(B, G, N, M, H, W,
                                                   num_iters, Q, s);
    case 256:
      return (int)launch_class_kinds<Kernels, 256>(B, G, N, M, H, W,
                                                   num_iters, Q, s);
    case 512:
      return (int)launch_class_kinds<Kernels, 512>(B, G, N, M, H, W,
                                                   num_iters, Q, s);
    case 1024:
      return (int)launch_class_kinds<Kernels, 1024>(B, G, N, M, H, W,
                                                    num_iters, Q, s);
    case 2048:
      return (int)launch_class_kinds<Kernels, 2048>(B, G, N, M, H, W,
                                                    num_iters, Q, s);
    case 4096:
      return (int)launch_class_kinds<Kernels, 4096>(B, G, N, M, H, W,
                                                    num_iters, Q, s);
  }
  return Kernels::wide(B, G, N, M, H, W, num_iters, Q, child, s);
}

}  // namespace smcdet
