// The fused single-component Metropolis-Hastings sweep loop at any tile
// shape and slot count for Hopper (sm_90a), shared by kernels K2g
// (mh_sweep_k2g.cu, the tile target) and K3g (mh_sweep_k3g.cu, the
// aggregation bridge target): one device body with the bridge's child term
// under `if constexpr (CHILD)`, as mh_sweep.cuh's. It computes what
// smcdet_tpu/ops/pallas_sweep.py:_make_kernel computes, for the targets and
// shapes K1-K3 are not built for: H, W and M are runtime arguments; NOISE and
// PSF are template arguments, with mh_pixel.cuh's device functions.
//
// Design (simple, right first; a faster one is later work): one warp per
// particle, pixel p = lane + 32 k in a loop. The particle's rate cache (and
// on the bridge its child cache) is its row of the output buffer, copied from
// the input at the start: every pixel belongs to one lane throughout, so the
// row needs no synchronisation, and its loads and stores are coalesced. A
// sweep's first pixel pass renders the old and the proposed star and sums
// the likelihood of the proposed rate (and child rate); on accept a second
// pass works the same proposed values out again and writes them. The file is
// compiled with -fmad=false (_build.py: SOURCE_FLAGS), so the second pass
// gives the first pass's bits, and every multiply and add rounds on its own
// as the plain version's tensor ops do. The catalogs of a block's particles
// sit in dynamic shared memory with the image and lgamma(image + 1): the only
// limit on the shape is what one block's shared memory holds
// (ops/mh_sweep.py: generic_smem_bytes).
//
// The scalar part is mh_sweep.cuh's: lane c < 3 proposes coordinate c (y, x,
// flux) with one tn_sample and takes the logs of its forward and reverse
// truncation masses, even lanes take the flux prior at the proposed flux and
// odd lanes at the old one, and __shfl_sync hands them round; lane 2 s + d
// draws Philox word set d of sweep base + s for the next 16 sweeps. The
// pixel sums are a lane's pixels in turn, then a __shfl_xor_sync butterfly:
// the order of the plain version's lane_sum with 32 lanes.
//
// The bridge (CHILD): the target is lp + tau pll + (1 - tau) cll on a joined
// tile; the child rate renders each star only into its child tile's pixel
// window: the window of the slot's fixed origin tag (tag mode; one uint8 per
// slot, so any slot count), or of the side of the star's location, coord <=
// boundary along child_axis (location mode). The frozen ghost rate the merge
// left is part of the child cache the caller seeds.
//
// Random numbers (mh_common.cuh): Philox4x32-10 keyed by the per-call key with
// the counter (particle, sweep, draw, particle >> 32), the stream of the
// plain PyTorch version (ops/mh_sweep.py) and of K1-K3.

#pragma once

#include "mh_common.cuh"
#include "mh_pixel.cuh"

// The parameters of K2g, K3g and K4g, passed by value; mirrored by
// ops/mh_sweep.py:_K3Params. child_axis is -1 on the tile target.
struct GenericParams {
  K2Params base;
  float boundary;     // pixels with coord < boundary form the even child
  int child_axis;     // 0: the children split the rows, 1: the columns
  int side_from_tag;  // 1: slot origin tags, 0: the side of the location
};

// The buffers of one launch of K2g, K3g or K4g (layouts at their entry
// points); the child buffers are null on the tile target.
struct GenericBuffers {
  const int64_t* key;
  const float *image, *temperature;
  const int32_t* counts;
  const float *locs_in, *fluxes_in, *rate_in, *pll_in, *lp_in, *crate_in,
      *cll_in;
  const uint8_t* tags;  // [G, N, M] slot origin tags (tag mode)
  float *locs_out, *fluxes_out, *rate_out, *pll_out, *lp_out, *acc_out,
      *crate_out, *cll_out;
};

namespace smcdet {

constexpr int kGenericBlock = 256;  // 8 warps: 8 particles a block
constexpr int kGenericWarps = kGenericBlock / 32;

// Dynamic shared memory of one block: the image, lgamma(image + 1) and the
// catalogs (y, x, flux per slot) of its particles.
inline size_t generic_smem_bytes(int HW, int M) {
  return sizeof(float) * (2 * (size_t)HW + (size_t)kGenericWarps * M * 3);
}

// Stage the group's image (and for Poisson noise lgamma(image + 1)) and the
// warp's catalog in shared memory; returns the catalog.
template <int NOISE>
__device__ __forceinline__ float* stage_generic(const GenericBuffers& B,
                                                int HW, int M, int64_t pid,
                                                bool valid, int lane,
                                                float** s_img,
                                                float** s_lg) {
  extern __shared__ float smem[];
  *s_img = smem;
  *s_lg = smem + HW;
  const int g = blockIdx.x;
  for (int p = threadIdx.x; p < HW; p += blockDim.x) {
    const float v = B.image[(int64_t)g * HW + p];
    (*s_img)[p] = v;
    (*s_lg)[p] = NOISE == 1 ? lgammaf(v + 1.f) : 0.f;
  }
  float* cat = smem + 2 * HW + (threadIdx.x / 32) * M * 3;
  if (valid) {
    for (int m = lane; m < M; m += 32) {
      cat[m * 3] = B.locs_in[(pid * M + m) * 2];
      cat[m * 3 + 1] = B.locs_in[(pid * M + m) * 2 + 1];
      cat[m * 3 + 2] = B.fluxes_in[pid * M + m];
    }
  }
  return cat;
}

// The particle's catalog from shared memory to the outputs.
__device__ __forceinline__ void store_catalog(const GenericBuffers& B,
                                              const float* cat, int M,
                                              int64_t pid, int lane) {
  for (int m = lane; m < M; m += 32) {
    B.locs_out[(pid * M + m) * 2] = cat[m * 3];
    B.locs_out[(pid * M + m) * 2 + 1] = cat[m * 3 + 1];
    B.fluxes_out[pid * M + m] = cat[m * 3 + 2];
  }
}

// Row and column of flat pixel p of a W-wide tile, as floats.
__device__ __forceinline__ void pixel_hw(int p, int W, float* h, float* w) {
  const int r = p / W;
  *h = (float)r;
  *w = (float)(p - r * W);
}

// One block of kGenericBlock threads holds kGenericWarps particles of group
// blockIdx.x, one warp each.
template <int NOISE, int PSF, bool CHILD>
__device__ __forceinline__ void mh_sweep_generic_body(
    const GenericBuffers& B, int N, int M, int H, int W, int num_iters,
    const GenericParams& Q) {
  constexpr unsigned kFull = 0xffffffffu;
  constexpr int AHEAD = 16;  // sweeps per Philox draw-ahead
  const int HW = H * W;
  K2Params P = Q.base;
  P.noise_kind = NOISE;
  PsfRecip R = psf_recip(P);
  R.kind = PSF;

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
  const int c = min(lane, 2);
  const float sigma_c = c < 2 ? P.locs_stdev : P.fluxes_stdev;
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

      float mass_c;
      const float prop_c =
          tn_sample(c == 0 ? u_y : c == 1 ? u_x : u_f,
                    c == 0 ? ly_j : c == 1 ? lx_j : f_j, sigma_c, lb_c, ub_c,
                    &mass_c);
      const float y_prop = __shfl_sync(kFull, prop_c, 0);
      const float x_prop = __shfl_sync(kFull, prop_c, 1);
      const float f_prop = __shfl_sync(kFull, prop_c, 2);

      bool side_old = false, side_new = false;
      if constexpr (CHILD) {
        if (Q.side_from_tag) {
          side_old = side_new = tags[j] != 0;
        } else {
          side_old = (Q.child_axis == 0 ? ly_j : lx_j) <= Q.boundary;
          side_new = (Q.child_axis == 0 ? y_prop : x_prop) <= Q.boundary;
        }
      }

      const float fy_old = floorf(ly_j), fx_old = floorf(lx_j);
      const float fy_new = floorf(y_prop), fx_new = floorf(x_prop);
      // the proposed rate (and child rate) at pixel p, the same bits on
      // every call
      auto proposed = [&](int p, float* rp, float* crp) {
        float h, w;
        pixel_hw(p, W, &h, &w);
        const float psi_old = star_pixel_recip(h, w, ly_j, lx_j, fy_old,
                                               fx_old, P.psf_radius, R);
        const float psi_new = star_pixel_recip(h, w, y_prop, x_prop, fy_new,
                                               fx_new, P.psf_radius, R);
        *rp = rate[p] + P.adu * (f_prop * psi_new - f_j * psi_old);
        if constexpr (CHILD) {
          const bool even = (Q.child_axis == 0 ? h : w) < Q.boundary;
          const float w_old = even == side_old ? 1.f : 0.f;
          const float w_new = even == side_new ? 1.f : 0.f;
          *crp = crate[p] + P.adu * (f_prop * (psi_new * w_new) -
                                     f_j * (psi_old * w_old));
        }
      };
      float pll_prop = 0.f, cll_prop = 0.f;
      for (int p = lane; p < HW; p += 32) {
        float rp, crp;
        proposed(p, &rp, &crp);
        pll_prop += pixel_loglik(s_img[p], s_lg[p], rp, P);
        if constexpr (CHILD) cll_prop += pixel_loglik(s_img[p], s_lg[p], crp, P);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        pll_prop += __shfl_xor_sync(kFull, pll_prop, off);
        if constexpr (CHILD) cll_prop += __shfl_xor_sync(kFull, cll_prop, off);
      }

      const float flp = flux_log_prob((lane & 1) ? f_j : f_prop, P);
      const float lp_prop =
          lp + (__shfl_sync(kFull, flp, 0) - __shfl_sync(kFull, flp, 1));
      const float lm = log_mass(mass_c);
      const float lm_rev = log_mass(tn_mass(prop_c, sigma_c, lb_c, ub_c));
      const float log_q =
          (__shfl_sync(kFull, lm, 0) + __shfl_sync(kFull, lm, 1)) -
          (__shfl_sync(kFull, lm_rev, 0) + __shfl_sync(kFull, lm_rev, 1)) +
          __shfl_sync(kFull, lm, 2) - __shfl_sync(kFull, lm_rev, 2);
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
      if (u_acc <= expf(capped)) {
        for (int p = lane; p < HW; p += 32) {
          float rp, crp;
          proposed(p, &rp, &crp);
          rate[p] = rp;
          if constexpr (CHILD) crate[p] = crp;
        }
        if (lane == 0) {
          cat[j * 3] = y_prop;
          cat[j * 3 + 1] = x_prop;
          cat[j * 3 + 2] = f_prop;
        }
        pll = pll_prop;
        lp = lp_prop;
        if constexpr (CHILD) cll = cll_prop;
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

// Check a launch's arguments and shared memory; 0 if they are fine. The
// dynamic shared memory above 48 KB is asked for with
// cudaFuncSetAttribute by the caller.
inline cudaError_t check_generic(int G, int N, int M, int H, int W,
                                 int num_iters, const GenericParams& Q,
                                 bool child, const GenericBuffers& B) {
  if (G <= 0 || N <= 0 || M < 1 || H < 1 || W < 1 || num_iters <= 0 ||
      Q.base.noise_kind < 0 || Q.base.noise_kind > 1 ||
      Q.base.psf_kind < 0 || Q.base.psf_kind > 2 ||
      (N + kGenericWarps - 1) / kGenericWarps > 65535) {
    return cudaErrorInvalidValue;
  }
  if (child && (Q.child_axis < 0 || Q.child_axis > 1 ||
                B.crate_in == nullptr || B.cll_in == nullptr ||
                B.crate_out == nullptr || B.cll_out == nullptr ||
                (Q.side_from_tag && B.tags == nullptr))) {
    return cudaErrorInvalidValue;
  }
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (generic_smem_bytes(H * W, M) > (size_t)optin) {
    return cudaErrorInvalidConfiguration;
  }
  return cudaSuccess;
}

// Launch `kernel` over the grid (G, ceil(N / 8)) with the shared memory
// generic_smem_bytes asks; returns the launch's error.
template <typename Kernel>
cudaError_t launch_generic(Kernel kernel, const GenericBuffers& B, int G,
                           int N, int M, int H, int W, int num_iters,
                           const GenericParams& Q, cudaStream_t stream) {
  const size_t smem = generic_smem_bytes(H * W, M);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(G, (N + kGenericWarps - 1) / kGenericWarps);
  kernel<<<grid, kGenericBlock, smem, stream>>>(B, N, M, H, W, num_iters, Q);
  return cudaGetLastError();
}

// Launch the wide kernel `Wide::get<NOISE, PSF, CHILD>()` of the
// parameters' noise and PSF kinds and of the target (one instantiation
// each, so that the pixel loop branches on neither, as K2's launch_kinds):
// the wide routes of K2g and K3g (mh_sweep_wide.cu) and of K4g
// (mala_sweep_wide.cu). Returns the CUDA error (0 on success).
template <class Wide, int NOISE, int PSF>
cudaError_t launch_wide_kind(const GenericBuffers& B, int G, int N, int M,
                             int H, int W, int num_iters,
                             const GenericParams& Q, bool child,
                             cudaStream_t s) {
  if (child) {
    return launch_generic(Wide::template get<NOISE, PSF, true>(), B, G, N,
                          M, H, W, num_iters, Q, s);
  }
  return launch_generic(Wide::template get<NOISE, PSF, false>(), B, G, N, M,
                        H, W, num_iters, Q, s);
}

template <class Wide>
int launch_wide_kinds(const GenericBuffers& B, int G, int N, int M, int H,
                      int W, int num_iters, const GenericParams& Q,
                      bool child, cudaStream_t s) {
  switch (Q.base.noise_kind * 3 + Q.base.psf_kind) {
    case 0:
      return (int)launch_wide_kind<Wide, 0, 0>(B, G, N, M, H, W, num_iters,
                                               Q, child, s);
    case 1:
      return (int)launch_wide_kind<Wide, 0, 1>(B, G, N, M, H, W, num_iters,
                                               Q, child, s);
    case 2:
      return (int)launch_wide_kind<Wide, 0, 2>(B, G, N, M, H, W, num_iters,
                                               Q, child, s);
    case 3:
      return (int)launch_wide_kind<Wide, 1, 0>(B, G, N, M, H, W, num_iters,
                                               Q, child, s);
    case 4:
      return (int)launch_wide_kind<Wide, 1, 1>(B, G, N, M, H, W, num_iters,
                                               Q, child, s);
    case 5:
      return (int)launch_wide_kind<Wide, 1, 2>(B, G, N, M, H, W, num_iters,
                                               Q, child, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace smcdet
