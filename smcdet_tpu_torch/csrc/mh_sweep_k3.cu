// Fused single-component Metropolis-Hastings sweep loop for Hopper (sm_90a),
// the aggregation bridge target (kernel K3).
//
// Replaces the TPU kernel smcdet_tpu/ops/pallas_sweep.py:_make_kernel in its
// bridge specialization (child_axis / side_from_tag): the target is
// lp + tau * parent_ll + (1 - tau) * child_ll on a joined tile, where the
// child rate renders each star only into the pixel window of its own child
// tile: the window of the slot's fixed origin tag (tag mode), or the side of
// the star's location, coord <= boundary along child_axis (location mode).
// The child cache is updated by adu * (f' psi' w' - f psi w), with
// w = w' = the tag's window in tag mode and the windows of the old and the
// proposed location in location mode. The frozen ghost rate of the stars the
// merge dropped is part of the child cache the caller seeds; the kernel
// carries it and never renders it. Every noise, PSF and flux-prior variant
// of K2 (mh_pixel.cuh), on the joined tiles of a 2x2 grid of 8x8 tiles:
// 16x8 with up to 16 slots and 16x16 with up to 32.
//
// What bounds it on this card: FP32 and SFU work, as in K2, with a second
// likelihood per pixel (one more logf and division). At the bridge's shapes
// (2 x 512 and 1 x 512 particles) a launch is well under one wave of the
// card, so its time there is latency, not throughput.
//
// Design: K2's layout. L lanes per particle (L = 16 on 16x8, a whole warp on
// 16x16), each lane holding HW / L = 8 pixels of both caches (parent and
// child rate) in registers, pixel p = lane + L * k. The two pixel
// log-likelihood sums share one __shfl_xor_sync butterfly, which leaves the
// bit-identical totals in every lane, so every lane takes the same accept
// decision. Each lane keeps one bit per pixel for the even child's window
// and the particle keeps its origin tags as one 32-bit mask (slot m's tag is
// bit m), so the child window costs two compares per pixel. The catalog sits
// in shared memory (room for 32 slots). Padded particles (n >= N) start from
// rate = child rate = 1 and never move, so no lane takes log(0).
//
// Random numbers are K1's and K2's (mh_common.cuh): Philox4x32-10 keyed by
// the per-call key with the counter (particle, sweep, draw, particle >> 32),
// the stream of the plain PyTorch version (ops/mh_sweep.py), so the two
// agree particle by particle up to expf/logf rounding and the order of the
// pixel sums.

#include "mh_common.cuh"
#include "mh_pixel.cuh"

// The bridge's parameters, passed by value; mirrored by
// ops/mh_sweep.py:_K3Params.
struct K3Params {
  K2Params base;
  float boundary;     // pixels with coord < boundary form the even child
  int child_axis;     // 0: the children split the rows, 1: the columns
  int side_from_tag;  // 1: slot origin tags, 0: the side of the location
};

namespace {

using namespace smcdet;

constexpr int kBlock = 256;
constexpr int kMaxSlots = 32;

template <int H, int W, int L>
__global__ void __launch_bounds__(kBlock)
mh_sweep_k3_kernel(const int64_t* __restrict__ key,
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
                   float* __restrict__ rate_out, float* __restrict__ pll_out,
                   float* __restrict__ lp_out, float* __restrict__ acc_out,
                   float* __restrict__ crate_out,
                   float* __restrict__ cll_out, int N, int M, int num_iters,
                   K3Params Q) {
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
      (valid && Q.side_from_tag) ? (uint32_t)tags[pid] : 0u;
  float* cat = s_cat + local * M * 3;
  if (valid) {
    for (int m = lane; m < M; m += L) {
      cat[m * 3] = locs_in[(pid * M + m) * 2];
      cat[m * 3 + 1] = locs_in[(pid * M + m) * 2 + 1];
      cat[m * 3 + 2] = fluxes_in[pid * M + m];
    }
  }
  float rate[PPL], rate_prop[PPL], crate[PPL], crate_prop[PPL];
  uint32_t even_bits = 0;  // bit k: pixel lane + L k is in the even child
#pragma unroll
  for (int k = 0; k < PPL; ++k) {
    const int p = lane + L * k;
    rate[k] = valid ? rate_in[pid * HW + p] : 1.f;
    crate[k] = valid ? crate_in[pid * HW + p] : 1.f;
    const int coord = Q.child_axis == 0 ? p / W : p % W;
    even_bits |= ((float)coord < Q.boundary ? 1u : 0u) << k;
  }
  float pll = valid ? pll_in[pid] : 0.f;
  float cll = valid ? cll_in[pid] : 0.f;
  float lp = valid ? lp_in[pid] : 0.f;
  __syncthreads();

  const uint32_t k0 = (uint32_t)key[0];
  const uint32_t k1 = (uint32_t)key[1];
  const float tau = temperature[g];
  const float one_minus_tau = 1.f - tau;
  const bool active = count > 0;
  const float count_f = (float)count;
  int accepted = 0;
  // As in K2: a particle with no occupied slot never moves and passes
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

    float mass_y, mass_x, mass_f;
    const float y_prop = tn_sample(unit_uniform(r0[1]), ly_j, P.locs_stdev,
                                   P.loc_low_y, P.loc_high_y, &mass_y);
    const float x_prop = tn_sample(unit_uniform(r0[2]), lx_j, P.locs_stdev,
                                   P.loc_low_x, P.loc_high_x, &mass_x);
    const float f_prop = tn_sample(unit_uniform(r0[3]), f_j, P.fluxes_stdev,
                                   P.flux_lo, P.flux_hi, &mass_f);

    // the child tile that renders the moved star, before and after the move:
    // its origin tag (fixed), or the side of its old and proposed location
    bool side_old, side_new;
    if (Q.side_from_tag) {
      side_old = side_new = (side_bits >> j) & 1u;
    } else {
      side_old = (Q.child_axis == 0 ? ly_j : lx_j) <= Q.boundary;
      side_new = (Q.child_axis == 0 ? y_prop : x_prop) <= Q.boundary;
    }

    // incremental update of this lane's pixels of both caches and their
    // likelihoods
    const float fy_old = floorf(ly_j), fx_old = floorf(lx_j);
    const float fy_new = floorf(y_prop), fx_new = floorf(x_prop);
    float pll_prop = 0.f, cll_prop = 0.f;
#pragma unroll
    for (int k = 0; k < PPL; ++k) {
      const int p = lane + L * k;
      const float psi_old = star_pixel<W>(p, ly_j, lx_j, fy_old, fx_old, P);
      const float psi_new = star_pixel<W>(p, y_prop, x_prop, fy_new, fx_new, P);
      const float d = P.adu * (f_prop * psi_new - f_j * psi_old);
      const float rp = rate[k] + d;
      rate_prop[k] = rp;
      pll_prop += pixel_loglik(s_img[p], s_lg[p], rp, P);
      const bool even = (even_bits >> k) & 1u;
      const float w_old = even == side_old ? 1.f : 0.f;
      const float w_new = even == side_new ? 1.f : 0.f;
      const float dc =
          P.adu * (f_prop * (psi_new * w_new) - f_j * (psi_old * w_old));
      const float crp = crate[k] + dc;
      crate_prop[k] = crp;
      cll_prop += pixel_loglik(s_img[p], s_lg[p], crp, P);
    }
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1) {
      pll_prop += __shfl_xor_sync(0xffffffffu, pll_prop, off);
      cll_prop += __shfl_xor_sync(0xffffffffu, cll_prop, off);
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
        (((lp_prop + tau * pll_prop) + one_minus_tau * cll_prop) -
         ((lp + tau * pll) + one_minus_tau * cll)) +
        log_q;
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
        crate[k] = crate_prop[k];
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
    crate_out[pid * HW + lane + L * k] = crate[k];
  }
  if (lane == 0) {
    pll_out[pid] = pll;
    cll_out[pid] = cll;
    lp_out[pid] = lp;
    acc_out[pid] = (float)accepted / (float)num_iters;
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

template <int H, int W, int L>
cudaError_t launch(const Buffers& b, int G, int N, int M, int num_iters,
                   const K3Params& Q, cudaStream_t stream) {
  constexpr int PPB = kBlock / L;
  const dim3 grid(G, (N + PPB - 1) / PPB);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (2 * H * W + PPB * M * 3);
  mh_sweep_k3_kernel<H, W, L><<<grid, kBlock, smem, stream>>>(
      b.key, b.image, b.temperature, b.counts, b.locs_in, b.fluxes_in,
      b.rate_in, b.pll_in, b.lp_in, b.crate_in, b.cll_in, b.tags,
      b.locs_out, b.fluxes_out, b.rate_out, b.pll_out, b.lp_out, b.acc_out,
      b.crate_out, b.cll_out, N, M, num_iters, Q);
  return cudaGetLastError();
}

}  // namespace

// Launch K3 on `stream`. Tensors are contiguous: image [G, H*W],
// temperature [G], counts [G, N] int32, locs [G, N, M, 2], fluxes [G, N, M],
// rate and child rate [G, N, H*W], pll / lp / child ll / acc [G, N], origin
// tags int64 [G, N] (bit m = slot m's tag; may be null in location mode),
// key int64 [2]. Returns the CUDA error of the launch (0 on success);
// H x W must be 16x8 or 16x16 and 1 <= M <= 32.
extern "C" int smcdet_mh_sweeps_k3_launch(
    const void* key, const void* image, const void* temperature,
    const void* counts, const void* locs_in, const void* fluxes_in,
    const void* rate_in, const void* pll_in, const void* lp_in,
    const void* crate_in, const void* cll_in, const void* tags,
    void* locs_out, void* fluxes_out, void* rate_out, void* pll_out,
    void* lp_out, void* acc_out, void* crate_out, void* cll_out, int G,
    int N, int M, int H, int W, int num_iters, K3Params params,
    void* stream) {
  if (G <= 0 || N <= 0 || num_iters <= 0 || M < 1 || M > kMaxSlots ||
      (params.side_from_tag && tags == nullptr)) {
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
  if (H == 16 && W == 8) {
    return (int)launch<16, 8, 16>(b, G, N, M, num_iters, params, s);
  }
  if (H == 16 && W == 16) {
    return (int)launch<16, 16, 32>(b, G, N, M, num_iters, params, s);
  }
  return (int)cudaErrorInvalidValue;
}
