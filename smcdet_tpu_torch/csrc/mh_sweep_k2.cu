// Fused single-component Metropolis-Hastings sweep loop for Hopper (sm_90a),
// every tile target (kernels K1 and K2).
//
// Replaces the TPU kernel smcdet_tpu/ops/pallas_sweep.py:_make_kernel in its
// tile-target specializations: Gaussian noise, or Poisson noise with a
// Normal tail above normal_tail; Gaussian PSF, SDSS PSF with the beta = 3
// wing, or SDSS PSF with the general wing (1 + r2/(beta sp))^(-beta/2);
// Pareto / truncated Pareto, Normal or no flux prior; 8x8 and 16x16 tiles
// with up to 16 slots. No aggregation child term (that is kernel K3). K1 is
// the M71 main path's instantiation, the 8x8 tile with Gaussian noise and the
// beta = 3 wing; ops/mh_sweep.py names it and counts its launches apart.
//
// What bounds it on this card: instruction issue. Each update renders the
// old and the proposed star over every pixel and evaluates the likelihood of
// the proposed rate (one logf per pixel, and a division or a lgamma-free
// Poisson term), and does a scalar part once per particle: the slot choice,
// three truncated-normal proposals (two Phi and an inverse Phi each), three
// reverse truncation masses (two Phi each), six logs of masses, the flux
// prior at both fluxes and the accept test. The data sheet's bound counts
// the SFU results of that work; the kernel issues several instructions per
// SFU result.
//
// Design: L lanes per particle (4 on 8x8 tiles, 16 on 16x16, chosen by time
// on the H100, PERF.md), each lane holding HW / L = 16 pixels of the rate
// cache in registers (pixel p = lane + L * k, so the cache loads and stores
// are coalesced). A warp holds 32 / L particles. Four things keep the warp's
// issue slots on the pixels:
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
// - One instantiation per noise and PSF kind (launch_kinds), so the unrolled
//   pixel loop carries no branch on them and the compiler interleaves the
//   pixels' independent work.
//
// The pixel log-likelihood is summed by a __shfl_xor_sync butterfly, which
// leaves the bit-identical total in every lane, so every lane takes the same
// accept decision. The catalog (slot locations and fluxes) sits in shared
// memory, read by slot index and written by the particle's first lane on
// accept. A block of 256 threads shares one group (one image, one
// temperature): the image and, for Poisson noise, lgamma(image + 1) are
// staged in shared memory once per launch, as the TPU kernel precomputes
// lgamma outside its body. The flux-prior variants are branches that are
// uniform across the grid. Every lane of a warp runs the same number of
// sweeps, so every shuffle sees all its lanes.
//
// Random numbers (mh_common.cuh): Philox4x32-10 keyed by the per-call key
// with the counter (particle, sweep, draw, particle >> 32), so the stream is
// that of the plain PyTorch version (ops/mh_sweep.py), and the two agree
// particle by particle up to the library's expf/logf/lgammaf rounding, the
// reciprocals and exp2/log2 of the render, and the order of the pixel sum.
// The pixel likelihood and the flux prior are mh_pixel.cuh's, shared with K3
// and K4.

#include "mh_common.cuh"
#include "mh_pixel.cuh"

namespace {

using namespace smcdet;

constexpr int kBlock = 256;
constexpr int kMaxSlots = 16;
// Lanes per particle on 8x8 and 16x16 tiles, as timed on the H100: 8 lanes
// on 8x8 and 32 on 16x16 were 15% and 22% slower, 8 on 16x16 from even to
// 26% slower by its register count (PERF.md).
constexpr int kLanes8x8 = 4;
constexpr int kLanes16x16 = 16;
// Blocks per SM that __launch_bounds__ asks ptxas to leave room for. Naming
// one is not the same as naming none: with __launch_bounds__(256) alone
// ptxas cut the 16x16 general-wing instantiations to 80 registers and
// spilled; room for 3 took 4% off but at 80 registers with spills.
constexpr int kMinBlocks = 1;
constexpr unsigned kFull = 0xffffffffu;

// NOISE and PSF fix K2Params' noise_kind and psf_kind at compile time.
template <int H, int W, int L, int NOISE, int PSF>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
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
                   int N, int M, int num_iters, const K2Params P0) {
  constexpr int HW = H * W;
  constexpr int PPL = HW / L;        // pixels per lane
  constexpr int PPB = kBlock / L;    // particles per block
  constexpr int AHEAD = L / 2;       // sweeps per Philox draw-ahead
  static_assert(HW % L == 0 && 32 % L == 0 && L >= 4 &&
                    (W % L == 0 || L % W == 0),
                "L must divide HW and 32, hold the three proposals, and "
                "divide the row or be a multiple of it");
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

      // incremental rate update of this lane's pixels and their likelihood
      const float fy_old = floorf(ly_j), fx_old = floorf(lx_j);
      const float fy_new = floorf(y_prop), fx_new = floorf(x_prop);
      float pll_prop = 0.f;
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
      }
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1) {
        pll_prop += __shfl_xor_sync(kFull, pll_prop, off);
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

// The buffers of one launch (layouts at smcdet_mh_sweeps_k2_launch).
struct K2Buffers {
  const int64_t* key;
  const float *image, *temperature;
  const int32_t* counts;
  const float *locs_in, *fluxes_in, *rate_in, *pll_in, *lp_in;
  float *locs_out, *fluxes_out, *rate_out, *pll_out, *lp_out, *acc_out;
};

template <int H, int W, int L, int NOISE, int PSF>
cudaError_t launch(const K2Buffers& B, int G, int N, int M, int num_iters,
                   const K2Params& P, cudaStream_t stream) {
  constexpr int PPB = kBlock / L;
  const dim3 grid(G, (N + PPB - 1) / PPB);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (2 * H * W + PPB * M * 3);
  mh_sweep_k2_kernel<H, W, L, NOISE, PSF><<<grid, kBlock, smem, stream>>>(
      B.key, B.image, B.temperature, B.counts, B.locs_in, B.fluxes_in,
      B.rate_in, B.pll_in, B.lp_in, B.locs_out, B.fluxes_out, B.rate_out,
      B.pll_out, B.lp_out, B.acc_out, N, M, num_iters, P);
  return cudaGetLastError();
}

// One instantiation per noise and PSF kind, so that the unrolled pixel loop
// branches on neither (one for all was 18-25% slower; PERF.md).
template <int H, int W, int L>
cudaError_t launch_kinds(const K2Buffers& B, int G, int N, int M,
                         int num_iters, const K2Params& P, cudaStream_t s) {
  switch (P.noise_kind * 3 + P.psf_kind) {
    case 0: return launch<H, W, L, 0, 0>(B, G, N, M, num_iters, P, s);
    case 1: return launch<H, W, L, 0, 1>(B, G, N, M, num_iters, P, s);
    case 2: return launch<H, W, L, 0, 2>(B, G, N, M, num_iters, P, s);
    case 3: return launch<H, W, L, 1, 0>(B, G, N, M, num_iters, P, s);
    case 4: return launch<H, W, L, 1, 1>(B, G, N, M, num_iters, P, s);
    case 5: return launch<H, W, L, 1, 2>(B, G, N, M, num_iters, P, s);
  }
  return cudaErrorInvalidValue;
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
  if (params.noise_kind < 0 || params.noise_kind > 1 || params.psf_kind < 0 ||
      params.psf_kind > 2) {
    return (int)cudaErrorInvalidValue;
  }
  const K2Buffers B{static_cast<const int64_t*>(key),
                    static_cast<const float*>(image),
                    static_cast<const float*>(temperature),
                    static_cast<const int32_t*>(counts),
                    static_cast<const float*>(locs_in),
                    static_cast<const float*>(fluxes_in),
                    static_cast<const float*>(rate_in),
                    static_cast<const float*>(pll_in),
                    static_cast<const float*>(lp_in),
                    static_cast<float*>(locs_out),
                    static_cast<float*>(fluxes_out),
                    static_cast<float*>(rate_out),
                    static_cast<float*>(pll_out),
                    static_cast<float*>(lp_out),
                    static_cast<float*>(acc_out)};
  auto s = static_cast<cudaStream_t>(stream);
  if (H == 8 && W == 8) {
    return (int)launch_kinds<8, 8, kLanes8x8>(B, G, N, M, num_iters, params,
                                              s);
  }
  if (H == 16 && W == 16) {
    return (int)launch_kinds<16, 16, kLanes16x16>(B, G, N, M, num_iters,
                                                  params, s);
  }
  return (int)cudaErrorInvalidValue;
}
