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
// The sweep loop is mh_sweep.cuh's body (its design, shared with K3); this
// file instantiates it for the tile target, with no child term.

#include "mh_sweep.cuh"

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
  mh_sweep_body<H, W, L, NOISE, PSF, false, kBlock>(
      key, image, temperature, counts, locs_in, fluxes_in, rate_in, pll_in,
      lp_in, locs_out, fluxes_out, rate_out, pll_out, lp_out, acc_out, N, M,
      num_iters, P0, ChildArgs{});
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
