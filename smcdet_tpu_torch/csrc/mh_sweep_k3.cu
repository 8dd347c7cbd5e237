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
// The sweep loop is mh_sweep.cuh's body (K2's design: the scalar part split
// over a particle's lanes, the Philox words drawn ahead, reciprocals on the
// pixel path, one instantiation per noise and PSF kind), here with its child
// term. One image's bridge launches (2 x 4608 and 1 x 4608 particles) are
// 576 blocks each, 2.2 waves of the card at two blocks per SM.

#include "mh_sweep.cuh"

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
// Lanes per particle on the joined 16x8 and 16x16 tiles (each lane holds 8
// pixels of both caches), as timed on the H100: 8 and 16 lanes spill at
// 128 registers and were 19% and 25% slower (PERF.md).
constexpr int kLanesBridge16x8 = 16;
constexpr int kLanesBridge16x16 = 32;
// Blocks per SM that __launch_bounds__ asks ptxas to leave room for: two
// blocks of 256 threads hold every instantiation at 116-126 registers with
// no spills.
constexpr int kMinBlocks = 2;

// NOISE and PSF fix K2Params' noise_kind and psf_kind at compile time.
template <int H, int W, int L, int NOISE, int PSF>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
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
                   const K3Params Q) {
  const ChildArgs C{crate_in, cll_in, tags, crate_out, cll_out,
                    Q.boundary, Q.child_axis, Q.side_from_tag};
  mh_sweep_body<H, W, L, NOISE, PSF, true, kBlock>(
      key, image, temperature, counts, locs_in, fluxes_in, rate_in, pll_in,
      lp_in, locs_out, fluxes_out, rate_out, pll_out, lp_out, acc_out, N, M,
      num_iters, Q.base, C);
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

template <int H, int W, int L, int NOISE, int PSF>
cudaError_t launch(const Buffers& b, int G, int N, int M, int num_iters,
                   const K3Params& Q, cudaStream_t stream) {
  constexpr int PPB = kBlock / L;
  const dim3 grid(G, (N + PPB - 1) / PPB);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (2 * H * W + PPB * M * 3);
  mh_sweep_k3_kernel<H, W, L, NOISE, PSF><<<grid, kBlock, smem, stream>>>(
      b.key, b.image, b.temperature, b.counts, b.locs_in, b.fluxes_in,
      b.rate_in, b.pll_in, b.lp_in, b.crate_in, b.cll_in, b.tags,
      b.locs_out, b.fluxes_out, b.rate_out, b.pll_out, b.lp_out, b.acc_out,
      b.crate_out, b.cll_out, N, M, num_iters, Q);
  return cudaGetLastError();
}

// One instantiation per noise and PSF kind, as K2's.
template <int H, int W, int L>
cudaError_t launch_kinds(const Buffers& b, int G, int N, int M,
                         int num_iters, const K3Params& Q, cudaStream_t s) {
  switch (Q.base.noise_kind * 3 + Q.base.psf_kind) {
    case 0: return launch<H, W, L, 0, 0>(b, G, N, M, num_iters, Q, s);
    case 1: return launch<H, W, L, 0, 1>(b, G, N, M, num_iters, Q, s);
    case 2: return launch<H, W, L, 0, 2>(b, G, N, M, num_iters, Q, s);
    case 3: return launch<H, W, L, 1, 0>(b, G, N, M, num_iters, Q, s);
    case 4: return launch<H, W, L, 1, 1>(b, G, N, M, num_iters, Q, s);
    case 5: return launch<H, W, L, 1, 2>(b, G, N, M, num_iters, Q, s);
  }
  return cudaErrorInvalidValue;
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
  if (params.base.noise_kind < 0 || params.base.noise_kind > 1 ||
      params.base.psf_kind < 0 || params.base.psf_kind > 2 ||
      params.child_axis < 0 || params.child_axis > 1) {
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
    return (int)launch_kinds<16, 8, kLanesBridge16x8>(b, G, N, M, num_iters,
                                                      params, s);
  }
  if (H == 16 && W == 16) {
    return (int)launch_kinds<16, 16, kLanesBridge16x16>(b, G, N, M,
                                                        num_iters, params, s);
  }
  return (int)cudaErrorInvalidValue;
}
