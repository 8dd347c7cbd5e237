// Fused single-component Metropolis-Hastings sweep loop for Hopper (sm_90a)
// on the aggregation bridge target at any joined-tile shape and slot count
// (kernel K3g).
//
// Replaces the TPU kernel smcdet_tpu/ops/pallas_sweep.py:_make_kernel in its
// bridge specialization (child_axis / side_from_tag) wherever K3
// (mh_sweep_k3.cu: the joined 16x8 tile with up to 16 slots and 16x16 with up
// to 32, the two levels of a 2x2 grid) is not built for the shape: levels 2
// and up of a larger grid, such as a 4x4 grid's 32x16 (64 slots) and 32x32
// (128 slots). The target is lp + tau parent_ll + (1 - tau) child_ll on the
// joined tile; the child rate renders each star into its own child tile's
// window, of the slot's origin tag (one uint8 per slot) or of the side of its
// location. Every noise, PSF and flux-prior variant of K2. The sweep loop is
// mh_sweep_classes.cuh's body (its design, shared with K2g), with the child
// term, one kernel per pixel class and noise and PSF kind; joined tiles above
// 4096 pixels take the wide route (mh_sweep_wide.cu).

#include "mh_sweep_classes.cuh"

namespace {

using namespace smcdet;

// The blocks of kClassBlock threads an SM that __launch_bounds__ names (at
// most 128 registers a thread) and the pixels a lane's loop unrolls, as
// timed on the H100 (PERF.md)
constexpr int kMinBlocks = 2;
constexpr int kUnroll = 4;

template <int CAP, int L, int NOISE, int PSF>
__global__ void __launch_bounds__(kClassBlock, kMinBlocks)
mh_sweep_k3g_kernel(const GenericBuffers B, int N, int M, int H, int W,
                    int num_iters, const GenericParams Q) {
  mh_sweep_classed_body<L, CAP / L, NOISE, PSF, true, kUnroll>(
      B, N, M, H, W, num_iters, Q);
}

// the wide route: mh_sweep_generic.cuh's body (mh_sweep_wide.cu)
struct Kernels : MhWideRoute {
  static constexpr int lanes(int cap) { return class_lanes(cap, true); }
  // the rate and child rate caches and their proposals: 4 CAP floats a
  // particle
  static constexpr int extra(int cap) { return 4 * cap; }
  template <int CAP, int NOISE, int PSF>
  static constexpr auto get() {
    return mh_sweep_k3g_kernel<CAP, lanes(CAP), NOISE, PSF>;
  }
};

}  // namespace

// Launch K3g on `stream`. Tensors are contiguous: image [G, H*W],
// temperature [G], counts [G, N] int32, locs [G, N, M, 2], fluxes [G, N, M],
// rate and child rate [G, N, H*W], pll / lp / child ll / acc [G, N], origin
// tags uint8 [G, N, M] (1 = the even child; null in location mode), key
// int64 [2]. Returns the CUDA error of the launch (0 on success;
// cudaErrorInvalidConfiguration where 8 particles' catalogs and the image
// exceed the card's shared memory per block).
extern "C" int smcdet_mh_sweeps_k3g_launch(
    const void* key, const void* image, const void* temperature,
    const void* counts, const void* locs_in, const void* fluxes_in,
    const void* rate_in, const void* pll_in, const void* lp_in,
    const void* crate_in, const void* cll_in, const void* tags,
    void* locs_out, void* fluxes_out, void* rate_out, void* pll_out,
    void* lp_out, void* acc_out, void* crate_out, void* cll_out, int G,
    int N, int M, int H, int W, int num_iters, GenericParams params,
    void* stream) {
  return launch_classes<Kernels>(
      key, image, temperature, counts, locs_in, fluxes_in, rate_in, pll_in,
      lp_in, crate_in, cll_in, tags, locs_out, fluxes_out, rate_out, pll_out,
      lp_out, acc_out, crate_out, cll_out, G, N, M, H, W, num_iters, params,
      true, stream);
}
