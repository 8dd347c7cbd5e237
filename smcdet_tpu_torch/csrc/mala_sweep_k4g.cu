// Fused single-component MALA sweep loop for Hopper (sm_90a) at any tile
// shape and slot count (kernel K4g): the entry point and the tile target's
// class kernels. The sweep loop, its design and the lanes of each pixel
// class are mala_sweep_k4g.cuh's; the bridge's class kernels are
// mala_sweep_k4g_bridge.cu's, the wide route mala_sweep_wide.cu's.
//
// Replaces the TPU kernel smcdet_tpu/ops/pallas_sweep.py:_make_mala_kernel
// wherever K4 (mala_sweep_k4.cu) is not built for the shape.

#include "mala_sweep_k4g.cuh"

// Launch K4g on `stream`. Tensors are contiguous: image [G, H*W],
// temperature [G], counts [G, N] int32, locs [G, N, M, 2], fluxes [G, N, M],
// rate [G, N, H*W], pll / lp / acc [G, N], key int64 [2]; on the bridge
// (child_axis 0 or 1) also the child rate [G, N, H*W], the child ll [G, N]
// and the origin tags uint8 [G, N, M] (1 = the even child; null in location
// mode), which are null on the tile target (child_axis -1). Returns the CUDA
// error of the launch (0 on success; cudaErrorInvalidConfiguration where 8
// particles' catalogs and the image exceed the card's shared memory per
// block).
extern "C" int smcdet_mala_sweeps_k4g_launch(
    const void* key, const void* image, const void* temperature,
    const void* counts, const void* locs_in, const void* fluxes_in,
    const void* rate_in, const void* pll_in, const void* lp_in,
    const void* crate_in, const void* cll_in, const void* tags,
    void* locs_out, void* fluxes_out, void* rate_out, void* pll_out,
    void* lp_out, void* acc_out, void* crate_out, void* cll_out, int G,
    int N, int M, int H, int W, int num_iters, GenericParams params,
    void* stream) {
  if (params.child_axis < -1 || params.child_axis > 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (params.child_axis >= 0) {
    return launch_k4g_bridge(key, image, temperature, counts, locs_in,
                             fluxes_in, rate_in, pll_in, lp_in, crate_in,
                             cll_in, tags, locs_out, fluxes_out, rate_out,
                             pll_out, lp_out, acc_out, crate_out, cll_out, G,
                             N, M, H, W, num_iters, params, stream);
  }
  return launch_classes<Kernels<false>>(
      key, image, temperature, counts, locs_in, fluxes_in, rate_in, pll_in,
      lp_in, crate_in, cll_in, tags, locs_out, fluxes_out, rate_out, pll_out,
      lp_out, acc_out, crate_out, cll_out, G, N, M, H, W, num_iters, params,
      false, stream);
}
