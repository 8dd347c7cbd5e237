// Kernel K4g on the aggregation bridge target: its class kernels
// (mala_sweep_k4g.cuh's sweep loop with the child term, one per pixel class
// and noise and PSF kind), compiled beside the tile target's
// (mala_sweep_k4g.cu, which holds the entry point).
//
// Replaces the TPU kernel smcdet_tpu/ops/pallas_sweep.py:_make_mala_kernel
// in its bridge specialization wherever K4 (mala_sweep_k4.cu) is not built
// for the joined shape.

#include "mala_sweep_k4g.cuh"

namespace smcdet {

int launch_k4g_bridge(
    const void* key, const void* image, const void* temperature,
    const void* counts, const void* locs_in, const void* fluxes_in,
    const void* rate_in, const void* pll_in, const void* lp_in,
    const void* crate_in, const void* cll_in, const void* tags,
    void* locs_out, void* fluxes_out, void* rate_out, void* pll_out,
    void* lp_out, void* acc_out, void* crate_out, void* cll_out, int G,
    int N, int M, int H, int W, int num_iters, const GenericParams& Q,
    void* stream) {
  return launch_classes<Kernels<true>>(
      key, image, temperature, counts, locs_in, fluxes_in, rate_in, pll_in,
      lp_in, crate_in, cll_in, tags, locs_out, fluxes_out, rate_out, pll_out,
      lp_out, acc_out, crate_out, cll_out, G, N, M, H, W, num_iters, Q, true,
      stream);
}

}  // namespace smcdet
