// The wide route of kernels K2g and K3g (mh_sweep_k2g.cu, mh_sweep_k3g.cu):
// tiles above 4096 pixels, and shapes where not even one warp of particles'
// caches and proposals fits a block's shared memory beside the image.
//
// Replaces, with them, the TPU kernel
// smcdet_tpu/ops/pallas_sweep.py:_make_kernel at those shapes. The sweep loop
// is mh_sweep_generic.cuh's body: one warp per particle, pixel p = lane +
// 32 k in a loop, the caches in the particle's rows of the output buffers,
// and on accept a second pass that renders the proposal again and writes
// it. Compiled with -fmad=false (_build.py: SOURCE_FLAGS), so that the
// second pass gives the first pass's bits. No path of the repository runs
// a tile this large; tests/test_torch_gpu.py holds it against the plain
// version.

#include "mh_sweep_classes.cuh"

namespace {

using namespace smcdet;

template <int NOISE, int PSF>
__global__ void __launch_bounds__(kGenericBlock)
mh_sweep_k2g_kernel_wide(const GenericBuffers B, int N, int M, int H, int W,
                         int num_iters, const GenericParams Q) {
  mh_sweep_generic_body<NOISE, PSF, false>(B, N, M, H, W, num_iters, Q);
}

template <int NOISE, int PSF>
__global__ void __launch_bounds__(kGenericBlock)
mh_sweep_k3g_kernel_wide(const GenericBuffers B, int N, int M, int H, int W,
                         int num_iters, const GenericParams Q) {
  mh_sweep_generic_body<NOISE, PSF, true>(B, N, M, H, W, num_iters, Q);
}

// the kernel of a noise and PSF kind on the bridge (CHILD) or the tile target
struct Wide {
  template <int NOISE, int PSF, bool CHILD>
  static constexpr auto get() {
    if constexpr (CHILD) {
      return mh_sweep_k3g_kernel_wide<NOISE, PSF>;
    } else {
      return mh_sweep_k2g_kernel_wide<NOISE, PSF>;
    }
  }
};

}  // namespace

namespace smcdet {

int launch_mh_wide(const GenericBuffers& B, int G, int N, int M, int H,
                   int W, int num_iters, const GenericParams& Q, bool child,
                   cudaStream_t s) {
  return launch_wide_kinds<Wide>(B, G, N, M, H, W, num_iters, Q, child, s);
}

}  // namespace smcdet
