// Dependent FP32 / special-function chains for Hopper (sm_90a): the card's
// FP32 and SFU rates (kernel K5).
//
// Replaces the TPU microbenchmark experiments/roofline.py:_chain_bench, which
// measures the vector unit's rates with dependent chains over one (8, 128)
// f32 tile. Here one thread owns one element and carries 4 independent
// chains of it in registers; every chain step is one of four kinds, written
// in inline PTX so that nvcc neither folds a chain nor expands exp / log into
// a longer sequence. Per step, as issued (roofline.py: STEP_OPS):
//   fma:   x = fma.rn(x, 1.0000001, 1e-9)                1 FFMA (2 flops)
//   exp:   x = ex2.approx.ftz(x * -log2(e))   = exp(-x)  1 FMUL + 1 MUFU.EX2
//   rsqrt: x = rsqrt.approx.ftz(x + 1.5)                 1 FADD + 1 MUFU.RSQ
//   log:   x = lg2.approx.ftz(x + 2) * ln(2)  = log(x+2) 1 FADD + 1 MUFU.LG2
//                                                        + 1 FMUL
// The chain body is unrolled 8 times (UNROLL), as on the TPU, and the 4
// chains of a thread (STREAMS) are summed into the output, so no step is
// dead code.
//
// What bounds it: by construction, the FP32 pipe (fma) or the special-
// function unit (the others); the launch holds enough blocks to fill every
// SM with resident warps, whose independent chains hide the latency.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kUnroll = 8;
constexpr int kStreams = 4;  // independent chains per thread

template <int KIND>
__device__ __forceinline__ float step(float x) {
  float y;
  if (KIND == 0) {
    asm("fma.rn.f32 %0, %1, 0f3F800001, 0f3089705F;" : "=f"(y) : "f"(x));
  } else if (KIND == 1) {
    float t;
    asm("mul.rn.f32 %0, %1, 0fBFB8AA3B;" : "=f"(t) : "f"(x));
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(t));
  } else if (KIND == 2) {
    float t;
    asm("add.rn.f32 %0, %1, 0f3FC00000;" : "=f"(t) : "f"(x));
    asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(t));
  } else {
    float t, l;
    asm("add.rn.f32 %0, %1, 0f40000000;" : "=f"(t) : "f"(x));
    asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(l) : "f"(t));
    asm("mul.rn.f32 %0, %1, 0f3F317218;" : "=f"(y) : "f"(l));
  }
  return y;
}

template <int KIND>
__global__ void __launch_bounds__(kBlock)
chain_k5_kernel(const float* __restrict__ x0, float* __restrict__ out,
                int n, int n_chain) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  float x[kStreams];
  const float v = x0[i];
#pragma unroll
  for (int s = 0; s < kStreams; ++s) x[s] = v + 0.001f * (float)s;
  for (int c = 0; c < n_chain; ++c) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int s = 0; s < kStreams; ++s) x[s] = step<KIND>(x[s]);
    }
  }
  float acc = x[0];
#pragma unroll
  for (int s = 1; s < kStreams; ++s) acc += x[s];
  out[i] = acc;
}

}  // namespace

// Launch K5 on `stream`: kind 0 fma, 1 exp, 2 rsqrt, 3 log; x0 and out are
// contiguous f32 [n]; each element carries 4 chains of n_chain x 8 steps.
// Returns the CUDA error of the launch (0 on success).
extern "C" int smcdet_chain_k5_launch(const void* x0, void* out, int n,
                                      int kind, int n_chain, void* stream) {
  if (n <= 0 || n_chain < 0 || kind < 0 || kind > 3) {
    return (int)cudaErrorInvalidValue;
  }
  const auto* x = static_cast<const float*>(x0);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + kBlock - 1) / kBlock);
  switch (kind) {
    case 0:
      chain_k5_kernel<0><<<grid, kBlock, 0, s>>>(x, o, n, n_chain);
      break;
    case 1:
      chain_k5_kernel<1><<<grid, kBlock, 0, s>>>(x, o, n, n_chain);
      break;
    case 2:
      chain_k5_kernel<2><<<grid, kBlock, 0, s>>>(x, o, n, n_chain);
      break;
    default:
      chain_k5_kernel<3><<<grid, kBlock, 0, s>>>(x, o, n, n_chain);
  }
  return (int)cudaGetLastError();
}
