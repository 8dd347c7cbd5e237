"""PyTorch/CUDA port of ``smcdet_tpu``: count-stratified SMC star detection.

The package mirrors the JAX package's layout (``distributions``,
``models/``, ``ops/``, ``inference/``) and keeps its public array layouts
(``locs [T, C, N, M, 2]``, ``fluxes [T, C, N, M]``, flat-pixel rate caches
``[T, C, N, H*W]``), so each function can be held against its JAX
counterpart on the same inputs. Randomness comes from explicit
``torch.Generator`` objects that live on the run's device.

The hand-written kernels are the fused MH sweep loops K1-K3
(``ops/mh_sweep.py`` + ``csrc/mh_sweep*.cu``), the fused MALA sweep loop K4
(``ops/mala_sweep.py`` + ``csrc/mala_sweep_k4.cu``) and the FP32/SFU chain
microbenchmark K5 (``roofline.py`` + ``csrc/chain_k5.cu``), built with
``nvcc`` at first use (``_build.py``). On CPU tensors every op runs its
plain PyTorch version.
"""
