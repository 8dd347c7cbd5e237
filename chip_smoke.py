"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (a failing phase raises; there is no CPU fallback):

1. device: the card's name and power limit (nvidia-smi), CUDA and nvcc
   versions; exits non-zero without a CUDA card;
2. build: compiles the kernels from ``smcdet_tpu_torch/csrc`` (one nvcc
   per source, in parallel) into ``build/``;
3. K5: the dependent FP32 / SFU chains against their plain version at
   lengths where one step more or less shows, then the card's FP32 rate
   and its ex2, rsqrt and lg2 rates with the linearity of the (n, 2n) pair
   and the SM clock (``roofline.measure``), each at most 1.05 times its
   data-sheet peak; the measured peaks give a second bound for every sweep
   kernel below;
4. K1 against plain: the fused MH sweep loop of the M71 main path against
   its plain PyTorch version at the main path's shapes (16 8x8 tiles,
   M = 6, C = 7, N = 2048): zero-count passthrough, particle-by-particle
   agreement over 20 sweeps on the shared Philox stream, every
   disagreement of 20 single-sweep steps shown to be an accept flip on
   the boundary or an accepted tail proposal within the f32 rounding of
   the inverse CDF, the time of 100 sweeps of both against the bound, and
   equilibrium statistics and rate-cache drift over 800 sweeps on two
   tiles;
5. K2 against plain, the same checks at the shapes of the ``basic`` suite
   (20 8x8 tiles, M = 8, C = 9, N = 512) and the ``cells`` suite (10
   16x16 tiles, M = 12, C = 13, N = 4096), both built from the suites'
   configs; then passthrough, agreement and flips on the K2 branches
   neither suite runs (Normal flux, the general-beta SDSS wing, Gaussian
   noise on 16x16);
6. K3 against plain on the aggregation bridge, at both bridge shapes of
   the ``divideandconquer`` suite, from real merged states (the tile SMC of
   2 images, then the merge): the same checks with both caches, the time
   of 50 sweeps at one image's launch and at 64 groups, equilibrium on 512
   particles per group; then the location-side mode and Poisson noise
   with a Gaussian PSF;
7. K4 against plain, the fused MALA sweep loop: the same checks (the
   single-sweep steps also classify the particles whose truncation masses
   lie in Phi's f32 tail) at basic's batch shapes, divideandconquer's tile
   target, K2's three branch problems and both bridge levels in tag and
   location mode, each timed beside its bound;
8. main path: the M71 quick cell (16 tiles from ``generate_images`` with
   seed 7, N = 2048, 100 sweeps per SMC iteration, systematic resampling,
   ESS 0.5) through ``run_csmc_chunked(sort_tiles=True)``, with every
   mutate call counted against K1's launch counter;
9. entry point: ``run_experiment`` on ``experiments/basic/config.yaml``
   (one batch of 20 images) and ``experiments/cells/config.yaml`` (one
   batch of 10 images) at the shipped configurations, into a temporary
   directory, with every mutate call counted against K2's launch counter
   and the basic batch's detection share held to the JAX reference's;
10. MALA entry point: the same basic batch with ``kernel.kind: mala`` (a
    copy of the config in a temporary directory, compare_kernels.py's
    steps): every mutate call a K4 launch, the detection share held to the
    JAX runner's under MALA, the count-pmf TVD against the MH batch;
11. aggregation entry point: ``run_experiment`` on one batch of 4 images
    of ``experiments/divideandconquer/config.yaml`` (K1 tile stage, K3
    bridges) and on the first 8 tiles of the m71 real-data fixture
    (``experiments/m71/config.yaml``: fitted params, per-tile backgrounds,
    K2), tile and bridge mutate calls counted against the launches, each
    level's bridge iterations and temperatures printed, the convergence
    and detection shares held to the JAX runner's;
12. MALA aggregation: the same 4 divideandconquer images with
    ``kernel.kind: mala``, K4 on the tile stage and on both bridge levels,
    held to the JAX runner's shares under MALA;
13. profile: ``torch.profiler`` over one divideandconquer image, device
    time by ``agg.*`` / ``smc.*`` range and the device's idle share.

The last two lines of standard output are the kernels' JSON record and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Share of the 16 quick-cell tiles whose posterior mean pruned count lies
# within +-1 of the true pruned count for the JAX reference
# (smcdet_tpu run_csmc_chunked, sort_tiles=True) run on CPU on the same
# tiles with the same configuration: 16/16 with seeds 0 and 1 (PERF.md).
REFERENCE_COUNT_SHARE = 1.0

# The basic suite's first batch (``run_experiment`` with num_images = 20:
# the port's simulated tiles, seed 0): its true pruned counts, and the share
# of its 20 tiles whose posterior mean pruned count lies within +-1 of them
# for the JAX runner (``smcdet_tpu.runner.run_experiment``) on the CPU on
# the same tiles at the shipped configuration: 20/20 with config seed 0,
# 19/20 with seed 1 (PERF.md). The bar is the lower of the two, the JAX
# sampler's own spread from seed to seed.
BASIC_TRUE_COUNTS = [3, 0, 1, 1, 3, 3, 5, 1, 0, 0, 3, 2, 1, 0, 0, 0, 0, 0,
                     4, 1]
BASIC_REFERENCE_COUNT_SHARE = 0.95

# The divideandconquer suite's first batch through ``run_experiment`` with
# num_images = batch_size = 4 (the port's simulated 16x16 images, config
# seed 5): their true pruned counts, and the shares the JAX runner
# (``smcdet_tpu.runner.run_experiment``) reaches on the CPU on the same
# images at the shipped configuration, with config seeds 5 and 6 (the lower
# of the two; PERF.md): every image's aggregation levels all at
# temperature 1 below the 150-iteration cap (4/4 with both seeds), and the
# posterior mean pruned count within +-1 of the truth (4/4 with both).
DNC_TRUE_COUNTS = [2, 5, 1, 4]
DNC_REFERENCE_CONVERGED_SHARE = 1.0
DNC_REFERENCE_COUNT_SHARE = 1.0

# The m71 real-data suite (experiments/m71/config.yaml: the fitted-params
# overlay, per-tile background maps) on the first 8 fixture tiles of
# experiments/m71/data/m71/tiles.npz: the share of them whose posterior mean
# pruned count lies within +-1 of ``true_counts`` for the JAX runner on the
# CPU at the shipped configuration: 5/8 with config seeds 3 and 4 (PERF.md).
M71_REFERENCE_COUNT_SHARE = 5 / 8

# MALA (kernel.kind: mala, K4). The basic batch takes the steps of
# experiments/basic/compare_kernels.py:35-36 (locs_step 0.05, fluxes_step
# 20); the share of its 20 tiles within +-1 of BASIC_TRUE_COUNTS for the JAX
# runner on the CPU on the same tiles with those steps: 19/20 with config
# seed 0 and 19/20 with seed 1 (tests/torch_reference_bars.py; PERF.md).
MALA_BASIC_STEPS = (0.05, 20.0)
BASIC_MALA_REFERENCE_COUNT_SHARE = 0.95
# divideandconquer takes its shipped kernel's locs_stdev / fluxes_stdev as
# MALA's steps: with them the JAX runner on the CPU brings every level of
# the batch's 4 images to temperature 1 below the 150-iteration cap (4/4 with
# config seeds 5 and 6) and puts the posterior mean pruned count within +-1
# of DNC_TRUE_COUNTS on 3/4 (seed 5) and 4/4 (seed 6) images
# (tests/torch_reference_bars.py; PERF.md). The bars are the lower shares.
MALA_DNC_STEPS = (0.25, 5.0)
DNC_MALA_REFERENCE_CONVERGED_SHARE = 1.0
DNC_MALA_REFERENCE_COUNT_SHARE = 0.75
# K4's branch targets (branch_problems) take the steps of the CPU parity
# tests' matching targets (tests/test_torch_mala.py: _STEPS)
BRANCH_MALA_STEPS = {"normal_flux": (0.05, 20.0),
                     "general_wing": (0.05, 0.2),
                     "gaussian_16x16": (0.02, 20.0)}

TILE = 8
REPLACES = {"K1": "smcdet_tpu/ops/pallas_sweep.py:178",
            "K2": "smcdet_tpu/ops/pallas_sweep.py:178",
            "K3": "smcdet_tpu/ops/pallas_sweep.py:178",
            "K4": "smcdet_tpu/ops/pallas_sweep.py:485",
            "K5": "experiments/roofline.py:96"}
SOURCES = {"K1": "smcdet_tpu_torch/csrc/mh_sweep.cu",
           "K2": "smcdet_tpu_torch/csrc/mh_sweep_k2.cu",
           "K3": "smcdet_tpu_torch/csrc/mh_sweep_k3.cu",
           "K4": "smcdet_tpu_torch/csrc/mala_sweep_k4.cu",
           "K5": "smcdet_tpu_torch/csrc/chain_k5.cu"}

# The least time of a sweep loop (``bound_ms``): the larger of its bytes
# over the memory rate and its operations over the peak rate of their unit.
# H100 SXM peaks (NVIDIA's data sheet): FP32 outside the tensor cores 67
# TFLOP/s, HBM3 3.35 TB/s; the special-function unit (ex2, lg2, rcp, rsqrt)
# 16 results per SM per clock (NVIDIA's CUDA C++ documentation, arithmetic
# instruction throughput, compute capability 9.0) x 132 SMs x 1.98 GHz.
PEAK_FP32 = 67e12
PEAK_SFU = 16 * 132 * 1.98e9
PEAK_BYTES = 3.35e12
# (FP32 operations, SFU operations) that the function needs, counted from
# its mathematics, not from the kernels' source. An FMA counts 2. Every
# divisor of the model and the proposal (the PSF widths and normaliser, the
# proposal stdevs) is fixed for a launch, so a division by it is one FP32
# multiply by a reciprocal worked out once on the host, and a constant
# factor folds into an FMA or an exponent. The special-function unit (ex2,
# lg2, rcp, rsqrt) is charged only where the operand depends on the
# particle.
#
# RENDER_OPS, per pixel and star rendered (the old and the proposed star):
#   geometry: dy, dx (2), r^2 = dy dy + dx dx (3), the patch test
#     |h - fy| <= R and |w - fx| <= R (4): 9 FP32;
#   Gaussian PSF, exp(-r^2 / 2s^2) / (s sqrt(2 pi)) = ex2(a r^2 + c):
#     1 FMA, 1 ex2;
#   SDSS PSF, k (exp(-r^2 / 2s1) + b exp(-r^2 / 2s2) + p0 q^(-beta/2)),
#     q = 1 + r^2 / (beta sp): the two Gaussians as ex2(a r^2 + c) (2 FMA,
#     2 ex2), q (1 FMA), the sum (2); beta = 3: p0 k rsqrt(q q q) (3 mul,
#     1 rsqrt); general beta: ex2(-beta/2 lg2 q + log2 p0 k) (1 FMA, lg2
#     and ex2).
# LOGLIK_OPS, per pixel and likelihood term (the parent's; on the bridge
# also the child's), of the proposed rate rp, summed (1):
#   Gaussian noise, -(img - rp)^2 / 2 var - ln(var) / 2 - c with
#     var = a + m rp: var (FMA), the difference and its square (2), times
#     rcp(var) (1), the two terms (2 FMA): 10 FP32, rcp and lg2;
#   Poisson noise, img ln rp - rp - lgamma(img + 1): lg2 rp (1), 1 FMA
#     (img ln 2 per pixel is fixed), 1 subtraction: 4 FP32, lg2; where rp
#     is above the Normal-tail threshold (POISSON_TAIL_OPS on top, counted
#     for the share of this run's rate-cache pixels above it), the Normal
#     form's (img - rp)^2 rcp(rp) and one more FMA: 4 FP32, rcp.
# CACHE_OPS, per pixel: rate + adu (f' psi' - f psi): mul and 2 FMA.
# CHILD_OPS, per pixel on the bridge: the child cache adds the same
#   difference inside the moved star's window (a select and an add).
# UPDATE_OPS, per update: the slot (u count, floor, min); for each of the
#   three coordinates the truncated normal's Phi at both box ends around
#   the old value and around the proposal (4 Phi, one ex2 each) and its
#   inverse CDF (lg2 and rsqrt); the log of the ratio of the six box
#   masses (one rcp, one lg2); the accept test, u <= ex2(log alpha) (one
#   ex2): 21 SFU, and about 150 FP32 for the standardising FMAs, the
#   polynomials of Phi and its inverse and the accept arithmetic.
#   PARETO_OPS on top for the Pareto flux prior: (alpha + 1) ln(f / f'),
#   one rcp and one lg2 (the Normal prior is FP32 only).
# Philox is integer work and is not counted.
RENDER_OPS = {"gaussian": (11, 1), "sdss_beta3": (20, 3), "sdss": (19, 4)}
LOGLIK_OPS = {"gaussian": (10, 2), "poisson": (4, 1)}
POISSON_TAIL_OPS = (4, 1)
CACHE_OPS = (5, 0)
CHILD_OPS = (2, 0)
UPDATE_OPS = (150, 21)
PARETO_OPS = (4, 2)
# MALA (K4) needs, on top of the render, the likelihood and the caches above
# (the cache update is two FMAs, rate - a f psi + a f' psi', about MH's):
# MALA_DERIV_OPS, per pixel and star (the current and the proposed one), the
#   derivative of the PSF in r^2 from the render's exponentials: Gaussian
#   psi c (1 mul); SDSS, t1 c1 + t2 c2 + t3 c3 / q (the wing's
#   d/dr^2 (1 + r^2 / (beta sp))^(-beta/2) = -t3 / (2 sp q)): 2 mul, 2 FMA
#   and a rcp of q (1 FP32 more for the general wing's q, 6 FP32);
# MALA_DLL_OPS, per pixel, likelihood term and point, dll/drate: Gaussian
#   noise, r / var + r^2 m / (2 var^2) - m / (2 var) with rcp(var): 7 FP32
#   and the rcp, which at the proposal is the likelihood's own (charged in
#   MALA_DLL_PROP_SFU below as 0); Poisson noise, img rcp(rate) - 1: 1 FMA
#   and a rcp at both points (the Normal tail's extra terms, 4 FP32, on the
#   share of pixels above the threshold);
# MALA_GRAD_OPS, per pixel and point, g = tau dll (1), g dpsi (1) and the
#   three sums g dpsi dy, g dpsi dx, g psi (3 FMA): 8 FP32; on the bridge
#   the child's (1 - tau) dll w and its add (2 FP32) on top, with the
#   child's dll/drate at both points, only inside the moved star's child
#   window w (MALA_CHILD_WINDOW of the pixels: half the joined tile at both
#   bridge levels);
# MALA_UPDATE_OPS, per update: the slot (as MH); for each coordinate the
#   forward sample (Phi at both box ends around mu: 2 ex2, and the inverse
#   CDF: lg2 and rsqrt), the reverse box mass around mu' (2 ex2), the two
#   squared standardised distances; the logs of the two products of three
#   masses (2 lg2), the drifts (3 FMA each way), the accept test (1 ex2):
#   21 SFU and about 190 FP32; MALA_PARETO_OPS for the Pareto prior: the log
#   ratio of the two fluxes (rcp and lg2) and its gradient -(alpha + 1) / f
#   at both (2 rcp): 4 SFU, 6 FP32.
MALA_DERIV_OPS = {"gaussian": (1, 0), "sdss_beta3": (5, 1), "sdss": (6, 1)}
MALA_DLL_OPS = {"gaussian": (7, 1), "poisson": (2, 1)}
MALA_DLL_PROP_SFU = {"gaussian": 0, "poisson": 1}
MALA_GRAD_OPS = (8, 0)
MALA_CHILD_GRAD_OPS = (2, 0)
MALA_CHILD_WINDOW = 0.5
MALA_UPDATE_OPS = (190, 21)
MALA_PARETO_OPS = (6, 4)


def build_problem(device, num_tiles=16, num_catalogs=2048, mh_steps=100,
                  max_smc_iters=100):
    """The bench's M71 quick cell. Tiles are simulated on a CPU generator
    (the same on every machine) and returned on the CPU."""
    from smcdet_tpu_torch.inference.kernels import SingleComponentMH
    from smcdet_tpu_torch.inference.smc import SMCConfig
    from smcdet_tpu_torch.models.imaging import M71ImageModel
    from smcdet_tpu_torch.models.priors import M71Prior
    from smcdet_tpu_torch.models.simulate import generate_images

    def prior_on(dev):
        return M71Prior(min_objects=0, max_objects=6, counts_rate=0.03,
                        image_height=TILE, image_width=TILE,
                        flux_alpha=0.214, flux_lower=0.252,
                        flux_upper=1804.679, pad=1.0, device=dev)

    def model_on(dev):
        return M71ImageModel(
            image_height=TILE, image_width=TILE, background=179.0,
            adu_per_nmgy=155.0,
            psf_params=(1.33, 4.82, 3.15, 3.0, 0.06, 0.002), psf_radius=8,
            noise_additive=0.0, noise_multiplicative=1.94, device=dev,
        )

    sim = generate_images(torch.Generator().manual_seed(7), prior_on("cpu"),
                          model_on("cpu"), flux_threshold=0.7,
                          loc_threshold_lower=0.0,
                          loc_threshold_upper=float(TILE),
                          num_images=num_tiles)
    kernel = SingleComponentMH(num_iters=mh_steps, locs_stdev=0.25,
                               fluxes_stdev=5.0, fluxes_min=0.252,
                               fluxes_max=1804.679, device=device)
    cfg = SMCConfig(num_catalogs=num_catalogs, ess_threshold_prop=0.5,
                    resample_method="systematic",
                    max_smc_iters=max_smc_iters,
                    flux_detection_threshold=0.7)
    return sim, prior_on(device), model_on(device), kernel, cfg


def suite_problem(device, suite):
    """The prior, image model and MH kernel of ``experiments/<suite>``'s
    shipped config, and the config itself."""
    from smcdet_tpu_torch.config import (
        build_image_model,
        build_kernel,
        build_prior,
        load_config,
    )

    cfg = load_config(f"experiments/{suite}/config.yaml")
    return (build_prior(cfg.prior, device),
            build_image_model(cfg.image_model, device),
            build_kernel(cfg.kernel, device), cfg)


def branch_problems(device):
    """K2 targets that neither suite runs: Normal flux (Poisson noise,
    Gaussian PSF, 8x8), the general-beta SDSS wing (M71 with beta = 2.5)
    and Gaussian noise on 16x16 tiles (SDSS beta = 3, Normal flux)."""
    from smcdet_tpu_torch.inference.kernels import SingleComponentMH
    from smcdet_tpu_torch.models.imaging import ImageModel, M71ImageModel
    from smcdet_tpu_torch.models.priors import M71Prior, StarPrior
    from smcdet_tpu_torch.models.psf import GaussianPSF

    def m71_model(tile, beta):
        return M71ImageModel(tile, tile, 179.0, 155.0,
                             (1.33, 4.82, 3.15, beta, 0.06, 0.002), 8, 0.0,
                             1.94, device=device)

    def star(tile):
        return StarPrior(0, 6, tile, tile, 2000.0, 300.0, pad=1.0,
                         device=device)

    normal_mh = SingleComponentMH(20, 0.25, 60.0, 500.0, 5000.0,
                                  device=device)
    return {
        "normal_flux": (star(8), ImageModel(
            8, 8, 4, GaussianPSF(1.0, device=device), noise="poisson",
            background=100.0, device=device), normal_mh),
        "general_wing": (M71Prior(0, 6, 0.03, 8, 8, 0.214, 0.252, 1804.679,
                                  pad=1.0, device=device),
                         m71_model(8, 2.5),
                         SingleComponentMH(20, 0.25, 5.0, 0.252, 1804.679,
                                           device=device)),
        "gaussian_16x16": (star(16), m71_model(16, 3.0), normal_mh),
    }


def _run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          timeout=60).stdout.strip()


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        sys.exit(1)
    from smcdet_tpu_torch import _build

    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"])
    nvcc = _run([_build.nvcc_path(), "--version"]).splitlines()
    print(smi)  # the card's name and power limit, as nvidia-smi prints them
    print(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"nvcc: {nvcc[-1] if nvcc else 'unknown'}, "
          f"{torch.cuda.device_count()} card(s)")
    return smi


def _kernel_label(mangled):
    """``name<args>`` of a mangled kernel template instantiation, e.g.
    ``mala_sweep_k4_kernel<16,8,16,1>`` (H, W, lanes, bridge)."""
    m = re.search(r"_kernelI((?:L[ib]\d+E)+)E", mangled)
    if m is None:
        return mangled[:60]
    end = m.start() + len("_kernel")
    for start in range(end - 1, 0, -1):  # the closest length prefix
        digits = re.search(r"\d+$", mangled[:start])
        if digits and any(int(digits.group()[k:]) == end - start
                          for k in range(len(digits.group()))):
            values = re.findall(r"L[ib](\d+)E", m.group(1))
            return f"{mangled[start:end]}<{','.join(values)}>"
    return mangled[:60]


def phase_build():
    from smcdet_tpu_torch import _build

    info = _build.build()
    print(f"[build] {info['path']} in {info['seconds']:.1f} s")
    for line in info["log"].splitlines():
        if "Compiling entry" in line:
            print(f"[build] {_kernel_label(line.split(chr(39))[1])}")
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")
    _build.load_library()


def _kernel_inputs(dev, prior, model, num_tiles, N, seed):
    """Kernel inputs for ``num_tiles`` tiles of a target: prior catalogs,
    an image rendered from the last stratum's first catalog, temperature
    0.8 (the test_pallas protocol)."""
    from smcdet_tpu_torch.inference.kernels import (
        TargetContext,
        init_kernel_state,
    )

    g = torch.Generator(device=dev).manual_seed(seed)
    strata, locs, fluxes = prior.sample_stratified(g, N, (num_tiles,))
    C = prior.num_counts
    counts = strata[None, :, None].expand(num_tiles, C, N).contiguous()
    images = model.sample(g, locs[:, -1, 0], fluxes[:, -1, 0]).abs()
    ctx = TargetContext(prior, model, images[:, None, None],
                        torch.full((num_tiles, 1, 1), 0.8, device=dev))
    state = init_kernel_state(ctx, counts, locs, fluxes)
    return ctx, counts, state


def _sweep_args(key, kernel, ctx, counts, state, num_iters):
    """The flattened arguments of ``mh_sweep.mh_sweeps`` for a
    ``[T, C, N]`` batch (what ``SingleComponentMH.run_from_state``
    passes)."""
    prior, model = ctx.prior, ctx.model
    T, C, N = counts.shape
    G, HW = T * C, model.height * model.width
    return [
        key, kernel.proposal(prior), prior, model,
        ctx.image.expand(T, C, 1, model.height, model.width)
        .reshape(G, HW).contiguous(),
        ctx.temperature.expand(T, C, 1).reshape(G).contiguous(),
        counts.reshape(G, N).to(torch.int32).contiguous(),
        state.locs.reshape(G, N, -1, 2).contiguous(),
        state.fluxes.reshape(G, N, -1).contiguous(),
        state.rate.reshape(G, N, HW).contiguous(),
        state.parent_ll.reshape(G, N).contiguous(),
        state.logprior.reshape(G, N).contiguous(),
        num_iters,
    ]


def _time_ms(fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()  # warm-up
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _present(state):
    """The tensors of a ``KernelState`` (the tile target has no child
    pair)."""
    return [t for t in state if t is not None]


def _agreement(a_outs, b_outs, shape):
    """Per particle: every output of the two runs equal to rtol 1e-4."""
    agree = torch.ones(shape, dtype=torch.bool, device=a_outs[0].device)
    for a, b in zip(a_outs, b_outs):
        close = torch.isclose(a, b, rtol=1e-4, atol=1e-4)
        agree &= close.reshape(shape + (-1,)).all(-1)
    return agree


def _passthrough(dev, kernel, ctx, counts, state):
    from smcdet_tpu_torch.inference.kernels import init_kernel_state

    zc = torch.zeros_like(counts)
    zstate = init_kernel_state(ctx, zc, state.locs, state.fluxes)
    kernel.backend = "auto"
    out, acc = kernel.run_from_state(
        torch.Generator(device=dev).manual_seed(1), ctx, zc, zstate)
    torch.cuda.synchronize()
    for a, b in zip(_present(out), _present(zstate)):
        assert torch.equal(a, b), "zero-count passthrough changed the state"
    assert float(acc.max()) == 0.0


def _same_stream(dev, kernel, ctx, counts, state, sweeps=20):
    """``sweeps`` fused sweeps of the kernel and of the plain version on
    one key: the share of particles that agree to rtol 1e-4, and the
    largest absolute and relative errors of pll/lp on those."""
    saved, res = kernel.num_iters, {}
    kernel.num_iters = sweeps
    for backend in ("auto", "torch"):
        kernel.backend = backend
        res[backend], _ = kernel.run_from_state(
            torch.Generator(device=dev).manual_seed(2), ctx, counts, state)
    kernel.num_iters, kernel.backend = saved, "auto"
    torch.cuda.synchronize()
    outs = [_present(res["auto"]), _present(res["torch"])]
    agree = _agreement(*outs, counts.shape)
    pairs = [(a[agree], b[agree]) for a, b in zip(*outs)
             if a.shape == counts.shape]
    abs_err = max(float((a - b).abs().max()) for a, b in pairs)
    rel_err = max(float(((a - b).abs() / b.abs().clamp(min=1.0)).max())
                  for a, b in pairs)
    return float(agree.float().mean()), abs_err, rel_err


def _flat_child(ctx, counts, state):
    """The child term of a bridge state flattened to the kernels' ``[G, N,
    ...]`` layout (None for the tile target)."""
    child = ctx.child_term(state, counts.shape)
    if child is None:
        return None
    G, N = counts.numel() // counts.shape[-1], counts.shape[-1]
    tags = child.slot_side
    return child._replace(
        rate=child.rate.reshape(G, N, -1).contiguous(),
        ll=child.ll.reshape(G, N).contiguous(),
        slot_side=None if tags is None
        else tags.reshape(G, N, -1).contiguous())


def _single_sweep_steps(dev, kernel, ctx, counts, state, sweeps=20):
    """Step the kernel and the plain version one sweep at a time on a
    shared key, both from the plain version's state, and classify every
    particle on which they disagree (to rtol 1e-4):

    - an accept flip: one accepts and the other rejects, with ``u_acc``
      within f32 rounding of the acceptance probability, ``|log u -
      min(log alpha, 0)| <= 2e-5 (|log target| + |log target'|) + 1e-4``
      (the targets are sums of H*W f32 terms; on the bridge, of both
      likelihood terms);
    - a tail proposal: both accept, every slot but the moved one is
      bit-identical, and each coordinate ``v' = mu + sigma Phi^-1(p)`` of
      the moved slot differs by at most ``sigma 8 2^-24 / phi(z) +
      1e-5 |v'|``, ``z = (v' - mu) / sigma``: a few ulps of ``p`` (2^-24
      near p = 1) through the inverse CDF, whose slope ``1 / phi(z)`` is
      large in the tail; the caches, ``pll`` and ``lp`` then follow the
      moved star.

    Anything else fails. Returns ``(flips, tail proposals, worst flip
    margin over its bound, worst proposal difference over its bound)``."""
    from smcdet_tpu_torch.distributions import truncated_normal_log_mass
    from smcdet_tpu_torch.ops import mh_sweep

    args = _sweep_args(None, kernel, ctx, counts, state, 1)
    child = _flat_child(ctx, counts, state)
    prop, prior, model = args[1], args[2], args[3]
    G, N = args[6].shape
    particle = torch.arange(G * N, device=dev).reshape(G, N)
    lo, hi = prior.loc_low, prior.loc_high
    tau = args[5][:, None]
    n_flip = n_tail = 0
    worst_flip = worst_tail = 0.0

    def advance(want):
        """The next step's inputs: the plain version's outputs."""
        args[7:12] = [t.contiguous() for t in want[:5]]
        return None if child is None else child._replace(
            rate=want[6].contiguous(), ll=want[7].contiguous())

    for s in range(sweeps):
        args[0] = torch.tensor([1000 + s, 4242], dtype=torch.int64,
                               device=dev)
        got = mh_sweep.mh_sweeps(*args, child=child)
        want = mh_sweep.mh_sweeps_reference(*args, child=child)
        dis = ~_agreement(got[:5] + got[6:], want[:5] + want[6:], (G, N))
        if not bool(dis.any()):
            child = advance(want)
            continue
        flip = dis & (got[5] != want[5])  # accepted by one only
        tail = dis & ~flip
        u_j, u_y, u_x, u_f, u_acc = mh_sweep.philox_uniforms(
            args[0].tolist(), particle, 0)
        cnt = args[6].long()
        j = torch.minimum(torch.floor(u_j * cnt).long(), cnt - 1)
        jj = j.clamp(min=0)[..., None]

        def slot(a):
            return torch.gather(a, 2, jj).squeeze(-1)

        y, x, f = slot(args[7][..., 0]), slot(args[7][..., 1]), slot(args[8])
        if bool(tail.any()):
            assert bool((got[5][tail] == 1.0).all()), "a rejected difference"
            other = (torch.arange(args[8].shape[-1], device=dev)
                     != j[..., None])[tail]
            assert torch.equal(got[1][tail][other], want[1][tail][other])
            assert torch.equal(got[0][tail][other], want[0][tail][other])
            ratios = []
            for v_got, v_want, mu, sigma in (
                    (slot(got[0][..., 0]), slot(want[0][..., 0]), y,
                     prop.locs_stdev),
                    (slot(got[0][..., 1]), slot(want[0][..., 1]), x,
                     prop.locs_stdev),
                    (slot(got[1]), slot(want[1]), f, prop.fluxes_stdev)):
                z = (v_want - mu) / sigma
                phi = torch.exp(-0.5 * z * z) * 0.3989422804014327
                bound = sigma * 8 * 2.0**-24 / phi + 1e-5 * v_want.abs()
                ratios.append(((v_got - v_want).abs() / bound)[tail])
            worst_tail = max(worst_tail, float(torch.stack(ratios).max()))
            assert worst_tail <= 1.0, f"a proposal off rounding: {worst_tail}"
            n_tail += int(tail.sum())
        if bool(flip.any()):
            # the proposal of every active particle, accepted (u_acc = 0)
            p = mh_sweep.sweep_with_uniforms(
                u_j, torch.stack([u_y, u_x], -1), u_f, torch.zeros_like(u_acc),
                prior=prior, model=model, proposal=prop,
                image_flat=args[4][:, None], temperature=tau,
                counts=args[6], locs=args[7], fluxes=args[8], rate=args[9],
                pll=args[10], lp=args[11], child=child)
            p_locs, p_fluxes, _, p_pll, p_lp = p[:5]
            yp, xp, fp = slot(p_locs[..., 0]), slot(p_locs[..., 1]), slot(
                p_fluxes)
            lm = truncated_normal_log_mass
            log_q = (lm(y, prop.locs_stdev, lo[0], hi[0])
                     + lm(x, prop.locs_stdev, lo[1], hi[1])
                     - lm(yp, prop.locs_stdev, lo[0], hi[0])
                     - lm(xp, prop.locs_stdev, lo[1], hi[1])
                     + lm(f, prop.fluxes_stdev, prop.flux_lo, prop.flux_hi)
                     - lm(fp, prop.fluxes_stdev, prop.flux_lo, prop.flux_hi))
            old = args[11] + tau * args[10]
            new = p_lp + tau * p_pll
            if child is not None:  # the bridge's child likelihood term
                old = old + (1.0 - tau) * child.ll
                new = new + (1.0 - tau) * p[7]
            log_alpha = new - old + log_q
            margin = (torch.log(u_acc) - log_alpha.clamp(max=0.0)).abs()
            bound = 2e-5 * (old.abs() + new.abs()) + 1e-4
            worst_flip = max(worst_flip, float((margin / bound)[flip].max()))
            assert worst_flip <= 1.0, f"a flip off the boundary: {worst_flip}"
            n_flip += int(flip.sum())
        child = advance(want)
    torch.cuda.synchronize()
    return n_flip, n_tail, worst_flip, worst_tail


def _equilibrium(dev, label, kernel, ctx, counts, state):
    """800 sweeps of each on different streams: tempered-target q50/q75
    within 5% + 5 nats, acceptance within 0.02 (the bounds of
    tests/test_pallas.py:107-154), and the kernel's caches (the rate, and
    the child rate on the bridge) against a fresh render."""
    from smcdet_tpu_torch.inference.kernels import init_kernel_state

    saved, res = kernel.num_iters, {}
    kernel.num_iters = 800
    for backend, seed in (("auto", 5), ("torch", 6)):
        kernel.backend = backend
        res[backend] = kernel.run_from_state(
            torch.Generator(device=dev).manual_seed(seed), ctx, counts,
            state)
    kernel.num_iters, kernel.backend = saved, "auto"
    torch.cuda.synchronize()
    (stk, acck), (stp, accp) = res["auto"], res["torch"]
    ltk = ctx.combine(stk.logprior, stk.parent_ll, stk.child_ll)
    ltp = ctx.combine(stp.logprior, stp.parent_ll, stp.child_ll)
    ltk, ltp = (x.flatten().cpu().numpy() for x in (ltk, ltp))
    for q in (50, 75):
        a, b = np.percentile(ltp, q), np.percentile(ltk, q)
        print(f"[{label}] 800 sweeps q{q}: plain {a:.3f} kernel {b:.3f}")
        assert abs(a - b) <= 0.05 * abs(a) + 5.0, (q, a, b)
    ak, ap = float(acck.mean()), float(accp.mean())
    print(f"[{label}] 800 sweeps acceptance: plain {ap:.5f} kernel {ak:.5f}")
    assert abs(ak - ap) < 0.02
    fresh = init_kernel_state(ctx, counts, stk.locs, stk.fluxes)
    for cache, ll in (("rate", "parent_ll"), ("child_rate", "child_ll")):
        if getattr(fresh, cache) is None:
            continue
        a, b = getattr(stk, cache), getattr(fresh, cache)
        drift = float(((a - b).abs() / b.abs().clamp(min=1.0)).max())
        a, b = getattr(stk, ll), getattr(fresh, ll)
        ll_drift = float(((a - b).abs() / b.abs().clamp(min=1.0)).max())
        print(f"[{label}] {cache} cache vs fresh render: max rel "
              f"{drift:.3e}; {ll} max rel {ll_drift:.3e}")
        assert drift < 2e-3 and ll_drift < 2e-3
    lp_err = float((stk.logprior - fresh.logprior).abs().max())
    print(f"[{label}] logprior max abs {lp_err:.3e}")
    assert lp_err < 0.01


def _print_steps(label, counts, steps):
    n_flip, n_tail, worst_flip, worst_tail = steps
    print(f"[{label}] 20 single-sweep steps, {20 * counts.numel()} "
          f"particle-sweeps: {n_flip} accept flips on the boundary "
          f"(largest margin {worst_flip:.3f} of its bound), {n_tail} "
          f"accepted tail proposals within the inverse-CDF rounding "
          f"(largest {worst_tail:.3f} of its bound)")


def kernel_vs_plain(dev, label, name, prior, model, kernel, num_tiles, N,
                    peaks):
    """Kernel ``name`` (K1 or K2) against its plain version on a target at
    ``num_tiles`` tiles x C strata x N particles, its bound also at K5's
    measured ``peaks``. Returns its record."""
    from smcdet_tpu_torch.ops import mh_sweep

    M = prior.max_objects
    assert mh_sweep.sweep_kernel(prior, model, M) == name
    ctx, counts, state = _kernel_inputs(dev, prior, model, num_tiles, N, 0)
    G = counts.numel() // N
    shape = (f"{num_tiles} tiles x {prior.num_counts} x {N}, "
             f"{model.height}x{model.width}, M={M}")
    _passthrough(dev, kernel, ctx, counts, state)
    print(f"[{label}] {name} at {shape}: zero-count passthrough bit-exact, "
          f"acc 0")
    share, abs_err, rel_err = _same_stream(dev, kernel, ctx, counts, state)
    print(f"[{label}] 20 sweeps, same stream: {share:.6f} of particles "
          f"agree to rtol 1e-4; on those, pll/lp max abs err "
          f"{abs_err:.3e}, max rel err {rel_err:.3e}")
    assert share >= 0.99, share
    _print_steps(label, counts,
                 _single_sweep_steps(dev, kernel, ctx, counts, state))

    args = _sweep_args(torch.tensor([12345, 67890], dtype=torch.int64,
                                    device=dev), kernel, ctx, counts, state,
                       100)
    ms = _time_ms(lambda: mh_sweep.mh_sweeps(*args), reps=5)
    plain_ms = _time_ms(lambda: mh_sweep.mh_sweeps_reference(*args), reps=1)
    updates = G * N * 100
    bound_ms, bound_by = sweep_bound(prior, model, args[6], args[9],
                                     M, 100)
    measured_ms, _ = sweep_bound(prior, model, args[6], args[9], M, 100,
                                 peaks=peaks)
    print(f"[{label}] 100 sweeps, {G} groups x {N} particles: kernel "
          f"{ms:.3f} ms ({updates / (ms * 1e-3):.4e} updates/s), plain "
          f"{plain_ms:.3f} ms ({updates / (plain_ms * 1e-3):.4e} "
          f"updates/s), bound {bound_ms:.4f} ms ({bound_by}; at K5's "
          f"measured rates {measured_ms:.4f} ms)")
    del ctx, counts, state, args
    # equilibrium on two tiles (the size of tests/test_pallas.py:107-154)
    ctx, counts, state = _kernel_inputs(dev, prior, model, 2, N, 0)
    _equilibrium(dev, label, kernel, ctx, counts, state)
    return {"max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def branch_check(dev, label, prior, model, kernel, num_tiles=2, N=1000):
    """Passthrough, same-stream agreement and flips of K2 on a branch."""
    from smcdet_tpu_torch.ops import mh_sweep

    assert mh_sweep.sweep_kernel(prior, model, prior.max_objects) == "K2"
    ctx, counts, state = _kernel_inputs(dev, prior, model, num_tiles, N, 0)
    _passthrough(dev, kernel, ctx, counts, state)
    share, abs_err, _ = _same_stream(dev, kernel, ctx, counts, state)
    print(f"[{label}] K2 passthrough bit-exact; 20 sweeps: {share:.6f} "
          f"agree (pll/lp max abs err {abs_err:.3e})")
    _print_steps(label, counts,
                 _single_sweep_steps(dev, kernel, ctx, counts, state))
    assert share >= 0.99, share
    return abs_err


def sweep_bound(prior, model, counts, rate, M, sweeps, child=False,
                mala=False, peaks=(PEAK_FP32, PEAK_SFU)):
    """``(bound_ms, bound_by)`` of ``sweeps`` sweeps over particles with
    ``counts [G, N]`` and rate cache ``rate [G, N, H*W]`` (only particles
    with a star move, so only theirs are counted) on the tile target or,
    with ``child``, the bridge's; MH sweeps, or with ``mala`` MALA's.
    ``peaks`` are the FP32 (flop/s) and SFU (results/s) rates: the data
    sheet's, or K5's measured ones."""
    from smcdet_tpu_torch.distributions import TruncatedPareto
    from smcdet_tpu_torch.models.priors import ParetoFlux
    from smcdet_tpu_torch.models.psf import GaussianPSF

    G, N = counts.shape
    HW = model.height * model.width
    updates = int((counts > 0).sum()) * sweeps
    psf = ("gaussian" if isinstance(model.psf, GaussianPSF)
           else "sdss_beta3" if model.psf.wing_beta3 else "sdss")
    terms = 2 if child else 1
    tail = 0.0
    if model.noise == "poisson":
        tail = float((rate > model.normal_tail_threshold).float().mean())
    pareto = isinstance(prior.flux, (TruncatedPareto, ParetoFlux))
    noise = model.noise
    ops = [HW * (2 * RENDER_OPS[psf][i]
                 + terms * (LOGLIK_OPS[noise][i]
                            + tail * POISSON_TAIL_OPS[i])
                 + CACHE_OPS[i] + (CHILD_OPS[i] if child else 0))
           + UPDATE_OPS[i] + (PARETO_OPS[i] if pareto else 0)
           for i in (0, 1)]
    if mala:
        dll_fp32 = MALA_DLL_OPS[noise][0] + tail * POISSON_TAIL_OPS[0]
        dll = (2 * dll_fp32, MALA_DLL_OPS[noise][1]
               + MALA_DLL_PROP_SFU[noise])  # the current point and proposal
        # the child's dll and gradient terms, inside its window only
        child_ops = [CHILD_OPS[i] + MALA_CHILD_WINDOW * (
            dll[i] + 2 * MALA_CHILD_GRAD_OPS[i]) if child else 0
            for i in (0, 1)]
        ops = [HW * (2 * (RENDER_OPS[psf][i] + MALA_DERIV_OPS[psf][i])
                     + terms * (LOGLIK_OPS[noise][i]
                                + tail * POISSON_TAIL_OPS[i])
                     + dll[i] + CACHE_OPS[i] + 2 * MALA_GRAD_OPS[i]
                     + child_ops[i])
               + MALA_UPDATE_OPS[i] + (MALA_PARETO_OPS[i] if pareto else 0)
               for i in (0, 1)]
    ops_s = max(updates * ops[0] / peaks[0], updates * ops[1] / peaks[1])
    # each input read once and each output written once: image and
    # temperature per group; counts, catalog, caches, pll, lp (and child
    # ll, tags) per particle in; catalog, caches, pll, lp, acc out
    per_particle = (4 + 12 * M + 4 * HW * terms + 8 + 12 * (terms - 1)) + (
        12 * M + 4 * HW * terms + 12 + 4 * (terms - 1))
    nbytes = G * (4 * HW + 4) + G * N * per_particle
    bytes_s = nbytes / PEAK_BYTES
    if ops_s >= bytes_s:
        return ops_s * 1e3, "operations"
    return bytes_s * 1e3, "bytes"


def _dnc_problem(dev):
    """The divideandconquer suite's config on the card: its full-image
    prior, image model and MH kernel, the tile-level prior and model, and
    the aggregation config."""
    from smcdet_tpu_torch.config import (
        build_image_model,
        build_kernel,
        build_prior,
        load_config,
    )
    from smcdet_tpu_torch.inference.aggregate import (
        AggregateConfig,
        expand_prior,
    )

    cfg = load_config("experiments/divideandconquer/config.yaml")
    prior = build_prior(cfg.prior, dev)
    model = build_image_model(cfg.image_model, dev)
    kernel = build_kernel(cfg.kernel, dev)
    td = cfg.sampler.tile_dim
    a = cfg.aggregation
    agg_cfg = AggregateConfig(
        ess_threshold_prop=a.ess_threshold_prop,
        resample_method=a.resample_method, max_smc_iters=a.max_smc_iters,
        relocate_sweeps=a.relocate_sweeps)
    return (cfg, expand_prior(prior, td, td, prior.max_objects),
            model.with_shape(td, td), kernel, agg_cfg)


def bridge_states(dev):
    """Real inputs of K3 at both bridge shapes: the tile SMC of the
    divideandconquer suite's first 2 images (the port's simulated 16x16
    images, the shipped config), merged to level 0 (2 merged 16x8 tiles of
    C*N = 4608 particles per image, M = 16); the level-0 bridge run, merged
    to level 1 (one 16x16 tile per image, M = 32). Each level's two images
    are stacked along the grid's first axis; the bridge context is at
    temperature 0.5. Returns the MH kernel and ``[(ctx, counts, state)]``
    for levels 0 and 1."""
    from smcdet_tpu_torch.inference.aggregate import (
        Aggregate,
        SideMask,
        _merge,
        _run_level,
        expand_prior,
    )
    from smcdet_tpu_torch.inference.kernels import (
        TargetContext,
        init_kernel_state,
    )
    from smcdet_tpu_torch.inference.smc import SMCSampler
    from smcdet_tpu_torch.runner import simulate_tiles

    cfg, prior, model, kernel, agg_cfg = _dnc_problem(dev)
    cfg.num_images = 2
    s = cfg.sampler
    gen = torch.Generator(device=dev).manual_seed(11)
    merged = [[], []]
    for img in simulate_tiles(cfg)["images"]:
        sampler = SMCSampler(
            torch.as_tensor(img, device=dev), s.tile_dim, prior, model,
            kernel, num_catalogs=s.num_catalogs,
            ess_threshold_prop=s.ess_threshold_prop,
            resample_method=s.resample_method,
            flux_detection_threshold=s.flux_detection_threshold,
            max_smc_iters=s.max_smc_iters)
        sampler.run(gen)
        state = Aggregate.from_smc(sampler).state
        merged[0].append(_merge(gen, state, 0, (2, 2, 8, 8), 16, agg_cfg,
                                model.with_shape(16, 8)))
        state, _ = _run_level(gen, state, prior, model, kernel, agg_cfg, 0,
                              (2, 2, 8, 8))
        merged[1].append(_merge(gen, state, 1, (1, 2, 16, 8), 32, agg_cfg,
                                model.with_shape(16, 16)))
    out = []
    for (axis, M, (h, w)), level in zip(((0, 16, (16, 8)), (1, 32, (16, 16))),
                                        merged):
        st = [torch.cat([m[0][i] for m in level]) for i in range(6)]
        side = torch.cat([m[1] for m in level])
        ghost = torch.cat([m[2] for m in level])
        data, counts, locs, fluxes = st[:4]
        model_l = model.with_shape(h, w)
        ctx = TargetContext(
            expand_prior(prior, h, w, M), model_l, data[:, :, None],
            torch.full(counts.shape[:2] + (1,), 0.5, device=dev),
            child_model=model_l, child_side_mask=SideMask(axis, 8, h, w),
            child_slot_side=side, child_ghost_rate=ghost)
        out.append((ctx, counts, init_kernel_state(ctx, counts, locs,
                                                   fluxes)))
    return kernel, out


def _first_particles(ctx, counts, state, n):
    """The bridge problem cut to its first ``n`` particles per group."""
    cut = [None if v is None else v[:, :, :n] for v in state]
    tags = ctx.child_slot_side
    return (ctx._replace(child_slot_side=None if tags is None
                         else tags[:, :, :n],
                         child_ghost_rate=ctx.child_ghost_rate[:, :, :n]),
            counts[:, :, :n], type(state)(*cut))


def _groups(args, child, groups):
    """Flattened kernel arguments with ``groups`` groups: the first ones,
    or the groups repeated to fill the card."""
    G = args[4].shape[0]

    def take(t):
        if groups <= G:
            return t[:groups].contiguous()
        reps = -(-groups // G)
        return t.repeat((reps,) + (1,) * (t.ndim - 1))[:groups].contiguous()

    out = list(args)
    out[4:12] = [take(t) for t in args[4:12]]
    child = child._replace(rate=take(child.rate), ll=take(child.ll),
                           slot_side=None if child.slot_side is None
                           else take(child.slot_side))
    return out, child


def bridge_vs_plain(dev, label, kernel, ctx, counts, state, peaks,
                    sweeps=50):
    """K3 against its plain version on a bridge state: zero-count
    passthrough, same-stream agreement over 20 sweeps, 20 single-sweep
    steps, the time of ``sweeps`` sweeps at one image's launch and at 64
    groups of the same shape (a batch that fills the card), and the
    equilibrium over 800 sweeps on the first 512 particles of each group.
    Returns the record of the one-image launch."""
    from smcdet_tpu_torch.ops import mh_sweep

    Th, Tw, N = counts.shape
    M = state.fluxes.shape[-1]
    model = ctx.model
    assert mh_sweep.sweep_kernel(ctx.prior, model, M, child=True) == "K3"
    mode = ("origin tags" if ctx.child_slot_side is not None
            else "location sides")
    shape = f"{model.height}x{model.width}, M={M}, {mode}"
    _passthrough(dev, kernel, ctx, counts, state)
    print(f"[{label}] K3 at {Th * Tw} groups x {N}, {shape}: zero-count "
          f"passthrough bit-exact, acc 0")
    share, abs_err, rel_err = _same_stream(dev, kernel, ctx, counts, state)
    print(f"[{label}] 20 sweeps, same stream: {share:.6f} of particles "
          f"agree to rtol 1e-4 (both caches); on those, pll/cll/lp max abs "
          f"err {abs_err:.3e}, max rel err {rel_err:.3e}")
    assert share >= 0.99, share
    _print_steps(label, counts,
                 _single_sweep_steps(dev, kernel, ctx, counts, state))

    key = torch.tensor([12345, 67890], dtype=torch.int64, device=dev)
    args = _sweep_args(key, kernel, ctx, counts, state, sweeps)
    child = _flat_child(ctx, counts, state)
    record = {"max_abs_err": abs_err}
    for groups in (Tw, 64):  # one image's launch, and 64 groups
        a, c = _groups(args, child, groups)
        ms = _time_ms(lambda: mh_sweep.mh_sweeps(*a, child=c), reps=5)
        plain_ms = _time_ms(lambda: mh_sweep.mh_sweeps_reference(
            *a, child=c), reps=1)
        bound_ms, bound_by = sweep_bound(ctx.prior, model, a[6], a[9], M,
                                         sweeps, child=True)
        measured_ms, _ = sweep_bound(ctx.prior, model, a[6], a[9], M,
                                     sweeps, child=True, peaks=peaks)
        updates = a[6].numel() * sweeps
        print(f"[{label}] {sweeps} sweeps, {groups} groups x {N} particles: "
              f"kernel {ms:.3f} ms ({updates / (ms * 1e-3):.4e} updates/s), "
              f"plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}; at K5's measured rates {measured_ms:.4f} ms)")
        if groups == Tw:
            record.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by,
                          shape=f"{groups} groups x {N}, {shape}")
    _equilibrium(dev, label, kernel, *_first_particles(ctx, counts, state,
                                                         512))
    return record


def bridge_branch_check(dev, label, kernel, ctx, counts, state):
    """Passthrough, same-stream agreement and flips of K3 on a branch."""
    from smcdet_tpu_torch.ops import mh_sweep

    M = state.fluxes.shape[-1]
    assert mh_sweep.sweep_kernel(ctx.prior, ctx.model, M, child=True) == "K3"
    _passthrough(dev, kernel, ctx, counts, state)
    share, abs_err, _ = _same_stream(dev, kernel, ctx, counts, state)
    print(f"[{label}] K3 passthrough bit-exact; 20 sweeps: {share:.6f} "
          f"agree (pll/cll/lp max abs err {abs_err:.3e})")
    _print_steps(label, counts,
                 _single_sweep_steps(dev, kernel, ctx, counts, state))
    assert share >= 0.99, share
    return abs_err


def poisson_bridge(dev, N=2048):
    """A K3 branch the suites do not run: Poisson noise, a Gaussian PSF and
    a Normal flux prior on the joined 16x16 tile (M = 32), random catalogs
    with counts varying per particle, origin tags and a ghost rate."""
    from smcdet_tpu_torch.inference.aggregate import SideMask, expand_prior
    from smcdet_tpu_torch.inference.kernels import (
        SingleComponentMH,
        TargetContext,
        init_kernel_state,
    )
    from smcdet_tpu_torch.models.imaging import ImageModel
    from smcdet_tpu_torch.models.priors import StarPrior
    from smcdet_tpu_torch.models.psf import GaussianPSF

    prior = expand_prior(StarPrior(0, 16, 8, 8, 2000.0, 300.0, pad=1.0,
                                   device=dev), 16, 16, 32)
    model = ImageModel(16, 16, 4, GaussianPSF(1.0, device=dev),
                       noise="poisson", background=100.0, device=dev)
    kernel = SingleComponentMH(20, 0.25, 60.0, 500.0, 5000.0, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    counts = torch.randint(0, 33, (1, 2, N), generator=g, device=dev,
                           dtype=torch.int32)
    locs, fluxes = prior.sample_marks(g, counts, (1, 2, N))
    tags = (torch.rand((1, 2, N, 32), generator=g, device=dev) < 0.5).float()
    ghost = 50.0 * torch.rand((1, 2, N, 256), generator=g, device=dev)
    images = model.sample(g, locs[0, :, 0, :8], fluxes[0, :, 0, :8]).abs()
    ctx = TargetContext(prior, model, images[None, :, None],
                        torch.full((1, 2, 1), 0.5, device=dev),
                        child_model=model,
                        child_side_mask=SideMask(1, 8, 16, 16),
                        child_slot_side=tags, child_ghost_rate=ghost)
    return kernel, ctx, counts, init_kernel_state(ctx, counts, locs, fluxes)


def phase_bridge_kernel(dev, kernel, levels, peaks):
    """K3 against its plain version at both bridge shapes (``levels``, from
    ``bridge_states``), then its branches: the location-side mode and
    Poisson noise."""
    from smcdet_tpu_torch.inference.kernels import init_kernel_state

    records = [bridge_vs_plain(dev, f"K3 level {i}", kernel, *lv, peaks)
               for i, lv in enumerate(levels)]
    ctx, counts, state = levels[0]
    loc_ctx = ctx._replace(child_slot_side=None)
    errs = [bridge_branch_check(
        dev, "K3 location sides", kernel, loc_ctx, counts,
        init_kernel_state(loc_ctx, counts, state.locs, state.fluxes)),
        bridge_branch_check(dev, "K3 poisson", *poisson_bridge(dev))]
    rec = dict(records[0])
    rec["max_abs_err"] = max([r["max_abs_err"] for r in records] + errs)
    print(f"[K3] level 1 ({records[1]['shape']}): {records[1]['ms']:.3f} ms "
          f"vs plain {records[1]['plain_ms']:.3f} ms per 50 sweeps, bound "
          f"{records[1]['bound_ms']:.4f} ms; the K3 record below is level "
          f"0's ({rec['shape']})")
    return rec


def mala_kernel_for(kernel, steps, device):
    """A MALA kernel with ``kernel``'s sweeps and flux bounds and the MALA
    steps ``(locs_step, fluxes_step)``."""
    from smcdet_tpu_torch.inference.kernels import SingleComponentMALA

    return SingleComponentMALA(kernel.num_iters, steps[0], steps[1],
                               kernel.fluxes_min, kernel.fluxes_max,
                               device=device)


def _mala_single_sweep_steps(dev, kernel, ctx, counts, state, sweeps=20):
    """K4's counterpart of ``_single_sweep_steps``: step K4 and its plain
    version one sweep at a time on a shared key, both from the plain
    version's state, and classify every particle on which they disagree
    (to rtol 1e-4) by the plain version's proposal
    (``mala_sweep.mala_proposal``):

    - a tail mass: one of the six truncation masses of its two proposal
      densities is below 1e-3 (``mala_sweep.smallest_box_mass``), a
      difference of two f32 values of Phi near 1, which the drifted means'
      last bits (their gradient sums run in another order) can move by
      whole ulps;
    - an accept flip on the boundary, as for K1-K3: ``|log u - min(log
      alpha, 0)| <= 2e-5 (|log target| + |log target'|) + 1e-4``;
    - a tail proposal: both accept, every other slot is bit-identical, and
      each coordinate of the moved slot differs by at most ``sigma 8 2^-24 /
      phi(z) + 1e-5 |v'| + 1e-4 |mu - v|``: the inverse CDF's rounding, as
      for K1-K3, plus the drifted mean's, whose gradient sums the kernel
      takes in another order (1e-4 of the drift ``mu - v``).

    Anything else fails. Returns ``(flips, tail proposals, tail masses,
    worst flip margin over its bound, worst proposal difference over its
    bound)``."""
    from smcdet_tpu_torch.ops import mala_sweep, mh_sweep

    args = _sweep_args(None, kernel, ctx, counts, state, 1)
    child = _flat_child(ctx, counts, state)
    prop, prior, model = args[1], args[2], args[3]
    G, N = args[6].shape
    particle = torch.arange(G * N, device=dev).reshape(G, N)
    tau = args[5][:, None]
    n_flip = n_tail = n_mass = 0
    worst_flip = worst_tail = 0.0

    def advance(want):
        """The next step's inputs: the plain version's outputs."""
        args[7:12] = [t.contiguous() for t in want[:5]]
        return None if child is None else child._replace(
            rate=want[6].contiguous(), ll=want[7].contiguous())

    for s in range(sweeps):
        args[0] = torch.tensor([2000 + s, 4242], dtype=torch.int64,
                               device=dev)
        got = mala_sweep.mala_sweeps(*args, child=child)
        want = mala_sweep.mala_sweeps_reference(*args, child=child)
        dis = ~_agreement(got[:5] + got[6:], want[:5] + want[6:], (G, N))
        if not bool(dis.any()):
            child = advance(want)
            continue
        u_j, u_y, u_x, u_f, u_acc = mh_sweep.philox_uniforms(
            args[0].tolist(), particle, 0)
        q = mala_sweep.mala_proposal(
            u_j, torch.stack([u_y, u_x], -1), u_f, prior=prior, model=model,
            proposal=prop, image_flat=args[4][:, None], temperature=tau,
            counts=args[6], locs=args[7], fluxes=args[8], rate=args[9],
            pll=args[10], lp=args[11], child=child)
        mass = dis & (mala_sweep.smallest_box_mass(q, prop, prior) < 1e-3)
        flip = dis & ~mass & (got[5] != want[5])  # accepted by one only
        tail = dis & ~mass & ~flip
        jj = q.onehot.long().argmax(-1, keepdim=True)

        def slot(a):
            return torch.gather(a, 2, jj).squeeze(-1)

        if bool(tail.any()):
            assert bool((got[5][tail] == 1.0).all()), "a rejected difference"
            other = ~q.onehot[tail]
            assert torch.equal(got[1][tail][other], want[1][tail][other])
            assert torch.equal(got[0][tail][other], want[0][tail][other])
            ratios = []
            for d, sigma in ((0, prop.locs_stdev), (1, prop.locs_stdev),
                             (2, prop.fluxes_stdev)):
                if d < 2:
                    v_got, v_want = slot(got[0][..., d]), slot(want[0][..., d])
                    mu, v = q.mu_loc[..., d], q.loc[..., d]
                else:
                    v_got, v_want, mu, v = slot(got[1]), slot(want[1]), \
                        q.mu_f, q.f
                z = (v_want - mu) / sigma
                phi = torch.exp(-0.5 * z * z) * 0.3989422804014327
                bound = (sigma * 8 * 2.0**-24 / phi + 1e-5 * v_want.abs()
                         + 1e-4 * (mu - v).abs())
                ratios.append(((v_got - v_want).abs() / bound)[tail])
            worst_tail = max(worst_tail, float(torch.stack(ratios).max()))
            assert worst_tail <= 1.0, f"a proposal off rounding: {worst_tail}"
            n_tail += int(tail.sum())
        if bool(flip.any()):
            margin = (torch.log(u_acc) - q.log_alpha.clamp(max=0.0)).abs()
            old = args[11] + tau * args[10]
            new = q.lp + tau * q.pll
            if child is not None:  # the bridge's child likelihood term
                old = old + (1.0 - tau) * child.ll
                new = new + (1.0 - tau) * q.cll
            bound = 2e-5 * (old.abs() + new.abs()) + 1e-4
            worst_flip = max(worst_flip, float((margin / bound)[flip].max()))
            assert worst_flip <= 1.0, f"a flip off the boundary: {worst_flip}"
            n_flip += int(flip.sum())
        n_mass += int(mass.sum())
        child = advance(want)
    torch.cuda.synchronize()
    return n_flip, n_tail, n_mass, worst_flip, worst_tail


def mala_vs_plain(dev, label, kernel, ctx, counts, state, sweeps, eq_problem,
                  peaks):
    """K4 against its plain version on a tile or bridge target: zero-count
    passthrough, same-stream agreement over 20 sweeps, 20 single-sweep
    steps, the time of ``sweeps`` sweeps beside the bound (the data sheet's
    and at K5's measured ``peaks``), and the equilibrium over 800 sweeps on
    ``eq_problem`` (a cut of the same target). Returns its record."""
    from smcdet_tpu_torch.ops import mala_sweep

    M = state.fluxes.shape[-1]
    child = _flat_child(ctx, counts, state)
    model = ctx.model
    assert mala_sweep.mala_kernel(ctx.prior, model, M,
                                  child=child is not None) == "K4"
    N = counts.shape[-1]
    G = counts.numel() // N
    mode = "" if child is None else (
        ", origin tags" if child.slot_side is not None else ", location sides")
    shape = f"{G} groups x {N}, {model.height}x{model.width}, M={M}{mode}"
    _passthrough(dev, kernel, ctx, counts, state)
    print(f"[{label}] K4 at {shape}: zero-count passthrough bit-exact, acc 0")
    share, abs_err, rel_err = _same_stream(dev, kernel, ctx, counts, state)
    terms = "pll/lp" if child is None else "pll/cll/lp"
    print(f"[{label}] 20 sweeps, same stream: {share:.6f} of particles "
          f"agree to rtol 1e-4; on those, {terms} max abs err "
          f"{abs_err:.3e}, max rel err {rel_err:.3e}")
    assert share >= 0.99, share
    n_flip, n_tail, n_mass, worst_flip, worst_tail = _mala_single_sweep_steps(
        dev, kernel, ctx, counts, state)
    print(f"[{label}] 20 single-sweep steps, {20 * counts.numel()} "
          f"particle-sweeps: {n_flip} accept flips on the boundary (largest "
          f"margin {worst_flip:.3f} of its bound), {n_tail} accepted tail "
          f"proposals within the inverse-CDF and drift rounding (largest "
          f"{worst_tail:.3f} of its bound), {n_mass} with a truncation mass "
          f"below 1e-3")

    key = torch.tensor([12345, 67890], dtype=torch.int64, device=dev)
    args = _sweep_args(key, kernel, ctx, counts, state, sweeps)
    ms = _time_ms(lambda: mala_sweep.mala_sweeps(*args, child=child), reps=5)
    plain_ms = _time_ms(lambda: mala_sweep.mala_sweeps_reference(
        *args, child=child), reps=1)
    bound = [sweep_bound(ctx.prior, model, args[6], args[9], M, sweeps,
                         child=child is not None, mala=True, peaks=p)
             for p in ((PEAK_FP32, PEAK_SFU), peaks)]
    updates = args[6].numel() * sweeps
    print(f"[{label}] {sweeps} sweeps, {G} groups x {N} particles: kernel "
          f"{ms:.3f} ms ({updates / (ms * 1e-3):.4e} updates/s), plain "
          f"{plain_ms:.3f} ms, bound {bound[0][0]:.4f} ms ({bound[0][1]}; "
          f"at K5's measured rates {bound[1][0]:.4f} ms, {bound[1][1]})")
    _equilibrium(dev, label, kernel, *eq_problem)
    return {"max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0][0], "bound_by": bound[0][1],
            "measured_bound_ms": bound[1][0], "shape": shape}


def phase_mala_kernel(dev, bridge_levels, peaks):
    """K4 against its plain version on every target it is built for: the
    basic suite's batch shapes (K2's 8x8 Poisson target) with
    compare_kernels.py's MALA steps, divideandconquer's tile target (K1's)
    and both its bridge levels from real merged states in tag and location
    mode with the MALA steps of ``[mala dnc]``, and K2's branch problems
    (the general wing, the Normal flux, Gaussian noise on 16x16). Returns
    the records by target."""
    from smcdet_tpu_torch.inference.kernels import init_kernel_state

    records = {}
    prior, model, mh, _ = suite_problem(dev, "basic")
    kernel = mala_kernel_for(mh, MALA_BASIC_STEPS, dev)
    records["basic"] = mala_vs_plain(
        dev, "K4 basic", kernel,
        *_kernel_inputs(dev, prior, model, 20, 512, 0), 100,
        _kernel_inputs(dev, prior, model, 2, 512, 0), peaks)
    _, tprior, tmodel, mh, _ = _dnc_problem(dev)
    dnc_kernel = mala_kernel_for(mh, MALA_DNC_STEPS, dev)
    records["dnc tile"] = mala_vs_plain(
        dev, "K4 dnc tile", dnc_kernel,
        *_kernel_inputs(dev, tprior, tmodel, 16, 512, 0),
        dnc_kernel.num_iters,
        _kernel_inputs(dev, tprior, tmodel, 2, 512, 0), peaks)
    for name, (prior, model, mh) in branch_problems(dev).items():
        problem = _kernel_inputs(dev, prior, model, 2, 1000, 0)
        records[name] = mala_vs_plain(
            dev, f"K4 {name}", mala_kernel_for(mh, BRANCH_MALA_STEPS[name],
                                               dev),
            *problem, 20, problem, peaks)
    for i, (ctx, counts, state) in enumerate(bridge_levels):
        loc_ctx = ctx._replace(child_slot_side=None)
        loc_state = init_kernel_state(loc_ctx, counts, state.locs,
                                      state.fluxes)
        for mode, c, st in (("tags", ctx, state),
                            ("location sides", loc_ctx, loc_state)):
            records[f"level {i} {mode}"] = mala_vs_plain(
                dev, f"K4 level {i} {mode}", dnc_kernel, c, counts, st,
                dnc_kernel.num_iters, _first_particles(c, counts, st, 512),
                peaks)
    return records


def phase_main_path(dev):
    from smcdet_tpu_torch.inference.smc import (
        default_budget_bytes,
        max_tiles_per_chunk,
        run_csmc_chunked,
    )
    from smcdet_tpu_torch.ops import mh_sweep

    sim, prior, model, kernel, cfg = build_problem(dev)
    images = sim.images.to(dev)
    T, C, N = images.shape[0], prior.num_counts, cfg.num_catalogs
    chunk = max_tiles_per_chunk(prior, N, TILE * TILE,
                                default_budget_bytes(dev))
    assert chunk >= T, "the quick cell must run as one chunk"

    mutate_calls = 0
    run_from_state = kernel.run_from_state

    def counted(*args, **kwargs):
        nonlocal mutate_calls
        mutate_calls += 1
        return run_from_state(*args, **kwargs)

    kernel.run_from_state = counted
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    torch.cuda.synchronize()
    _reset_launches()
    start = time.perf_counter()
    res = run_csmc_chunked(gen, images, prior, model, kernel, cfg,
                           sort_tiles=True)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    launches = mh_sweep.mh_sweeps.launches
    assert mh_sweep.mh_sweeps.k2_launches == 0
    peak = torch.cuda.max_memory_allocated(dev)

    iters = res.num_iters
    updates = T * C * N * kernel.num_iters * iters
    min_ess = float(res.ess.min()) / N
    print(f"[main] {T} tiles, N={N}/stratum, C={C}, {kernel.num_iters} "
          f"sweeps/iter: {iters} SMC iterations in {elapsed:.3f} s")
    print(f"[main] {updates / elapsed:.6e} updates/s, "
          f"{T / elapsed:.4f} tiles/s, min final ESS/N {min_ess:.4f}, "
          f"peak memory {peak} B ({peak / 2**30:.3f} GiB)")
    print(f"[main] mutate calls {mutate_calls}, K1 launches {launches}")

    assert torch.all(res.temperature == 1.0), res.temperature
    assert torch.isfinite(res.log_normalizing_constant).all()
    assert torch.allclose(res.weights.sum(-1), torch.ones(T, device=dev),
                          atol=1e-5)
    assert res.locs.shape == (T, C * N, 6, 2)
    assert mutate_calls == iters and launches == mutate_calls, (
        mutate_calls, launches, iters)

    mean_count = (res.weights * res.pruned_counts).sum(-1).cpu()
    truth = sim.pruned_counts.to(torch.float32)
    within = (mean_count - truth).abs() <= 1.0
    share = float(within.float().mean())
    print(f"[main] posterior mean pruned count within +-1 of truth on "
          f"{int(within.sum())}/{T} tiles (reference share "
          f"{REFERENCE_COUNT_SHARE})")
    print(f"[main] truth {truth.int().tolist()}")
    print(f"[main] mean  {[round(float(x), 3) for x in mean_count]}")
    assert share >= REFERENCE_COUNT_SHARE - 1e-9, share
    return launches


def _entry_batch(dev, cfg, label, out_root):
    """One full batch of a chunked suite (``cfg``, as loaded) through
    ``run_experiment``, its mutate calls counted; returns (calls, launches,
    results)."""
    from smcdet_tpu_torch.runner import load_results, run_experiment

    T = cfg.num_images = cfg.batch_size
    cfg.output_dir = out_root
    with _Calls() as calls:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _reset_launches()
        start = time.perf_counter()
        out = run_experiment(cfg, device=dev, verbose=False)
        wall = time.perf_counter() - start
        launches = _launches()
    res = load_results(out)
    peak = torch.cuda.max_memory_allocated(dev)
    C = cfg.prior.max_objects - cfg.prior.min_objects + 1
    N, s, kind = cfg.sampler.num_catalogs, cfg.sampler, cfg.kernel.kind
    iters = int(res["num_iters"][0])
    runtime = float(res["runtime"][0])
    sweeps = cfg.kernel.num_iters + s.relocate_sweeps
    updates = T * C * N * sweeps * iters
    print(f"[{label}] {cfg.name}: {T} tiles x {C} strata x N={N}, "
          f"{cfg.kernel.num_iters} {kind.upper()} + {s.relocate_sweeps} "
          f"relocation sweeps/iter: {iters} SMC iterations, batch "
          f"{runtime:.3f} s ({runtime / iters * 1e3:.1f} ms/iter; "
          f"run_experiment {wall:.3f} s with the tile simulation)")
    print(f"[{label}] {cfg.name}: {updates / runtime:.6e} updates/s "
          f"({kind.upper()} "
          f"{T * C * N * cfg.kernel.num_iters * iters / runtime:.6e}), "
          f"{T / runtime:.4f} tiles/s, peak memory {peak} B "
          f"({peak / 2**30:.3f} GiB); mutate calls {calls.tile[kind]}, "
          f"launches {launches}")
    assert calls.tile[kind] == iters and sum(calls.bridge.values()) == 0
    assert res["image_index"].tolist() == list(range(T))
    assert np.all(res["temperature"] == 1.0), res["temperature"]
    assert np.isfinite(res["log_normalizing_constant"]).all()
    np.testing.assert_allclose(res["weights"].sum(-1), 1.0, atol=1e-5)
    return calls, launches, res


def _suite_config(suite, tmp=None, mala_steps=None):
    """``experiments/<suite>/config.yaml`` loaded; with ``mala_steps``, a
    copy of it written under ``tmp`` with ``kernel.kind: mala`` and the
    steps ``(locs_stdev, fluxes_stdev)``, loaded from there."""
    import yaml

    from smcdet_tpu_torch.config import load_config

    path = f"experiments/{suite}/config.yaml"
    if mala_steps is None:
        return load_config(path)
    with open(path) as f:
        raw = yaml.safe_load(f)
    raw["kernel"].update(kind="mala", locs_stdev=mala_steps[0],
                         fluxes_stdev=mala_steps[1])
    copy = f"{tmp}/{suite}_mala.yaml"
    with open(copy, "w") as f:
        yaml.safe_dump(raw, f)
    return load_config(copy)


def _basic_share(label, res, truth, bar):
    mean = (res["weights"] * res["pruned_counts"]).sum(-1)
    within = np.abs(mean - truth) <= 1.0
    print(f"[{label}] basic: posterior mean pruned count within +-1 of "
          f"truth on {int(within.sum())}/{len(within)} tiles (JAX reference "
          f"share {bar})")
    print(f"[{label}] basic: truth {truth.tolist()}")
    print(f"[{label}] basic: mean  {[round(float(x), 3) for x in mean]}")
    assert within.mean() >= bar - 1e-9, within.mean()


def phase_entry_point(dev):
    """``run_experiment`` on one batch each of basic and cells (K2); returns
    the K2 launches and basic's results."""
    from smcdet_tpu_torch.runner import simulate_tiles

    with tempfile.TemporaryDirectory() as tmp:
        calls, launches, basic = _entry_batch(
            dev, _suite_config("basic"), "entry", tmp)
        k2 = launches["K2"]
        assert k2 == calls.tile["mh"] and launches["K1"] == 0, launches
        cfg = _suite_config("basic")
        cfg.num_images = cfg.batch_size
        truth = simulate_tiles(cfg)["true_counts"]
        assert truth.tolist() == BASIC_TRUE_COUNTS, (
            "the simulated basic tiles differ from the reference's",
            truth.tolist())
        _basic_share("entry", basic, truth, BASIC_REFERENCE_COUNT_SHARE)
        calls, launches, res = _entry_batch(
            dev, _suite_config("cells"), "entry", tmp)
        assert launches["K2"] == calls.tile["mh"] and launches["K1"] == 0
        k2 += launches["K2"]
        mean = (res["weights"] * res["pruned_counts"]).sum(-1)
        print(f"[entry] cells: posterior mean pruned count "
              f"{[round(float(x), 3) for x in mean]}")
    return k2, basic


def _count_pmf(res, C):
    """Per image, the posterior pmf of the pruned count over 0..C-1."""
    onehot = res["pruned_counts"][..., None] == np.arange(C)
    return (res["weights"][..., None] * onehot).sum(-2)


def phase_mala_entry(dev, mh_basic):
    """``run_experiment`` on one batch of basic with ``kernel.kind: mala``
    (compare_kernels.py's steps): every mutate call a K4 launch, the
    detection share held to the JAX runner's, and the count-pmf TVD against
    the same batch under MH (``mh_basic``). Returns the K4 launches."""
    with tempfile.TemporaryDirectory() as tmp:
        cfg = _suite_config("basic", tmp, MALA_BASIC_STEPS)
        calls, launches, res = _entry_batch(dev, cfg, "mala entry", tmp)
    k4 = launches["K4 tile"]
    assert k4 == calls.tile["mala"] and launches["K4 bridge"] == 0
    assert launches["K1"] == launches["K2"] == 0, launches
    print(f"[mala entry] acceptance {float(res['acc_rate'].mean()):.4f} "
          f"(MH batch {float(mh_basic['acc_rate'].mean()):.4f}); MALA mutate "
          f"calls {calls.tile['mala']} = K4 launches {k4}")
    _basic_share("mala entry", res, np.asarray(BASIC_TRUE_COUNTS),
                 BASIC_MALA_REFERENCE_COUNT_SHARE)
    C = cfg.prior.max_objects + 1
    tvd = 0.5 * np.abs(_count_pmf(res, C) - _count_pmf(mh_basic, C)).sum(-1)
    print(f"[mala entry] count-pmf TVD MALA vs MH over {len(tvd)} tiles: "
          f"mean {tvd.mean():.4f}, median {np.median(tvd):.4f}, max "
          f"{tvd.max():.4f}")
    return k4


class _Calls:
    """Counts the mutate calls (``run_from_state`` of ``SingleComponentMH``
    and ``SingleComponentMALA``, by kind) on the tile target and on the
    bridge, and keeps every ``Aggregate.run``'s diagnostics (per level the
    bridge iterations, the temperatures and the last iteration's mean
    acceptance), while the ``with`` block runs."""

    def _classes(self):
        from smcdet_tpu_torch.inference.aggregate import Aggregate
        from smcdet_tpu_torch.inference.kernels import (
            SingleComponentMALA,
            SingleComponentMH,
        )

        return Aggregate, {"mh": SingleComponentMH,
                           "mala": SingleComponentMALA}

    def __enter__(self):
        aggregate, kernels = self._classes()
        self.tile = dict.fromkeys(kernels, 0)
        self.bridge = dict.fromkeys(kernels, 0)
        self.levels = []
        self._saved = (aggregate.run, {k: c.run_from_state
                                       for k, c in kernels.items()})
        agg_run = aggregate.run

        def counter(kind, run_from_state):
            def counted(kernel, gen, ctx, *args, **kwargs):
                target = self.tile if ctx.child_model is None else self.bridge
                target[kind] += 1
                return run_from_state(kernel, gen, ctx, *args, **kwargs)
            return counted

        def recorded(agg, *args, **kwargs):
            out = agg_run(agg, *args, **kwargs)
            self.levels.append([(d["iterations"], d["temperature"].tolist(),
                                 float(d["acc_rate"].mean()))
                                for d in agg.diagnostics])
            return out

        for kind, cls in kernels.items():
            cls.run_from_state = counter(kind, cls.run_from_state)
        aggregate.run = recorded
        return self

    def __exit__(self, *exc):
        aggregate, kernels = self._classes()
        aggregate.run = self._saved[0]
        for kind, cls in kernels.items():
            cls.run_from_state = self._saved[1][kind]


def _reset_launches():
    from smcdet_tpu_torch import roofline
    from smcdet_tpu_torch.ops import mala_sweep, mh_sweep

    mh_sweep.mh_sweeps.launches = 0
    mh_sweep.mh_sweeps.k2_launches = 0
    mh_sweep.mh_sweeps.k3_launches = 0
    mala_sweep.mala_sweeps.launches = 0
    mala_sweep.mala_sweeps.bridge_launches = 0
    roofline.chain.launches = 0


def _launches():
    from smcdet_tpu_torch import roofline
    from smcdet_tpu_torch.ops import mala_sweep, mh_sweep

    f, g = mh_sweep.mh_sweeps, mala_sweep.mala_sweeps
    return {"K1": f.launches, "K2": f.k2_launches, "K3": f.k3_launches,
            "K4 tile": g.launches, "K4 bridge": g.bridge_launches,
            "K5": roofline.chain.launches}


def _aggregation_batch(dev, cfg, label):
    """One batch of an aggregation-enabled suite through ``run_experiment``
    with the tile and bridge mutate calls counted against the kernels'
    launches; returns (launches, results, per-image level diagnostics)."""
    from smcdet_tpu_torch.runner import load_results, run_experiment

    with _Calls() as calls:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _reset_launches()
        start = time.perf_counter()
        out = run_experiment(cfg, device=dev, verbose=False)
        wall = time.perf_counter() - start
        launches = _launches()
    res = load_results(out)
    peak = torch.cuda.max_memory_allocated(dev)
    per_image = res["runtime_per_image"]
    print(f"[{label}] {len(per_image)} images: batch "
          f"{float(res['runtime'][0]):.3f} s (run_experiment {wall:.3f} s "
          f"with loading), seconds per image "
          f"{[round(float(x), 3) for x in per_image]}, mean "
          f"{float(per_image.mean()):.3f} s, peak memory {peak} B")
    print(f"[{label}] tile mutate calls {calls.tile}, bridge mutate calls "
          f"{calls.bridge}; launches {launches}")
    assert launches["K1"] + launches["K2"] == calls.tile["mh"], (launches,
                                                                 calls.tile)
    assert launches["K3"] == calls.bridge["mh"], (launches, calls.bridge)
    assert launches["K4 tile"] == calls.tile["mala"], (launches, calls.tile)
    assert launches["K4 bridge"] == calls.bridge["mala"], (launches,
                                                           calls.bridge)
    assert res["image_index"].tolist() == list(range(cfg.num_images))
    assert np.isfinite(res["log_normalizing_constant"].max(-1)).all()
    np.testing.assert_allclose(res["weights"].sum(-1), 1.0, atol=1e-5)
    return launches, res, calls.levels


def _count_share(label, res, truth):
    mean = (res["weights"] * res["pruned_counts"]).sum(-1)
    within = np.abs(mean - truth) <= 1.0
    print(f"[{label}] posterior mean pruned count within +-1 of truth on "
          f"{int(within.sum())}/{len(within)} images")
    print(f"[{label}] truth {list(map(int, truth))}")
    print(f"[{label}] mean  {[round(float(x), 3) for x in mean]}")
    return float(within.mean())


def _dnc_batch(dev, cfg, label, converged_bar, count_bar):
    """One batch of 4 divideandconquer images through ``run_experiment``:
    each level's bridge iterations and temperatures, held to the JAX
    runner's convergence and detection shares. Returns the launches."""
    from smcdet_tpu_torch.runner import simulate_tiles

    cfg.num_images = cfg.batch_size = 4
    launches, res, levels = _aggregation_batch(dev, cfg, label)
    cap = cfg.aggregation.max_smc_iters
    converged = 0
    for i, lv in enumerate(levels):
        ok = all(it < cap and np.all(np.asarray(t) == 1.0)
                 for it, t, _ in lv)
        converged += ok
        print(f"[{label}] image {i}: " + "; ".join(
            f"level {k} {it} bridge iterations, temperatures {t}, last "
            f"acceptance {acc:.4f}" for k, (it, t, acc) in enumerate(lv)))
    truth = simulate_tiles(cfg)["true_counts"]
    assert truth.tolist() == DNC_TRUE_COUNTS, truth.tolist()
    share = _count_share(label, res, truth)
    print(f"[{label}] levels all at temperature 1 below the {cap}-iteration "
          f"cap on {converged}/{len(levels)} images (JAX reference share "
          f"{converged_bar}); count share {share} (JAX reference "
          f"{count_bar})")
    assert converged / len(levels) >= converged_bar - 1e-9
    assert share >= count_bar - 1e-9
    return launches


def phase_aggregation(dev):
    """The aggregation entry point: ``run_experiment`` on one batch of
    divideandconquer (4 16x16 images, shipped N, M, sweeps, ESS and bridge
    settings: tile stage K1, bridges K3) and on the first 8 tiles of the
    m71 real-data fixture (fitted params, per-tile backgrounds, the general
    SDSS wing: K2), each held to the JAX runner's shares."""
    with tempfile.TemporaryDirectory() as tmp:
        cfg = _suite_config("divideandconquer")
        cfg.output_dir = tmp
        dnc = _dnc_batch(dev, cfg, "dnc", DNC_REFERENCE_CONVERGED_SHARE,
                         DNC_REFERENCE_COUNT_SHARE)
        assert dnc["K1"] > 0 and dnc["K3"] > 0 and dnc["K2"] == 0, dnc

        cfg = _suite_config("m71")
        cfg.data_path = "experiments/m71/data/m71/tiles.npz"
        cfg.num_images = cfg.batch_size = 8
        cfg.output_dir = tmp
        m71, res, levels = _aggregation_batch(dev, cfg, "m71")
        assert m71["K2"] > 0 and m71["K1"] == m71["K3"] == 0, m71
        assert all(lv == [] for lv in levels)  # one tile: no level
        truth = np.load(cfg.data_path)["true_counts"][:8]
        share = _count_share("m71", res, truth)
        print(f"[m71] count share {share} (JAX reference "
              f"{M71_REFERENCE_COUNT_SHARE})")
        assert share >= M71_REFERENCE_COUNT_SHARE - 1e-9
    return dnc, m71


def phase_mala_dnc(dev):
    """``run_experiment`` on one batch of 4 divideandconquer images with
    ``kernel.kind: mala``: K4 on the tile stage and on both bridge levels,
    every mutate call a K4 launch, held to the JAX runner's shares under
    the same MALA steps. Returns the launches."""
    with tempfile.TemporaryDirectory() as tmp:
        cfg = _suite_config("divideandconquer", tmp, MALA_DNC_STEPS)
        cfg.output_dir = tmp
        launches = _dnc_batch(dev, cfg, "mala dnc",
                              DNC_MALA_REFERENCE_CONVERGED_SHARE,
                              DNC_MALA_REFERENCE_COUNT_SHARE)
    assert launches["K4 tile"] > 0 and launches["K4 bridge"] > 0, launches
    assert all(launches[k] == 0 for k in ("K1", "K2", "K3")), launches
    return launches


def phase_profile(dev):
    """``torch.profiler`` over one warm divideandconquer image through
    ``run_experiment``: device time by range (``agg.*`` and ``smc.*``, the
    kernels launched inside each) and the device's idle share, 1 - the sum
    of kernel time over the wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from smcdet_tpu_torch.config import load_config
    from smcdet_tpu_torch.runner import run_experiment

    cfg = load_config("experiments/divideandconquer/config.yaml")
    cfg.num_images = cfg.batch_size = 1
    with tempfile.TemporaryDirectory() as tmp:
        cfg.output_dir = tmp
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            start = time.perf_counter()
            run_experiment(cfg, device=dev, verbose=False)
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
    # A range's device time is that of the PyTorch kernels launched inside
    # it (the host-side range event's; its device-side twin spans the gaps
    # too). The sweep kernels launch through their own statically linked
    # CUDA runtime, which the profiler does not tie to a host range, so
    # they are summed by name: K1 and K2 run in smc.mutate, K3 in
    # agg.mutate.
    names = {"mh_sweep_k3": "K3", "mh_sweep_k2": "K2",
             "mh_sweep_kernel": "K1"}
    ranges, sweeps, kernel_ms = {}, {}, 0.0
    for e in prof.events():
        in_range = e.name.startswith(("agg.", "smc."))
        if e.device_type == DeviceType.CPU and in_range:
            n, ms = ranges.get(e.name, (0, 0.0))
            ranges[e.name] = (n + 1, ms + e.device_time_total / 1e3)
        elif e.device_type == DeviceType.CUDA and not in_range:
            kernel_ms += e.device_time_total / 1e3
            kid = next((k for pat, k in names.items() if pat in e.name),
                       None)
            if kid is not None:
                n, ms = sweeps.get(kid, (0, 0.0))
                sweeps[kid] = (n + 1, ms + e.device_time_total / 1e3)
    print(f"[profile] one divideandconquer image under the profiler: wall "
          f"{wall * 1e3:.1f} ms, kernels {kernel_ms:.1f} ms, device idle "
          f"{1 - kernel_ms / (wall * 1e3):.3f}")
    for kid, (n, ms) in sorted(sweeps.items()):
        print(f"[profile] {kid} (the sweeps of "
              f"{'agg' if kid == 'K3' else 'smc'}.mutate): {n} launches, "
              f"device {ms:.3f} ms")
    for key in sorted(ranges, key=lambda k: -ranges[k][1]):
        n, ms = ranges[key]
        print(f"[profile] {key}: {n} calls, PyTorch kernels {ms:.3f} ms")
    rest = kernel_ms - sum(ms for _, ms in ranges.values()) - sum(
        ms for _, ms in sweeps.values())
    print(f"[profile] outside the ranges: device {rest:.3f} ms")


def phase_chain(dev):
    """K5: first against its plain version with every SM filled, 4 chains
    per element, at the lengths and tolerances of ``roofline.CHECK_N_CHAIN``
    / ``CHECK_RTOL``, where the plain chain one step shorter or longer lies
    beyond the tolerance (checked here), so a kernel that runs another
    number of steps fails; then, with the launch count set to 0, the four
    rates by ``roofline.measure``, each held to at most 1.05 times the
    data-sheet peak that ``sweep_bound`` uses. Returns its record and the
    measured (FP32 flop/s, SFU results/s) peaks."""
    from smcdet_tpu_torch import roofline

    props = torch.cuda.get_device_properties(dev)
    sms = props.multi_processor_count
    n = sms * getattr(props, "max_threads_per_multi_processor", 2048)
    x0 = torch.linspace(0.0, 10.0, n, device=dev)
    streams = roofline.STREAMS
    err = 0.0

    def rel(a, b):
        return float(((a - b).abs() / b.abs()).max())

    for kind in roofline.KINDS:
        n_chain, tol = roofline.CHECK_N_CHAIN[kind], roofline.CHECK_RTOL[kind]
        steps = n_chain * roofline.UNROLL
        got = roofline.chain(kind, x0, n_chain)
        want = roofline.chain_reference(kind, x0, n_chain)
        off = min(rel(got, roofline.chain_reference(kind, x0, 0, steps + d))
                  for d in (-1, 1))
        torch.cuda.synchronize()
        err = max(err, float((got - want).abs().max()))
        print(f"[K5] {kind} chains vs plain ({n} elements x {streams} x "
              f"{steps} steps): max rel err {rel(got, want):.3e} (tolerance "
              f"{tol:.2e}); against the plain chain one step shorter or "
              f"longer at least {off:.3e}")
        assert rel(got, want) <= tol < off, (kind, rel(got, want), off)
    n_chain = roofline.CHECK_N_CHAIN["fma"]
    ms = _time_ms(lambda: roofline.chain("fma", x0, n_chain), 5)
    plain_ms = _time_ms(lambda: roofline.chain_reference(
        "fma", x0, n_chain), 1)
    steps = n * streams * n_chain * roofline.UNROLL
    bound_ms = max(2 * steps / PEAK_FP32, 8 * n / PEAK_BYTES) * 1e3
    print(f"[K5] fma chains at those shapes: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms (operations)")

    _reset_launches()
    rates = {}
    for kind in roofline.KINDS:
        m = roofline.measure(kind, device=dev)
        flops, sfu = roofline.STEP_OPS[kind]
        clock = m["sm_clock_mhz"] * 1e6
        rates[kind] = m["steps_per_s"] * (flops if kind == "fma" else sfu)
        unit = (f"{rates[kind] / 1e12:.4f} TFLOP/s FP32 (data sheet "
                f"{PEAK_FP32 / 1e12:.0f})" if kind == "fma" else
                f"{rates[kind] / (sms * clock):.4f} results per SM per "
                f"clock (data sheet 16), {rates[kind] / 1e12:.4f} T/s")
        print(f"[K5] {kind}: {unit}; t(2n)/t(n) {m['linearity']:.4f} "
              f"(n = {m['n_chain']} x {roofline.UNROLL} steps, "
              f"{m['t_n_s']:.4f} s / {m['t_2n_s']:.4f} s), SM clock "
              f"{m['sm_clock_mhz']:.0f} MHz")
        assert 1.8 <= m["linearity"] <= 2.2, (kind, m)
        # a rate above the card's peak means steps counted but not run
        peak = PEAK_FP32 if kind == "fma" else 16 * sms * clock
        assert rates[kind] <= 1.05 * peak, (kind, rates[kind], peak)
    launches = roofline.chain.launches
    peaks = (rates["fma"], max(rates[k] for k in ("exp", "rsqrt", "log")))
    print(f"[K5] measured peaks for the bounds: FP32 {peaks[0]:.6e} flop/s, "
          f"SFU {peaks[1]:.6e} results/s ({launches} K5 launches)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "operations"}, launches, peaks


def _record(name, kernel_id, launches, rec):
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    return {"name": name, "route": "cuda", "source": SOURCES[kernel_id],
            "replaces": REPLACES[kernel_id], "launches": launches,
            **{k: rec[k] for k in keys},
            # no single PyTorch call computes a fused sweep loop or a
            # dependent chain of elementwise steps
            "library_ms": None}


def main():
    smi = phase_device()
    dev = torch.device("cuda")
    import smcdet_tpu_torch  # noqa: F401  (fails outside the repository)

    start = time.perf_counter()
    phase_build()
    # each path is driven with the launch counts set to 0 just before it
    records, launches = {}, {}
    records["K5"], launches["K5"], peaks = phase_chain(dev)
    _, prior, model, kernel, _ = build_problem(dev)
    records["K1"] = kernel_vs_plain(dev, "K1", "K1", prior, model, kernel,
                                    16, 2048, peaks)
    for suite, tiles, N in (("basic", 20, 512), ("cells", 10, 4096)):
        prior, model, kernel, _ = suite_problem(dev, suite)
        records[f"K2 {suite}"] = kernel_vs_plain(
            dev, f"K2 {suite}", "K2", prior, model, kernel, tiles, N, peaks)
    branch_err = max(branch_check(dev, f"K2 {name}", *problem)
                     for name, problem in branch_problems(dev).items())
    mh_dnc, levels = bridge_states(dev)
    records["K3"] = phase_bridge_kernel(dev, mh_dnc, levels, peaks)
    k4 = phase_mala_kernel(dev, levels, peaks)
    del levels
    launches["K1"] = phase_main_path(dev)
    launches["K2"], mh_basic = phase_entry_point(dev)
    launches["K4"] = phase_mala_entry(dev, mh_basic)
    dnc, m71 = phase_aggregation(dev)
    for k in ("K1", "K2"):
        launches[k] += dnc[k] + m71[k]
    launches["K3"] = dnc["K3"] + m71["K3"]
    mala_dnc = phase_mala_dnc(dev)
    launches["K4"] += mala_dnc["K4 tile"] + mala_dnc["K4 bridge"]
    phase_profile(dev)
    print(f"[done] phases 2-13 in {time.perf_counter() - start:.1f} s on "
          f"{smi}")
    print(f"[done] K2 at the basic shapes: {records['K2 basic']['ms']:.3f} "
          f"ms vs plain {records['K2 basic']['plain_ms']:.3f} ms per 100 "
          f"sweeps (bound {records['K2 basic']['bound_ms']:.4f} ms); the K2 "
          f"record below is at the cells shapes")
    k2 = dict(records["K2 cells"])
    k2["max_abs_err"] = max(k2["max_abs_err"],
                            records["K2 basic"]["max_abs_err"], branch_err)
    for target, rec in k4.items():
        print(f"[done] K4 {target} ({rec['shape']}): {rec['ms']:.3f} ms vs "
              f"plain {rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.4f} "
              f"ms (at K5's rates {rec['measured_bound_ms']:.4f} ms)")
    records["K4"] = dict(k4["basic"])
    records["K4"]["max_abs_err"] = max(r["max_abs_err"] for r in k4.values())
    print("[done] the K4 record below is at the basic shapes; its "
          "launches are [mala entry]'s and [mala dnc]'s")
    print(json.dumps({"kernels": [
        _record("mh_sweep", "K1", launches["K1"], records["K1"]),
        _record("mh_sweep_k2", "K2", launches["K2"], k2),
        _record("mh_sweep_k3", "K3", launches["K3"], records["K3"]),
        _record("mala_sweep_k4", "K4", launches["K4"], records["K4"]),
        _record("chain_k5", "K5", launches["K5"], records["K5"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
