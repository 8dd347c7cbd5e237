"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

``SEED_WORKERS`` worker processes of this script start with it and run the
seeds after the first of the divideandconquer (MH and MALA) and
m71semisynthetic batches while the first runs here, and ``EQ_WORKERS``
more run the equilibrium checks of phases 4-7 while the divideandconquer
batches run (``_defer_equilibrium``); the script ends them before it
exits.

Phases (a failing phase raises; there is no CPU fallback):

1. device: the card's name and power limit (nvidia-smi), CUDA, nvcc,
   scipy, triton and matplotlib versions (or that one does not import);
   exits non-zero without a CUDA card;
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
   tiles (``_defer_equilibrium``: in the equilibrium worker, as for K2-K4
   below);
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
8. launch shapes: K1 at one divideandconquer image's tile launch, K4 at
   the same launch and at that image's two bridge launches, K2 at one m71
   fixture tile's launch and at the cells batch's (200 sweeps), each timed
   beside its bound and its plain version, with its blocks and waves per
   launch (``launch_geometry``);
9. main path: the M71 quick cell (16 tiles from ``generate_images`` with
   seed 7, N = 2048, 100 sweeps per SMC iteration, systematic resampling,
   ESS 0.5) through ``run_csmc_chunked(sort_tiles=True)``, with every
   mutate call counted against K1's launch counter, its peak memory held
   to ``run_csmc_chunked``'s estimate (``smc.chunk_bytes_per_tile``), as
   every batch's below;
10. entry point: ``run_experiment`` on ``experiments/basic/config.yaml``
    (one batch of 20 images) and ``experiments/cells/config.yaml`` (one
    batch of 10 images) at the shipped configurations, into a temporary
    directory, with every mutate call counted against K2's launch counter
    and the basic batch's detection share held to the JAX reference's;
11. pair: ``run_experiment`` on one batch of
    ``experiments/cells/config_pair.yaml`` (the cells batch's 10 tiles,
    N = 4096, C = 13, 200 K2 sweeps + 16 relocations + 8 pair-redistribute
    sweeps per SMC iteration): every mutate call a K2 launch, none of K1,
    the pair move's applied share in (0, 1), the posterior mean counts
    beside the cells batch's, wall and peak memory; then one basic batch
    with 16 relocation and 8 pair sweeps (the estimate at 8x8 with both
    moves);
12. MALA entry point: the same basic batch with ``kernel.kind: mala`` (a
    copy of the config in a temporary directory, compare_kernels.py's
    steps): every mutate call a K4 launch, the detection share held to the
    JAX runner's under MALA, the count-pmf TVD against the MH batch;
13. aggregation entry point: ``run_experiment`` on one batch of 4 images
    of ``experiments/divideandconquer/config.yaml`` (K1 tile stage, K3
    bridges), ``DNC_RUNS`` times with the sampler seeded by the config's
    seed and the next ones, and on the first 8 tiles of the m71 real-data
    fixture (``experiments/m71/config.yaml``: fitted params, per-tile
    backgrounds, K2), tile and bridge mutate calls counted against the
    launches, each level's bridge iterations and temperatures printed, the
    convergence share of every run held to the JAX runner's, the config
    seed's run printed (not held) beside the JAX runner's single-run
    detection share, and the count of image-runs within +-1 held to the
    JAX runner's rate on the same seeds (``binomial_floor``); one m71
    image alone holds the chunk estimate (its one tile is its chunk);
14. MALA aggregation: the same 4 divideandconquer images with
    ``kernel.kind: mala``, K4 on the tile stage and on both bridge levels,
    held to the JAX runner's shares under MALA the same way;
15. profile: ``torch.profiler`` over one divideandconquer image, device
    time by ``agg.*`` / ``smc.*`` range and the device's idle share; then
    over one SMC iteration of the cells_pair batch: device time by
    ``smc.*`` range, K2's share, and the time per sweep of the plain
    relocation and pair moves;
16. score: the port's analyzer (``smcdet_tpu_torch.analyze``) on the
    basic, cells and cells_pair batches, matching on the card and on the
    CPU with the same sampled catalogs: identical ``MatchCounts`` but for
    pairs within 1e-5 of a tolerance (counted, printed); count accuracy,
    confusion asymmetry, coverage at 0.95, F1 by magnitude bin and the
    matching's time on the card;
17. mcmc: the MH chain baseline (one chain per tile, N = 1 launches) of
    the m71 fixture (per-tile backgrounds, K2), m71synthetic (K1), basic
    (K2, Poisson), cells (K2, 16x16) and basic under MALA (K4): each
    kernel at its chain's launch shapes against its plain version
    (passthrough, >= 99% same-stream agreement, equilibrium over
    ``MCMC_EQ_SWEEPS`` sweeps, two launches on one key bit-identical,
    ``launch_agreement``), its burn-in and block
    launches timed beside their bounds, the rate cache's drift over a
    whole burn-in launch (and the plain version's on two m71 tiles); then
    one batch each through ``run_experiment(method="mcmc")`` at the
    configs' chain lengths (50,000 sweeps, 30,000 burn-in, thinning 2: one
    burn-in launch and 10,000 block launches), every launch counted, with
    the later chains cut when the batches would exceed ``MCMC_BUDGET_S``
    (10 s: the chains after the m71 fixture's keep a share of their
    samples);
    then ``torch.profiler`` over an m71 batch cut to 1,000 blocks: device
    time, idle share and host time per block;
18. rjmh: the reversible-jump chain (birth, death, split, merge) on
    basic's 20 tiles, and its caches after 200 sweeps against a fresh
    render;
19. tdsmc: transdimensional SMC on basic's 20 tiles, every tile at
    temperature 1, finite log Z;
20. sep: the source-extractor baseline on the m71 fixture on the card,
    tuned on a cut of its grid (``SEP_GRID``), and the tuned extractor on all 688 tiles on the card against
    the CPU (counts equal on >= 99% of tiles, locations and fluxes within
    ``SEP_LOC_ATOL`` / ``SEP_FLUX_RTOL``);
21. sqjd: the ``sqjumpdist_tol`` early stop at the jsm2024 value 1e-2 on
    ``SQJD_QUICK_TILES`` of the quick cell's tiles (K1), one basic batch
    (K2), the basic batch under MALA
    (K4) and one divideandconquer image (K1 tiles, K3 bridges): one counted
    launch a sweep, tolerance 0 running exactly ``num_iters`` launches a
    mutation, the plain version on the same Philox keys (on every
    ``SQJD_COMPARE_EVERY``-th mutation) stopping at the same sweep in >=
    99% of those with >= 99% of particles agreeing;
    sweeps per mutation, the host's wall per sweep beside a one-sweep
    launch's time, the batch wall;
22. history: the quick cell with ``record_history`` on a fixed ladder,
    unchunked and in chunks of 4 tiles: the recorded temperatures equal the
    ladder, the history's shapes the JAX package's;
23. fit: ``fitting.fit_image_model`` on a 64x64 patch rendered from the
    m71 fixture's fitted parameters with known stars: the recovered
    parameters beside the truth, the steps and the wall;
24. m71ss: the m71semisynthetic generate step on all 688 fixture tiles in
    each catalog mode, then an 8-tile cut through ``run_experiment`` at 10
    sampler seeds, its tile-runs within +-1 held to the JAX runner's on
    the same tiles and seeds (``binomial_floor``);
25. bench: K1 at the bench's launch shapes (a 14-tile chunk and the
    28-slot pool at N = 4096, the quick cell) against its plain version
    (``launch_agreement``) and its bound; then the headline workload
    through ``smcdet_tpu_torch.bench``'s sorted-chunk main on the quick
    cell and the 332-tile frame (``bench.py``'s own tiles: every tile at
    temperature 1, every mutate call a K1 launch and no other kernel, peak
    memory under one chunk's estimate, the quick tiles' +-1 share at or
    above the JAX runner's), and the frame at the memory model's largest
    chunk, printed for information;
26. stream: the bench's ``--streaming`` main (the tile pool,
    ``inference/streaming.py``) on the quick cell and the frame at 28
    slots, held as ``[bench]`` with the peak under the pool's estimate
    plus its results, tiles/s and iterations a tile beside the sorted
    chunks'; then ``torch.profiler`` over a streaming run of 56 tiles: the
    device's idle share, the host's time a step and the scheduler's
    ``stream.*`` ranges; then the pool through ``run_experiment`` (one
    basic batch with ``sampler.streaming``, K2) and
    ``SMCSampler.run(streaming=True)`` (K1);
27. studies: the study modules (``smcdet_tpu_torch/studies``) on the JAX
    package's tiles of the suites (``tests/data``): compare_kernels on 20
    basic images (K2 against K4); K2 at the single-tile run's 16x16 M71
    launch shape (4 images x 9 strata x 2048, 50 sweeps) and at
    compare_pooled's single-tile arm's (2 images) against its plain
    version (``launch_agreement``) and its bound, then that run
    through ``run_experiment`` on 4 divideandconquer images; compare_pooled
    at 2 images x 2 reps with its dump (K2 single-tile arm, K1 tiles and
    K3 bridges), then the numpy-only ``attribute_pooled.py`` and
    ``truth_score_pooled.py`` on the dump, each exiting 0;
28. m71studies: the seven M71 study modules at cuts (``phase_m71studies``):
    the crowded-tile budget probe's three arms on 4 crowded tiles (K2),
    the oracle run on 4 fixture tiles (K1) and its analysis, the m71,
    m71_nogiants, m71_mis and m71_vary suites on 4 tiles each (K2) with
    compare_nogiants (the whole fixture's giant geometry equal to the
    committed one) and misspec_study, simulator_checks (K2), repeated_runs
    at 8 runs, N 512 and 2048, 10 and 100 sweeps (K1) and split_mode_study
    at 8 chains x 150 sweeps (K1 at N = 1, the reversible-jump anchors
    plain), every tile-level SMC run at temperature 1 with a finite log Z
    and weights summing to 1; each figure-data file those studies write
    (``smcdet_tpu_torch/figures.py``'s names: misspec's report,
    simulator_checks', repeated_runs' grid, split_mode's) read back with
    its keys and shapes, finite, and the JSON's figures recomputed from
    it and equal (the KS statistics and the posterior-predictive quantile,
    the widths, the rounded pooled pmfs); no figure is drawn on the card;
    then K1 and K2 at the launch shapes the
    studies add at their committed sizes, on the studies' own tiles
    (``launch_agreement``, the bound; the crowded arms' and the oracle's
    single-sweep disagreements classified);
29. ingest: the M71 data front (``phase_ingest``) in a temporary
    directory: ``data_prep.make_fixture`` (the default seed, the star
    render on the card), ``prepare_data --no-download`` with the L-BFGS
    image-model fit on the card, its tiles, catalogs and closed-form
    parameters held to ``experiments/m71/data/m71`` (images to one float32
    ulp) and its fit to the committed one where the likelihood pins it
    (``data_prep.compare``); ``sky_exactness`` and ``psf_comparison`` on
    the regenerated files held to their committed JSONs, psf_comparison's
    figure data read back (the residual's RMS over the noise recomputed
    from it equal to the JSON's); the five-band
    frame aligned to the r band on the card against the CPU; then the
    m71 cut of ``[m71]`` (8 tiles, one batch, K2) on the port's own tiles
    and fitted ``params.yaml``;
30. anchor: the SMC-versus-MCMC anchor (``studies/compare_mcmc``) at a cut,
    ``ANCHOR_CUT`` (16 m71synthetic images x 2 reps on the tile axis, 400
    sweeps, 200 burn-in, thin 2), after the port's CS-SMC on those
    images: K1 once for the burn-in and once a kept sample, the RJ sweep
    plain, every chain finite, the acceptances in [0, 1], its report
    printed beside the committed one (not held), its figure data read
    back (the TVD means recomputed equal to the report's); K1 at the
    CS-SMC's launch
    shape, at the cut's 32 x 1 and at the committed anchor's 800 x 1 (its
    30,000-sweep burn-in and a 2-sweep block) against its plain version
    (``launch_agreement`` pooled over keys) and its bound; the RJ sweep's
    wall a sweep at 32 and 800 chains;
31. parallel: divideandconquer cut to 4 images at batch size 1 through
    ``run_experiment`` in this process (every tile and bridge level at
    temperature 1), then through two job processes of ``python -m
    smcdet_tpu_torch.run_experiment --distributed`` (gloo over localhost,
    both on ``cuda:0``): disjoint batch files whose union is the
    single-process run's, each finite with weights summing to 1 and equal
    to the single-process run's, a failing process failing the phase;
    ``SMCSampler.run(devices=[cuda:0])`` bit-equal to ``devices=None``;
    ``select_device()`` the card; ``describe_devices()``;
32. dnc4: the divideandconquer suite on 32x32 images, a 4x4 grid of 8x8
    tiles (``phase_dnc4``; configs from ``studies/dnc_grid.py``, the JAX
    package's images from ``tests/data/divideandconquer32_tiles.npz``):
    two images through the tree under MH (K1 tiles, K3 at levels 0-1, K3g
    at 32x16 with 64 slots and 32x32 with 128), one under MALA (K4, then
    K4g), the first through the 32x32 single tile (K2g, 32 slots) cut to
    3 SMC iterations (at the config's 100 it reaches temperature 0.039 in
    96 s) and ``compare_singletile`` on it (its figure data read back, the
    TVD's mean, median and p90 recomputed equal to the JSON's); every tree
    level and tile at temperature 1;
    K2g, K3g and K4g held against their plain versions at each launch
    shape of the path, K4g also at the single tile's first groups under
    MALA, and at a 24x24 tile with 20 slots off it (``launch_agreement``,
    the bound), and K3g and K4g over 800 sweeps at level 2.

Then, per path, each kernel's launches in the run, its launch shape, time
and bound, and launches x (time - bound) ranked by kernel. The last two
lines of standard output are the kernels' JSON record and ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# Share of the 16 quick-cell tiles whose posterior mean pruned count lies
# within +-1 of the true pruned count for the JAX reference
# (smcdet_tpu run_csmc_chunked, sort_tiles=True) run on CPU on the same
# tiles with the same configuration: 16/16 with seeds 0 and 1 (PERF.md).
REFERENCE_COUNT_SHARE = 1.0

# The same share on the bench's own 16 quick tiles (``bench.py``'s draw,
# ``smcdet_tpu_torch/bench_tiles.npz``) at the same configuration, for the
# JAX package's bench problem (``tests/torch_reference_bars.py bench
# --num-images 16``, CPU): 15/16 with seed 1 (PERF.md). Held by
# ``[bench]`` and ``[stream]``.
BENCH_REFERENCE_COUNT_SHARE = 15 / 16

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
# The port's batch runs DNC_RUNS times: the config's seed and the next ones
# seed the sampler, the images stay those of the config's seed. Every run
# must meet the convergence bar. One run is one draw of the sampler, and a
# change of a kernel's rounding draws another, so the config seed's single
# run is printed beside the single-run bars above and not held. What is
# held is the count of image-runs within +-1 over the DNC_RUNS runs: it must
# not lie in the lower DNC_ALPHA tail of the binomial at the JAX runner's
# rate on the same images and config seeds (DNC_JAX_WITHIN, estimated by
# the rule of succession: binomial_floor). The JAX runner's images within
# +-1 at config seeds 5 to 14, on the CPU: JAX_PLATFORMS=cpu python
# tests/torch_reference_bars.py experiments/divideandconquer/config.yaml
# --num-images 4 --seeds 5 6 7 8 9 10 11 12 13 14 (MH; with --set
# kernel.kind=mala for MALA) prints count_share 1.0 at every seed under MH
# but 0.75 at seed 13, and under MALA 0.75, 1.0, 1.0, 1.0, 1.0, 1.0, 0.75,
# 0.75, 1.0, 0.5 (PERF.md).
DNC_RUNS = 10
DNC_JAX_WITHIN_BY_SEED = {"MH": [4, 4, 4, 4, 4, 4, 4, 4, 3, 4],
                          "MALA": [3, 4, 4, 4, 4, 4, 3, 3, 4, 2]}
DNC_JAX_WITHIN = {k: sum(v) for k, v in DNC_JAX_WITHIN_BY_SEED.items()}
DNC_ALPHA = 0.05

# The m71 real-data suite (experiments/m71/config.yaml: the fitted-params
# overlay, per-tile background maps) on the first 8 fixture tiles of
# experiments/m71/data/m71/tiles.npz: the share of them whose posterior mean
# pruned count lies within +-1 of ``true_counts`` for the JAX runner on the
# CPU at the shipped configuration: 5/8 with config seeds 3 and 4 (PERF.md).
M71_REFERENCE_COUNT_SHARE = 5 / 8

# The m71semisynthetic suite (experiments/m71semisynthetic/config.yaml: the
# fixture's padded catalogs rendered by the port's generate step, per-tile
# backgrounds) on its first 8 tiles: the share within +-1 of ``true_counts``
# for the JAX runner on the CPU on the same tiles (the port's render, whose
# noise comes from a CPU generator): 7/8 with config seeds 2 and 3
# (tests/torch_reference_bars.py experiments/m71semisynthetic/config.yaml
# --num-images 8 --seeds 2 3; PERF.md), printed beside the port's run at
# the config seed, not held.
M71SS_REFERENCE_COUNT_SHARE = 7 / 8
# One run is one draw of the sampler, and on tile 2 (truth 2) the JAX
# runner's posterior mean count sits on the +-1 boundary: 0.980 to 1.037
# over config seeds 2-11, so its single runs read 7/8 or 6/8. As for
# divideandconquer, the held statistic is the tile-runs within +-1 over
# the config seed and the next nine (``M71SS_RUNS``), at least
# ``binomial_floor`` of the JAX runner's 66/80 on the same tiles and seeds
# (7, 7, 7, 7, 6, 6, 7, 6, 6, 7 at seeds 2-11;
# tests/torch_reference_bars.py ... --seeds 2 3 4 5 6 7 8 9 10 11).
M71SS_RUNS = 10
M71SS_JAX_WITHIN = 66
# the jsm2024 early-stop tolerance (sqjumpdist_tol) that [sqjd] runs
SQJD_TOL = 1e-2
# the early stop's quick-cell path runs this many of the quick cell's tiles
SQJD_QUICK_TILES = 4
# the plain version is compared on every this-many-th mutation of a path
# (the first included): the comparisons were two thirds of the phase
SQJD_COMPARE_EVERY = 4
# [history]: a ladder of dyadic temperatures, exact in float32, so the
# recorded temperatures equal it bit for bit
HISTORY_LADDER = (0.0625, 0.125, 0.25, 0.5, 1.0)

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
            "K5": "experiments/roofline.py:96",
            "K2g": "smcdet_tpu/ops/pallas_sweep.py:178",
            "K3g": "smcdet_tpu/ops/pallas_sweep.py:178",
            "K4g": "smcdet_tpu/ops/pallas_sweep.py:485"}
SOURCES = {"K1": "smcdet_tpu_torch/csrc/mh_sweep_k2.cu",
           "K2": "smcdet_tpu_torch/csrc/mh_sweep_k2.cu",
           "K3": "smcdet_tpu_torch/csrc/mh_sweep_k3.cu",
           "K4": "smcdet_tpu_torch/csrc/mala_sweep_k4.cu",
           "K5": "smcdet_tpu_torch/csrc/chain_k5.cu",
           "K2g": "smcdet_tpu_torch/csrc/mh_sweep_k2g.cu",
           "K3g": "smcdet_tpu_torch/csrc/mh_sweep_k3g.cu",
           "K4g": "smcdet_tpu_torch/csrc/mala_sweep_k4g.cu"}

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


def build_problem(device, **kwargs):
    """The bench's M71 problem (``smcdet_tpu_torch.bench.build_problem``) on
    the port's own simulated tiles (a CPU generator seeded 7, the same on
    every machine), on which ``[main]``'s bar was taken; the tiles are
    returned on the CPU."""
    from smcdet_tpu_torch.bench import build_problem as bench_problem

    return bench_problem(device, tiles="simulate", **kwargs)


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
    # scipy: the analyzer's SBC test (validation.py); triton and matplotlib:
    # nothing in the port needs them yet
    versions = {name: _version(name)
                for name in ("scipy", "triton", "matplotlib")}
    print(smi)  # the card's name and power limit, as nvidia-smi prints them
    print(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"nvcc: {nvcc[-1] if nvcc else 'unknown'}, "
          + ", ".join(f"{k} {v}" for k, v in versions.items())
          + f", {torch.cuda.device_count()} card(s)")
    return smi


def _version(module):
    """Whether ``module`` imports: "imports, <its version>", or "does not
    import" with the error's type."""
    import importlib

    try:
        return f"imports, {importlib.import_module(module).__version__}"
    except Exception as exc:  # noqa: BLE001  (printed, nothing depends on it)
        return f"does not import ({type(exc).__name__})"


def _kernel_label(mangled):
    """``name<args>`` of a mangled kernel template instantiation, e.g.
    ``mala_sweep_k4_kernel<16,8,16,1,0,1>`` (H, W, lanes, bridge, noise
    kind, PSF kind) or a wide route's ``mh_sweep_k2g_kernel_wide<1,2>``."""
    m = re.search(r"_kernel(?:_wide)?I((?:L[ib]\d+E)+)E", mangled)
    if m is None:
        return mangled[:60]
    end = m.start(1) - 1  # the name ends before the template's "I"
    for start in range(end - 1, 0, -1):  # the closest length prefix
        digits = re.search(r"\d+$", mangled[:start])
        if digits and any(int(digits.group()[k:]) == end - start
                          for k in range(len(digits.group()))):
            values = re.findall(r"L[ib](\d+)E", m.group(1))
            return f"{mangled[start:end]}<{','.join(values)}>"
    return mangled[:60]


def kernel_id(name):
    """The id (K1 to K5, K2g to K4g) of a sweep or chain kernel from its
    function name,
    as ``_kernel_label`` or the profiler writes it; None for any other
    function. K1 is K2's lane-group kernel instantiated for the M71 8x8
    target (template arguments 8, 8, lanes, Gaussian noise 0, SDSS beta = 3
    PSF 1)."""
    flat = name.replace(" ", "")
    if re.search(r"mh_sweep_k2_kernel<8,8,\d+,0,1>", flat):
        return "K1"
    for pattern, kid in (("mh_sweep_k2_kernel", "K2"),
                         ("mh_sweep_k3_kernel", "K3"),
                         ("mala_sweep_k4_kernel", "K4"),
                         ("chain_k5_kernel", "K5"),
                         ("mh_sweep_k2g_kernel", "K2g"),
                         ("mh_sweep_k3g_kernel", "K3g"),
                         ("mala_sweep_k4g_kernel", "K4g")):
        if pattern in flat:
            return kid
    return None


def launch_geometry(fn):
    """The grid of the last sweep or chain kernel that ``fn()`` launches,
    from a ``torch.profiler`` trace: ``{"blocks", "per_sm", "waves"}``, with
    ``per_sm`` the blocks one SM holds at once by the kernel's registers,
    shared memory and block size (whole warps' registers in units of 256,
    1 KiB of shared memory reserved per block), ``waves`` the blocks over
    all SMs' room, and ``device_ms`` the kernel's time in the trace. ``fn``
    runs once untraced before each of up to three traces. Only
    ``device_ms`` where the trace does not give the grid; empty where no
    trace holds the kernel."""
    import os

    from torch.profiler import ProfilerActivity, profile

    found = []
    for _ in range(3):  # a trace now and then lacks the kernel: try again
        fn()  # warm: the traced launch is never a first one
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        found = [e for e in events if e.get("cat") == "kernel"
                 and kernel_id(e.get("name", "")) and "dur" in e]
        if found:
            break
    if not found:
        return {}
    out = {"device_ms": float(found[-1]["dur"]) / 1e3}
    try:
        args = found[-1].get("args", {})
        blocks = int(np.prod(args["grid"]))
        threads = int(np.prod(args["block"]))
        regs = int(args["registers per thread"])
        smem = int(args["shared memory"])
    except (KeyError, TypeError, ValueError):
        return out
    props = torch.cuda.get_device_properties(0)
    warps = -(-threads // 32)
    warp_regs = -(-regs * 32 // 256) * 256
    per_sm = min(2048 // threads, 32, 65536 // (warp_regs * warps),
                 233472 // (smem + 1024))
    return {**out, "blocks": blocks, "per_sm": per_sm,
            "waves": blocks / (props.multi_processor_count * per_sm)}


def _geometry_text(geo):
    if "blocks" not in geo:
        return "blocks not measured"
    return (f"{geo['blocks']} blocks, {geo['per_sm']} per SM, "
            f"{geo['waves']:.2f} waves")


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


def _equilibrium(dev, label, kernel, ctx, counts, state, sweeps=800,
                 cache_tol=2e-3):
    """``sweeps`` sweeps of each on different streams: tempered-target
    q50/q75 within 5% + 5 nats, acceptance within 0.02 (the bounds of
    tests/test_pallas.py:107-154, at its 800 sweeps), and the kernel's
    caches (the rate, and the child rate on the bridge) against a fresh
    render: their largest relative difference below ``cache_tol``, the
    log-likelihoods' below 2e-3."""
    from smcdet_tpu_torch.inference.kernels import init_kernel_state

    saved, res = kernel.num_iters, {}
    kernel.num_iters = sweeps
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
        print(f"[{label}] {sweeps} sweeps q{q}: plain {a:.3f} kernel "
              f"{b:.3f}")
        assert abs(a - b) <= 0.05 * abs(a) + 5.0, (q, a, b)
    ak, ap = float(acck.mean()), float(accp.mean())
    print(f"[{label}] {sweeps} sweeps acceptance: plain {ap:.5f} kernel "
          f"{ak:.5f}")
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
        assert drift < cache_tol and ll_drift < 2e-3, (drift, ll_drift)
    lp_err = float((stk.logprior - fresh.logprior).abs().max())
    print(f"[{label}] logprior max abs {lp_err:.3e}")
    assert lp_err < 0.01


# The equilibrium checks of K1-K4 (phases 4-7) are saved where phases 4-7
# make them and run in EQ_WORKERS processes of this script (``--worker``,
# apart from the seed workers) while [dnc] and [mala dnc] run here: the
# plain version's 800 sweeps are host-bound (10-15 ms each; the 14 checks
# took about 190 s in this process on a slow host), and those two phases,
# which time no kernel, share the card with the seed workers already. A
# check's draws depend only on its inputs and seeds, so a worker's is the
# one this process would make. ``main`` sets the directory; unset, a check
# runs here at once.
EQ_WORKERS = 2
_DEFERRED = {"dir": None, "jobs": []}


def _owned(x):
    """``x`` with each tensor in it, and in its NamedTuple fields, copied
    out of any larger storage, so that ``torch.save`` writes its elements
    alone."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*map(_owned, x))
    return x


def _defer_equilibrium(dev, label, kernel, ctx, counts, state):
    """``_equilibrium`` over 800 sweeps: saved for the equilibrium worker
    (``_DEFERRED``), or run here at once when no worker takes it."""
    if _DEFERRED["dir"] is None:
        _equilibrium(dev, label, kernel, ctx, counts, state)
        return
    path = Path(_DEFERRED["dir"]) / f"eq{len(_DEFERRED['jobs'])}.pt"
    torch.save({"label": label, "kernel": kernel, "ctx": _owned(ctx),
                "counts": counts.clone(), "state": _owned(state)}, path)
    _DEFERRED["jobs"].append((path, label))


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
    geo = launch_geometry(lambda: mh_sweep.mh_sweeps(*args))
    updates = G * N * 100
    bound_ms, bound_by = sweep_bound(prior, model, args[6], args[9],
                                     M, 100)
    measured_ms, _ = sweep_bound(prior, model, args[6], args[9], M, 100,
                                 peaks=peaks)
    print(f"[{label}] 100 sweeps, {G} groups x {N} particles: kernel "
          f"{ms:.3f} ms ({updates / (ms * 1e-3):.4e} updates/s; "
          f"{_geometry_text(geo)}), plain "
          f"{plain_ms:.3f} ms ({updates / (plain_ms * 1e-3):.4e} "
          f"updates/s), bound {bound_ms:.4f} ms ({bound_by}; at K5's "
          f"measured rates {measured_ms:.4f} ms)")
    del ctx, counts, state, args
    # equilibrium on two tiles (the size of tests/test_pallas.py:107-154)
    ctx, counts, state = _kernel_inputs(dev, prior, model, 2, N, 0)
    _defer_equilibrium(dev, label, kernel, ctx, counts, state)
    return {"max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "measured_bound_ms": measured_ms,
            "shape": f"{G} groups x {N}, {model.height}x{model.width}, "
                     f"M={M}, 100 sweeps"}


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


def launch_agreement(run, plain, args, child=None, sweeps=20, bar=0.99):
    """A sweep kernel's wrapper ``run`` against its plain version ``plain``
    (``mh_sweeps`` and ``mh_sweeps_reference``, or MALA's) on the flattened
    arguments ``args`` of a launch, with every other particle of the first
    group set to count 0 (empty and occupied particles mixed in one warp)
    and ``sweeps`` sweeps on one key: the empty ones pass through
    bit-exactly (acceptance 0), and at least 99% of particles agree to rtol
    1e-4, the bars of ``branch_check`` (``bar``: the share held). Returns
    ``(share, err)``: the share that agrees and the largest absolute
    difference of pll and lp on the particles that agree (NaN where none
    does)."""
    short = list(args)
    short[6] = args[6].clone()
    short[6][0, ::2] = 0
    short[12] = sweeps
    outs = run(*short, child=child)
    ref = plain(*short, child=child)
    ins = list(args[7:12]) + ([] if child is None else [child.rate, child.ll])
    for out, inp in zip(outs[:5] + outs[6:], ins):
        assert torch.equal(out[0, ::2], inp[0, ::2]), (
            "zero-count passthrough moved")
    assert float(outs[5][0, ::2].abs().max()) == 0.0
    agree = _agreement(outs, ref, tuple(short[6].shape))
    share = float(agree.float().mean())
    assert share >= bar, share
    if not bool(agree.any()):
        return share, float("nan")
    err = max(float((a[agree] - b[agree]).abs().max())
              for a, b in zip(outs[3:5], ref[3:5]))
    return share, err


def sweep_bound(prior, model, counts, rate, M, sweeps, child=False,
                mala=False, peaks=(PEAK_FP32, PEAK_SFU)):
    """``(bound_ms, bound_by)`` of ``sweeps`` sweeps over particles with
    ``counts [G, N]`` and rate cache ``rate [G, N, H*W]`` (only particles
    with a star move, so only theirs are counted) on the tile target or,
    with ``child``, the bridge's; MH sweeps, or with ``mala`` MALA's.
    ``peaks`` are the FP32 (flop/s) and SFU (results/s) rates: the data
    sheet's, or K5's measured ones. The same function, so the same bound,
    whichever kernel computes it (K4g's reads of the caches it keeps in
    device memory, and those of K2g's and K3g's wide route, are their
    design's traffic, not the function's)."""
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
    if child is not None:
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
    equilibrium over 800 sweeps on the first 512 particles of each group
    (``_defer_equilibrium``). Returns the record of the one-image launch."""
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
                          bound_by=bound_by, measured_bound_ms=measured_ms,
                          shape=f"{groups} groups x {N}, {shape}, "
                                f"{sweeps} sweeps")
    _defer_equilibrium(dev, label, kernel,
                       *_first_particles(ctx, counts, state, 512))
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
    rec = dict(records[0], levels=records)
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
    ``eq_problem`` (a cut of the same target; ``_defer_equilibrium``).
    Returns its record."""
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
    shape = (f"{G} groups x {N}, {model.height}x{model.width}, M={M}{mode}, "
             f"{sweeps} sweeps")
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
    geo = launch_geometry(lambda: mala_sweep.mala_sweeps(*args, child=child))
    bound = [sweep_bound(ctx.prior, model, args[6], args[9], M, sweeps,
                         child=child is not None, mala=True, peaks=p)
             for p in ((PEAK_FP32, PEAK_SFU), peaks)]
    updates = args[6].numel() * sweeps
    print(f"[{label}] {sweeps} sweeps, {G} groups x {N} particles: kernel "
          f"{ms:.3f} ms ({updates / (ms * 1e-3):.4e} updates/s; "
          f"{_geometry_text(geo)}), plain {plain_ms:.3f} ms, bound "
          f"{bound[0][0]:.4f} ms ({bound[0][1]}; at K5's measured rates "
          f"{bound[1][0]:.4f} ms, {bound[1][1]})")
    _defer_equilibrium(dev, label, kernel, *eq_problem)
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


def time_launch(path, name, args, peaks, child=None, label="shapes",
                check=True):
    """Sweep kernel ``name`` (any sweep kernel but K5; the router must name
    it) at the launch ``args`` of ``path``: CUDA-event time of 5 launches
    and the bound at the data sheet's peaks and at K5's ``peaks``; with
    ``check`` (for a launch not held against its plain version elsewhere)
    also the plain version's time of one launch, the grid
    (``launch_geometry``) and ``launch_agreement`` with the plain version.
    Prints one ``[label]`` line; returns the record (with
    ``max_abs_err``, of pll and lp where the two agree)."""
    run, plain, mala = _sweep_route(name, args, child)
    prior, model, sweeps = args[2], args[3], args[12]
    M = args[8].shape[-1]
    ms = _time_ms(lambda: run(*args, child=child), reps=5)
    bound = [sweep_bound(prior, model, args[6], args[9], M, sweeps,
                         child=child is not None, mala=mala, peaks=p)
             for p in ((PEAK_FP32, PEAK_SFU), peaks)]
    G, N = args[6].shape
    shape = (f"{G} groups x {N}, {model.height}x{model.width}, M={M}, "
             f"{sweeps} sweeps")
    rec = {"ms": ms, "bound_ms": bound[0][0], "bound_by": bound[0][1],
           "measured_bound_ms": bound[1][0], "shape": shape}
    text = (f"[{label}] {name} {path} ({shape}): kernel {ms:.3f} ms, bound "
            f"{bound[0][0]:.4f} ms ({bound[0][1]}; at K5's measured rates "
            f"{bound[1][0]:.4f} ms)")
    if check:
        rec["plain_ms"] = _time_ms(lambda: plain(*args, child=child), reps=1)
        rec["geometry"] = launch_geometry(lambda: run(*args, child=child))
        rec["agreement"], rec["max_abs_err"] = launch_agreement(
            run, plain, args, child)
        text += (f"; {_geometry_text(rec['geometry'])}, plain "
                 f"{rec['plain_ms']:.3f} ms; zero-count particles pass "
                 f"through bit-exactly, {rec['agreement']:.6f} of particles "
                 f"agree after 20 same-stream sweeps (pll/lp max abs err "
                 f"{rec['max_abs_err']:.3e})")
    print(text)
    return rec


def _sweep_route(name, args, child):
    """The wrapper, the plain version and whether it is MALA, of the sweep
    kernel ``name``, which the router must name for the launch ``args``
    (and ``child``)."""
    from smcdet_tpu_torch.ops import mala_sweep, mh_sweep

    prior, model, M = args[2], args[3], args[8].shape[-1]
    if name.startswith("K4"):
        assert mala_sweep.mala_kernel(prior, model, M,
                                      child=child is not None) == name
        return (mala_sweep.mala_sweeps, mala_sweep.mala_sweeps_reference,
                True)
    assert mh_sweep.sweep_kernel(prior, model, M,
                                 child=child is not None) == name
    return mh_sweep.mh_sweeps, mh_sweep.mh_sweeps_reference, False


def phase_launch_shapes(dev, levels, peaks):
    """The sweep kernels timed at the launch shapes of the paths whose
    launches ``main`` counts but whose shapes no phase above times: K1 at
    one divideandconquer image's tile launch (4 tiles x 9 strata x 512, 50
    sweeps), K4 at the same launch under ``[mala dnc]``'s steps and at one
    image's two bridge launches (``levels`` cut to one image: level 0, 2
    groups x 4608, 16x8, M = 16; level 1, 1 x 4608, 16x16, M = 32; origin
    tags), K2 at one m71 fixture tile's launch (the fitted general-wing
    PSF, 11 strata x 2048, M = 10, 100 sweeps) and at the cells batch's
    (130 groups x 4096 at the suite's 200 sweeps; phase 5 times 100). Each
    beside its bound (the data sheet's and at K5's ``peaks``) and its plain
    version's time, and held against the plain version at that shape by
    ``launch_agreement``.
    Returns ``{"<path> <kernel>": record}``."""
    key = torch.tensor([12345, 67890], dtype=torch.int64, device=dev)
    records = {}

    def timed(path, name, args, child=None):
        records[f"{path} {name}"] = time_launch(path, name, args, peaks,
                                                child)

    _, tprior, tmodel, mh, _ = _dnc_problem(dev)
    problem = _kernel_inputs(dev, tprior, tmodel, 4, 512, 0)
    timed("dnc tile", "K1", _sweep_args(key, mh, *problem, mh.num_iters))
    mala = mala_kernel_for(mh, MALA_DNC_STEPS, dev)
    timed("dnc tile", "K4", _sweep_args(key, mala, *problem, mala.num_iters))
    for i, (ctx, counts, state) in enumerate(levels):
        args, child = _groups(
            _sweep_args(key, mala, ctx, counts, state, mala.num_iters),
            _flat_child(ctx, counts, state), counts.shape[1])
        timed(f"dnc bridge level {i}", "K4", args, child)
    prior, model, kernel, _ = suite_problem(dev, "m71")
    timed("m71 tile", "K2", _sweep_args(
        key, kernel, *_kernel_inputs(dev, prior, model, 1, 2048, 0),
        kernel.num_iters))
    prior, model, kernel, _ = suite_problem(dev, "cells")
    timed("cells batch", "K2", _sweep_args(
        key, kernel, *_kernel_inputs(dev, prior, model, 10, 4096, 0),
        kernel.num_iters))
    return records


def phase_main_path(dev):
    """The M71 quick cell through ``run_csmc_chunked``, every mutate call a
    K1 launch, held to the JAX reference's detection share. Returns K1's
    launches and the run's wall seconds."""
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
    gen = torch.Generator(device=dev).manual_seed(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
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
    _check_chunk_budget("main", "quick cell", prior, N, TILE * TILE, T,
                        peak - before)

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
    return launches, elapsed


def _entry_batch(dev, cfg, label, out_root, capture=None, tempered=True):
    """One full batch of a chunked suite (``cfg``, as loaded) through
    ``run_experiment``, its mutate calls counted; returns (calls, launches,
    results). ``capture``: as ``_aggregation_batch``'s. Every tile ends at
    temperature 1, or with ``tempered=False`` (a run cut to fewer SMC
    iterations than it needs) runs ``max_smc_iters`` iterations and ends
    below 1."""
    from smcdet_tpu_torch.config import build_prior
    from smcdet_tpu_torch.runner import load_results, run_experiment

    T = cfg.num_images = cfg.batch_size
    cfg.output_dir = out_root
    with _Calls(capture) as calls:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
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
    sweeps = cfg.kernel.num_iters + s.relocate_sweeps + s.pair_sweeps
    updates = T * C * N * sweeps * iters
    print(f"[{label}] {cfg.name}: {T} tiles x {C} strata x N={N}, "
          f"{cfg.kernel.num_iters} {kind.upper()} + {s.relocate_sweeps} "
          f"relocation + {s.pair_sweeps} pair sweeps/iter: {iters} SMC "
          f"iterations, batch "
          f"{runtime:.3f} s ({runtime / iters * 1e3:.1f} ms/iter; "
          f"run_experiment {wall:.3f} s with the tile simulation)")
    print(f"[{label}] {cfg.name}: {updates / runtime:.6e} updates/s "
          f"({kind.upper()} "
          f"{T * C * N * cfg.kernel.num_iters * iters / runtime:.6e}), "
          f"{T / runtime:.4f} tiles/s, peak memory {peak} B "
          f"({peak / 2**30:.3f} GiB); mutate calls {calls.tile[kind]}, "
          f"launches {launches}")
    _check_chunk_budget(label, cfg.name, build_prior(cfg.prior, "cpu"), N,
                        cfg.image_model.image_height
                        * cfg.image_model.image_width, T, peak - before)
    assert calls.tile[kind] == iters and sum(calls.bridge.values()) == 0
    assert res["image_index"].tolist() == list(range(T))
    if tempered:
        assert np.all(res["temperature"] == 1.0), res["temperature"]
    else:
        assert iters == s.max_smc_iters, iters
        assert np.all((res["temperature"] > 0.0)
                      & (res["temperature"] < 1.0)), res["temperature"]
    assert np.isfinite(res["log_normalizing_constant"]).all()
    np.testing.assert_allclose(res["weights"].sum(-1), 1.0, atol=1e-5)
    return calls, launches, res


def _check_chunk_budget(label, name, prior, N, tile_hw, T, peak):
    """A run's peak memory above what was allocated before it, against
    ``run_csmc_chunked``'s estimate for its ``T`` tiles
    (``chunk_bytes_per_tile``): a full frame's chunk, sized by that
    estimate, stays inside its budget. Prints the peak as rate copies."""
    from smcdet_tpu_torch.inference import smc

    per_tile = smc.chunk_bytes_per_tile(prior, N, tile_hw)
    rate = prior.num_counts * N * tile_hw * 4
    copies = (peak / T - (per_tile - smc.RATE_COPIES * rate)) / rate
    print(f"[{label}] {name}: peak {peak / T / 2**20:.1f} MiB per tile "
          f"above the allocation before the run, {copies:.2f} rate copies; "
          f"chunk estimate {per_tile / 2**20:.1f} MiB per tile "
          f"({smc.RATE_COPIES} copies; ratio {peak / (T * per_tile):.3f})")
    assert peak <= T * per_tile, (peak, T * per_tile)


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


def _write_tiles(cfg, out_dir):
    """The batch's simulated tiles (``run_experiment``'s, for ``cfg`` as it
    ran) in ``out_dir/tiles.npz``, where the analyzer reads the truth."""
    from smcdet_tpu_torch.runner import simulate_tiles

    tiles = simulate_tiles(cfg)
    np.savez_compressed(Path(out_dir) / "tiles.npz", **tiles)
    return tiles


def phase_entry_point(dev, work):
    """``run_experiment`` on one batch each of basic and cells (K2), into
    ``work``; returns the K2 launches of each, basic's results and the two
    results directories (with their tiles, for ``[score]``)."""
    cfg = _suite_config("basic")
    calls, launches, basic = _entry_batch(dev, cfg, "entry", work)
    k2 = {"basic": launches["K2"]}
    assert k2["basic"] == calls.tile["mh"] and launches["K1"] == 0, launches
    truth = _write_tiles(cfg, Path(work) / "basic")["true_counts"]
    assert truth.tolist() == BASIC_TRUE_COUNTS, (
        "the simulated basic tiles differ from the reference's",
        truth.tolist())
    _basic_share("entry", basic, truth, BASIC_REFERENCE_COUNT_SHARE)
    cfg = _suite_config("cells")
    calls, launches, res = _entry_batch(dev, cfg, "entry", work)
    assert launches["K2"] == calls.tile["mh"] and launches["K1"] == 0
    k2["cells"] = launches["K2"]
    _write_tiles(cfg, Path(work) / "cells")
    mean = (res["weights"] * res["pruned_counts"]).sum(-1)
    print(f"[entry] cells: posterior mean pruned count "
          f"{[round(float(x), 3) for x in mean]}")
    return k2, basic, {"basic": Path(work) / "basic",
                       "cells": Path(work) / "cells"}


def _pair_config(work):
    """``experiments/cells/config_pair.yaml`` at one batch, reading the
    ``[entry]`` cells batch's tiles (its ``data_path`` is the cells suite's
    tiles) and writing under ``work``."""
    from smcdet_tpu_torch.config import load_config

    cfg = load_config("experiments/cells/config_pair.yaml")
    cfg.data_path = str(Path(work) / "cells" / "tiles.npz")
    cfg.output_dir = str(work)
    return cfg


def phase_pair(dev, work, cells_res):
    """``run_experiment`` on one batch of ``cells_pair`` (10 16x16 tiles,
    N = 4096, C = 13, 200 sweeps + 16 relocations + 8 pair sweeps per SMC
    iteration) on the ``[entry]`` cells batch's tiles: every mutate call a
    K2 launch and none of K1, the pair move's applied share in (0, 1), the
    posterior mean pruned counts beside the cells batch's. Then one basic
    batch with 16 relocation and 8 pair sweeps, whose peak memory holds the
    chunk estimate at 8x8 with both moves. Returns the K2 launches of each
    batch and the cells_pair results directory."""
    from smcdet_tpu_torch.inference.kernels import pair_redistribute_sweeps
    from smcdet_tpu_torch.runner import load_results

    cfg = _pair_config(work)
    pair_redistribute_sweeps.calls = 0
    pair_redistribute_sweeps.applied = 0.0
    calls, launches, res = _entry_batch(dev, cfg, "pair", work)
    assert launches["K2"] == calls.tile["mh"] and launches["K1"] == 0, \
        launches
    assert all(launches[k] == 0 for k in ("K3", "K4 tile", "K4 bridge"))
    iters = int(res["num_iters"][0])
    n_calls = pair_redistribute_sweeps.calls
    assert n_calls == iters, (n_calls, iters)
    share = float(pair_redistribute_sweeps.applied) / n_calls
    print(f"[pair] pair move: {n_calls} calls of "
          f"{cfg.sampler.pair_sweeps} sweeps, applied share {share:.6f}; "
          f"blended acceptance per tile "
          f"{[round(float(x), 4) for x in res['acc_rate']]}")
    assert 0.0 < share < 1.0, share
    truth = np.load(cfg.data_path)["true_counts"][:cfg.num_images]
    mean = (res["weights"] * res["pruned_counts"]).sum(-1)
    cells = load_results(cells_res)
    cmean = (cells["weights"] * cells["pruned_counts"]).sum(-1)
    print(f"[pair] truth           {truth.tolist()}")
    print(f"[pair] cells_pair mean {[round(float(x), 3) for x in mean]}")
    print(f"[pair] cells mean      {[round(float(x), 3) for x in cmean]}")
    print(f"[pair] within +-1 of truth: cells_pair "
          f"{int((np.abs(mean - truth) <= 1).sum())}/{len(truth)}, cells "
          f"{int((np.abs(cmean - truth) <= 1).sum())}/{len(truth)}; SMC "
          f"iterations {iters} vs {int(cells['num_iters'][0])}")
    k2 = {"cells_pair": launches["K2"]}
    cfg = _suite_config("basic")
    cfg.name = "basic_moves"
    cfg.sampler.relocate_sweeps, cfg.sampler.pair_sweeps = 16, 8
    calls, launches, _ = _entry_batch(dev, cfg, "pair", work)
    assert launches["K2"] == calls.tile["mh"] and launches["K1"] == 0, \
        launches
    k2["basic with moves"] = launches["K2"]
    return k2, Path(work) / "cells_pair"


def _match_diff(a, b):
    """The (tile, catalog) cells where two ``MatchCounts`` differ."""
    diff = torch.zeros(a[0].shape[:2], dtype=torch.bool)
    for x, y in zip(a, b):
        diff |= (x.cpu() != y.cpu()).any(-1)
    return diff


def _boundary_pairs(results_dir, tiles, idx, locs_tol, mags_tol, eps=1e-5):
    """``[T, S]`` counts of the (true, estimated) pairs of the sampled
    catalogs whose location distance lies within ``eps`` of ``locs_tol``,
    and of those whose magnitude distance lies within ``eps`` of
    ``mags_tol`` (the pairs whose matchability rounding can flip)."""
    from smcdet_tpu_torch.runner import load_results
    from smcdet_tpu_torch.utils.units import convert_nmgy_to_mag

    res = load_results(results_dir)
    truth = np.load(tiles)
    n = res["counts"].shape[0]
    tc = torch.as_tensor(truth["true_counts"][:n])
    tl = torch.as_tensor(truth["true_locs"][:n]).double()
    tf = torch.as_tensor(np.maximum(truth["true_fluxes"][:n], 1e-6))
    ec, el, ef = (torch.as_tensor(res[k]) for k in (
        "pruned_counts", "pruned_locs", "pruned_fluxes"))
    i = torch.as_tensor(idx).long()
    ec = ec.gather(1, i)
    el = el.gather(1, i[..., None, None].expand(i.shape + el.shape[2:]))
    ef = ef.gather(1, i[..., None].expand(i.shape + ef.shape[2:]))
    ef = torch.as_tensor(np.maximum(ef.numpy(), 1e-6))
    tv = torch.arange(tl.shape[1]) < tc[:, None]
    ev = torch.arange(el.shape[2]) < ec[..., None]
    both = tv[:, None, :, None] & ev[:, :, None, :]
    dist = (tl[:, None, :, None] - el.double()[:, :, None]).norm(dim=-1)
    mags = (convert_nmgy_to_mag(tf.double())[:, None, :, None]
            - convert_nmgy_to_mag(ef.double())[:, :, None]).abs()
    near_l = (both & ((dist - locs_tol).abs() <= eps)).sum((-1, -2))
    near_m = (both & ((mags - mags_tol).abs() <= eps)).sum((-1, -2))
    return near_l, near_m


def phase_score(dev, dirs, tiles):
    """The port's analyzer (``smcdet_tpu_torch.analyze``) on the ``[entry]``
    basic and cells batches and the ``[pair]`` batch, matching once on the
    card and once on the CPU with the same sampled catalogs: the
    ``MatchCounts`` identical but where a pair's location or magnitude
    distance lies within 1e-5 of its tolerance (each such pair counted and
    printed); then count accuracy, confusion asymmetry, coverage at 0.95
    and F1 by magnitude bin, and the matching's time on the card."""
    from smcdet_tpu_torch.analyze import analyze, catalog_indices
    from smcdet_tpu_torch.metrics import match_catalogs
    from smcdet_tpu_torch.runner import load_results

    kw = dict(num_match=50, locs_tol=0.5, mags_tol=0.5, bootstrap=1000)
    for name, path in dirs.items():
        drawn = {}

        def draw(seed, weights, num):
            drawn[seed] = catalog_indices(seed, weights, num)
            return drawn[seed]

        reports = {d: analyze(path, device=d, tiles=tiles[name],
                              draw=draw, figures=False, **kw)
                   for d in ("cuda", "cpu")}
        # the analyzer's first matching again, on either device with the
        # catalogs it drew
        res = load_results(path)
        truth = np.load(tiles[name])
        n = res["counts"].shape[0]
        host = (truth["true_counts"][:n], truth["true_locs"][:n],
                np.maximum(truth["true_fluxes"][:n], 1e-6),
                res["pruned_counts"], res["pruned_locs"],
                np.maximum(res["pruned_fluxes"], 1e-6))

        def matching(device):
            args = [torch.as_tensor(np.asarray(x), device=device)
                    for x in host]
            idx = drawn[0].to(device)
            return lambda: match_catalogs(
                *args, num_est_catalogs_to_match=kw["num_match"],
                locs_tol=kw["locs_tol"], mags_tol=kw["mags_tol"],
                mag_bins=[15.0, 18.0, 21.0, 24.0], indices=idx)

        solve = matching(dev)
        mc = {"cuda": solve(), "cpu": matching("cpu")()}
        diff = _match_diff(mc["cuda"], mc["cpu"])
        near_l, near_m = _boundary_pairs(path, tiles[name], drawn[0],
                                         kw["locs_tol"], kw["mags_tol"])
        n_diff = int(diff.sum())
        print(f"[score] {name}: MatchCounts cuda vs cpu differ in {n_diff} "
              f"of {diff.numel()} (tile, catalog) cells; pairs within 1e-5 "
              f"of locs_tol {int(near_l.sum())}, of mags_tol "
              f"{int(near_m.sum())}")
        for t, s in diff.nonzero().tolist():
            print(f"[score] {name}: tile {t} catalog {s}: boundary pairs "
                  f"(locs) {int(near_l[t, s])}, (mags) {int(near_m[t, s])}")
        assert bool(((near_l + near_m)[diff] > 0).all()), \
            "MatchCounts differ away from the tolerance boundaries"
        a, b = reports["cuda"], reports["cpu"]
        for key in ("count_accuracy", "confusion_asymmetry",
                    "total_flux_coverage"):
            assert a[key] == b[key], (key, a[key], b[key])
        f1 = a["detection"]["f1_by_bin"]
        print(f"[score] {name}: {a['images']} images, count accuracy "
              f"{a['count_accuracy']}, confusion asymmetry "
              f"{a['confusion_asymmetry']}, coverage at 0.95 "
              f"{a['total_flux_coverage']['0.95']}, SBC KS p "
              f"{a['sbc_total_flux_ks_pvalue']}; F1 by bin {f1['point']} "
              f"(ci95 {f1['ci95_lo']} .. {f1['ci95_hi']}); cpu F1 "
              f"{b['detection']['f1_by_bin']['point']}")
        # the solver on the card: the batch's 50 catalogs per tile
        ms = _time_ms(solve, 3)
        n_slots = max(host[1].shape[1], host[4].shape[2])
        print(f"[score] {name}: matching {drawn[0].numel()} catalogs "
              f"({n_slots}x{n_slots} assignments) on the card: {ms:.3f} ms")


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
    acceptance), while the ``with`` block runs. With ``capture`` (a dict)
    it also keeps a copy of each shape's first call: ``capture[(kind,
    bridge, H, W, M)] = (kernel, ctx, counts, state)``."""

    def __init__(self, capture=None):
        self.capture = capture

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
            def counted(kernel, gen, ctx, counts, state, *args, **kwargs):
                target = self.tile if ctx.child_model is None else self.bridge
                target[kind] += 1
                key = (kind, ctx.child_model is not None, ctx.model.height,
                       ctx.model.width, state.fluxes.shape[-1])
                if self.capture is not None and key not in self.capture:
                    self.capture[key] = (kernel, ctx, counts.clone(),
                                         type(state)(*(
                                             None if v is None else v.clone()
                                             for v in state)))
                return run_from_state(kernel, gen, ctx, counts, state, *args,
                                      **kwargs)
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
    mh_sweep.mh_sweeps.k2g_launches = 0
    mh_sweep.mh_sweeps.k3g_launches = 0
    mala_sweep.mala_sweeps.launches = 0
    mala_sweep.mala_sweeps.bridge_launches = 0
    mala_sweep.mala_sweeps.k4g_launches = 0
    mala_sweep.mala_sweeps.k4g_bridge_launches = 0
    roofline.chain.launches = 0


def _launches():
    from smcdet_tpu_torch import roofline
    from smcdet_tpu_torch.ops import mala_sweep, mh_sweep

    f, g = mh_sweep.mh_sweeps, mala_sweep.mala_sweeps
    return {"K1": f.launches, "K2": f.k2_launches, "K3": f.k3_launches,
            "K4 tile": g.launches, "K4 bridge": g.bridge_launches,
            "K5": roofline.chain.launches, "K2g": f.k2g_launches,
            "K3g": f.k3g_launches, "K4g tile": g.k4g_launches,
            "K4g bridge": g.k4g_bridge_launches}


def _aggregation_batch(dev, cfg, label, capture=None):
    """One batch of an aggregation-enabled suite through ``run_experiment``
    with the tile and bridge mutate calls counted against the kernels'
    launches; returns (launches, results, per-image level diagnostics, the
    peak memory above the allocation before the run). ``capture``: a dict
    that receives each shape's first mutate call (``_Calls``)."""
    from smcdet_tpu_torch.runner import load_results, run_experiment

    with _Calls(capture) as calls:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
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
    assert launches["K1"] + launches["K2"] + launches["K2g"] == calls.tile[
        "mh"], (launches, calls.tile)
    assert launches["K3"] + launches["K3g"] == calls.bridge["mh"], (
        launches, calls.bridge)
    assert launches["K4 tile"] + launches["K4g tile"] == calls.tile[
        "mala"], (launches, calls.tile)
    assert launches["K4 bridge"] + launches["K4g bridge"] == calls.bridge[
        "mala"], (launches, calls.bridge)
    assert res["image_index"].tolist() == list(range(cfg.num_images))
    assert np.isfinite(res["log_normalizing_constant"].max(-1)).all()
    np.testing.assert_allclose(res["weights"].sum(-1), 1.0, atol=1e-5)
    return launches, res, calls.levels, peak - before


def _count_share(label, res, truth):
    return _share_of_means(label, (res["weights"] * res["pruned_counts"]
                                   ).sum(-1), truth)


def _share_of_means(label, mean, truth):
    within = np.abs(mean - truth) <= 1.0
    print(f"[{label}] posterior mean pruned count within +-1 of truth on "
          f"{int(within.sum())}/{len(within)} images")
    print(f"[{label}] truth {list(map(int, truth))}")
    print(f"[{label}] mean  {[round(float(x), 3) for x in mean]}")
    return float(within.mean())


def _stage_runs(cfg, tiles, seeds, label, workers):
    """Stage ``tiles`` as the batch of one run per sampler seed, each in a
    directory of its own under ``cfg.output_dir`` (``run_experiment`` skips
    a batch it finds done), and hand every seed but the first to
    ``workers`` (``_Workers``; none: every run in this process).
    Returns ``{seed: job}``."""
    from smcdet_tpu_torch.config import save_config

    out_dir, jobs = cfg.output_dir, {}
    for run_seed in seeds:
        cfg.seed, cfg.output_dir = run_seed, f"{out_dir}/seed{run_seed}"
        staged = Path(cfg.output_dir) / cfg.name / "tiles.npz"
        staged.parent.mkdir(parents=True)
        np.savez_compressed(staged, **tiles)
        if workers is not None and run_seed != seeds[0]:
            save_config(cfg, Path(cfg.output_dir) / "config.yaml")
            jobs[run_seed] = workers.submit(
                Path(cfg.output_dir) / "config.yaml",
                f"{label} seed {run_seed}")
    cfg.output_dir = out_dir
    return jobs


# The seeds after the first of the [dnc], [mala dnc] and [m71ss] batches
# run in SEED_WORKERS processes of this script (``--worker``), started
# with the script and idle until then, while the first seed runs here:
# the runs are host-bound (one divideandconquer image leaves the card
# about 87% idle), so they overlap on one card. A run's draws depend only
# on its config and seed, so a worker's run is the one this process would
# make.
SEED_WORKERS = 3


class _Workers:
    """``n`` worker processes (``_worker``), each taking the jobs
    ``submit`` hands it in turn (a batch's config, or with ``kind``
    "equilibrium" a check ``_defer_equilibrium`` saved); ``result`` prints
    a job's lines and returns what it returned (a batch's
    ``_aggregation_batch`` launches, levels and posterior means), and
    raises if the job or its worker failed. ``close`` ends them."""

    def __init__(self, n):
        self.procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--worker"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
            for _ in range(n)]
        self.jobs, self.done = 0, {}

    def submit(self, config, label, kind="batch"):
        job, proc = self.jobs, self.procs[self.jobs % len(self.procs)]
        self.jobs += 1
        proc.stdin.write(json.dumps({"id": job, "config": str(config),
                                     "label": label, "kind": kind}) + "\n")
        proc.stdin.flush()
        return job

    def result(self, job):
        proc = self.procs[job % len(self.procs)]
        while job not in self.done:
            line = proc.stdout.readline()
            if not line:
                raise RuntimeError(f"seed worker {job % len(self.procs)} "
                                   f"exited with {proc.wait()}")
            out = json.loads(line)
            self.done[out["id"]] = out
        out = self.done.pop(job)
        print(out["log"], end="")
        if "error" in out:
            raise RuntimeError(f"seed worker job {job}: {out['error']}")
        return out

    def close(self):
        for proc in self.procs:
            try:
                proc.stdin.close()
            except OSError:
                pass
        for proc in self.procs:
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


def _worker():
    """``--worker``: for each job read from standard input (a file, a label
    and a kind, one JSON line) ``_aggregation_batch`` on the card of the
    config file, or ``_equilibrium`` of the check saved there (kind
    "equilibrium"), and one JSON line of its result on standard output:
    a batch's launches, levels and each image's posterior mean pruned
    count, and the lines the job printed (``"log"``), or the traceback
    (``"error"``)."""
    import contextlib
    import io
    import traceback

    from smcdet_tpu_torch.config import load_config

    dev = torch.device("cuda")
    torch.zeros(1, device=dev)
    for line in sys.stdin:
        job = json.loads(line)
        out, log = {"id": job["id"]}, io.StringIO()
        try:
            if job["kind"] == "equilibrium":
                saved = torch.load(job["config"], map_location=dev,
                                   weights_only=False)
                with contextlib.redirect_stdout(log):
                    _equilibrium(dev, saved["label"], saved["kernel"],
                                 saved["ctx"], saved["counts"],
                                 saved["state"])
            else:
                with contextlib.redirect_stdout(log):
                    launches, res, levels, _ = _aggregation_batch(
                        dev, load_config(job["config"]), job["label"])
                out.update(launches=launches, levels=[
                    [(int(it), t, acc) for it, t, acc in lv]
                    for lv in levels],
                    means=(res["weights"] * res["pruned_counts"]).sum(-1)
                    .tolist())
        except Exception:
            out["error"] = traceback.format_exc()
        out["log"] = log.getvalue()
        print(json.dumps(out), flush=True)


def _seed_runs(dev, cfg, tiles, seeds, label, workers):
    """``_aggregation_batch`` on the staged batch once per sampler seed in
    ``seeds``: the first in this process, the others in ``workers`` while
    it runs. Returns, per seed in order, ``(launches, levels, means)``:
    the run's launches, per-image level diagnostics and each image's
    posterior mean pruned count."""
    seed, out_dir = cfg.seed, cfg.output_dir
    jobs = _stage_runs(cfg, tiles, seeds, label, workers)
    runs = []
    for run_seed in seeds:
        if run_seed in jobs:
            out = workers.result(jobs[run_seed])
            runs.append((out["launches"], out["levels"],
                         np.asarray(out["means"])))
            continue
        cfg.seed, cfg.output_dir = run_seed, f"{out_dir}/seed{run_seed}"
        launches, res, levels, _ = _aggregation_batch(
            dev, cfg, f"{label} seed {run_seed}")
        runs.append((launches, levels,
                     (res["weights"] * res["pruned_counts"]).sum(-1)))
    cfg.seed, cfg.output_dir = seed, out_dir
    return runs


def dnc_runs(dev, cfg, label, seeds, workers=None):
    """The batch of 4 divideandconquer images through ``run_experiment``
    once per sampler seed in ``seeds`` (``_seed_runs``; the seeds after the
    first in ``workers``); the images stay those of ``cfg.seed`` (staged
    as each run's ``tiles.npz``). Returns the true
    pruned counts and, per run, ``(launches, levels, converged, means)``:
    ``_aggregation_batch``'s launches and per-image level diagnostics, each
    image's flag that its levels all reached temperature 1 below the cap,
    and each image's posterior mean pruned count."""
    from smcdet_tpu_torch.runner import simulate_tiles

    cfg.num_images = cfg.batch_size = 4
    tiles = simulate_tiles(cfg)
    cap = cfg.aggregation.max_smc_iters
    runs = []
    for launches, levels, means in _seed_runs(dev, cfg, tiles, seeds, label,
                                              workers):
        converged = [all(it < cap and np.all(np.asarray(t) == 1.0)
                         for it, t, _ in lv) for lv in levels]
        runs.append((launches, levels, converged, means))
    return tiles["true_counts"], runs


def binomial_floor(n, hits, alpha=DNC_ALPHA, n_ref=None):
    """The least number of successes in ``n`` trials outside the lower
    ``alpha`` tail of the binomial at the rate ``(hits + 1) / (n_ref + 2)``:
    the rule of succession's estimate from a reference's ``hits`` of
    ``n_ref`` trials (default ``n``)."""
    n_ref = n if n_ref is None else n_ref
    p, cdf = (hits + 1) / (n_ref + 2), 0.0
    for k in range(n + 1):
        cdf += math.comb(n, k) * p ** k * (1 - p) ** (n - k)
        if cdf >= alpha:
            return k
    return n


def _dnc_batch(dev, cfg, label, converged_bar, count_bar, reference_within,
               workers=None):
    """``dnc_runs`` with the sampler seeded by the config's seed and the
    ``DNC_RUNS - 1`` next ones: the first run's bridge iterations and
    temperatures per level, every run held to the JAX runner's convergence
    share, the first run's count within +-1 printed beside the JAX runner's
    single-run share ``count_bar`` (not held), and the count of image-runs
    within +-1 over all runs held to ``binomial_floor`` of the JAX runner's
    ``reference_within`` on the same seeds. Returns the first run's
    launches, with the bridge launches of each level under ``"bridge
    levels"`` (one launch per bridge iteration)."""
    truth, runs = dnc_runs(dev, cfg, label,
                           range(cfg.seed, cfg.seed + DNC_RUNS), workers)
    assert truth.tolist() == DNC_TRUE_COUNTS, truth.tolist()
    launches, levels = runs[0][:2]
    for i, lv in enumerate(levels):
        print(f"[{label}] image {i}: " + "; ".join(
            f"level {k} {it} bridge iterations, temperatures {t}, last "
            f"acceptance {acc:.4f}" for k, (it, t, acc) in enumerate(lv)))
    within = [int((np.abs(r[3] - truth) <= 1).sum()) for r in runs]
    for run, (_, _, converged, means) in enumerate(runs):
        print(f"[{label}] seed {cfg.seed + run}: {sum(converged)}/4 "
              f"converged, posterior mean pruned count "
              f"{[round(float(x), 3) for x in means]}, {within[run]}/4 "
              f"within +-1")
    met = within[0] / len(truth) >= count_bar - 1e-9
    print(f"[{label}] the config seed's run: {within[0]}/4 within +-1 "
          f"({'meets' if met else 'misses'} the JAX runner's single-run "
          f"share {count_bar}; PERF.md, ROADMAP.md)")
    converged = min(sum(r[2]) / len(r[2]) for r in runs)
    n, hits = len(truth) * len(runs), sum(within)
    floor = binomial_floor(n, reference_within)
    print(f"[{label}] truth {truth.tolist()}; over {len(runs)} runs "
          f"{hits}/{n} image-runs within +-1 (the JAX runner "
          f"{reference_within}/{n}; at least {floor}, outside the lower "
          f"{DNC_ALPHA} tail at its rate); every run converged on "
          f"{converged:.2f} of the images or more (JAX reference share "
          f"{converged_bar})")
    assert converged >= converged_bar - 1e-9, converged
    assert hits >= floor, (hits, floor)
    per_level = [sum(lv[k][0] for lv in levels if len(lv) > k)
                 for k in range(max(len(lv) for lv in levels))]
    assert sum(per_level) == launches["K3"] + launches["K4 bridge"], (
        per_level, launches)
    return dict(launches, **{"bridge levels": per_level})


def phase_aggregation(dev, workers=None):
    """The aggregation entry point: ``run_experiment`` on one batch of
    divideandconquer (4 16x16 images, shipped N, M, sweeps, ESS and bridge
    settings: tile stage K1, bridges K3) and on the first 8 tiles of the
    m71 real-data fixture (fitted params, per-tile backgrounds, the general
    SDSS wing: K2), each held to the JAX runner's shares."""
    from smcdet_tpu_torch.config import build_prior

    with tempfile.TemporaryDirectory() as tmp:
        cfg = _suite_config("divideandconquer")
        cfg.output_dir = tmp
        dnc = _dnc_batch(dev, cfg, "dnc", DNC_REFERENCE_CONVERGED_SHARE,
                         DNC_REFERENCE_COUNT_SHARE, DNC_JAX_WITHIN["MH"],
                         workers)
        assert dnc["K1"] > 0 and dnc["K3"] > 0 and dnc["K2"] == 0, dnc

        cfg = _suite_config("m71")
        cfg.data_path = "experiments/m71/data/m71/tiles.npz"
        cfg.num_images = cfg.batch_size = 8
        cfg.output_dir = tmp
        m71, res, levels, _ = _aggregation_batch(dev, cfg, "m71")
        assert m71["K2"] > 0 and m71["K1"] == m71["K3"] == 0, m71
        assert all(lv == [] for lv in levels)  # one tile: no level
        truth = np.load(cfg.data_path)["true_counts"][:8]
        share = _count_share("m71", res, truth)
        print(f"[m71] count share {share} (JAX reference "
              f"{M71_REFERENCE_COUNT_SHARE})")
        assert share >= M71_REFERENCE_COUNT_SHARE - 1e-9
        m71_share = share
        # the chunk estimate on one image, whose one tile is its chunk (a
        # batch of images also keeps the earlier images' results)
        cfg.num_images = cfg.batch_size = 1
        cfg.output_dir = f"{tmp}/one"
        *_, peak = _aggregation_batch(dev, cfg, "m71 one image")
        _check_chunk_budget("m71", "m71 fixture, one image",
                            build_prior(cfg.prior, "cpu"),
                            cfg.sampler.num_catalogs,
                            cfg.image_model.image_height
                            * cfg.image_model.image_width, 1, peak)
    return dnc, m71, m71_share


def phase_mala_dnc(dev, workers=None):
    """``run_experiment`` on one batch of 4 divideandconquer images with
    ``kernel.kind: mala``: K4 on the tile stage and on both bridge levels,
    every mutate call a K4 launch, held to the JAX runner's shares under
    the same MALA steps. Returns the launches."""
    with tempfile.TemporaryDirectory() as tmp:
        cfg = _suite_config("divideandconquer", tmp, MALA_DNC_STEPS)
        cfg.output_dir = tmp
        launches = _dnc_batch(dev, cfg, "mala dnc",
                              DNC_MALA_REFERENCE_CONVERGED_SHARE,
                              DNC_MALA_REFERENCE_COUNT_SHARE,
                              DNC_JAX_WITHIN["MALA"], workers)
    assert launches["K4 tile"] > 0 and launches["K4 bridge"] > 0, launches
    assert all(launches[k] == 0 for k in ("K1", "K2", "K3")), launches
    return launches


def phase_profile(dev, cfg=None, label="profile",
                  what="one divideandconquer image"):
    """``torch.profiler`` over one warm divideandconquer image (or the
    first image of aggregation config ``cfg``) through ``run_experiment``:
    device time by range (``agg.*`` and ``smc.*``, the kernels launched
    inside each) and the device's idle share, 1 - the sum of kernel time
    over the wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from smcdet_tpu_torch.config import load_config
    from smcdet_tpu_torch.runner import run_experiment

    if cfg is None:
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
    ranges, sweeps, kernel_ms = {}, {}, 0.0
    for e in prof.events():
        in_range = e.name.startswith(("agg.", "smc."))
        if e.device_type == DeviceType.CPU and in_range:
            n, ms = ranges.get(e.name, (0, 0.0))
            ranges[e.name] = (n + 1, ms + e.device_time_total / 1e3)
        elif e.device_type == DeviceType.CUDA and not in_range:
            kernel_ms += e.device_time_total / 1e3
            kid = kernel_id(e.name)
            if kid is not None:
                n, ms = sweeps.get(kid, (0, 0.0))
                sweeps[kid] = (n + 1, ms + e.device_time_total / 1e3)
    print(f"[{label}] {what} under the profiler: wall "
          f"{wall * 1e3:.1f} ms, kernels {kernel_ms:.1f} ms, device idle "
          f"{1 - kernel_ms / (wall * 1e3):.3f}")
    for kid, (n, ms) in sorted(sweeps.items()):
        print(f"[{label}] {kid} (the sweeps of "
              f"{'agg' if kid in ('K3', 'K3g') else 'smc'}.mutate): {n} "
              f"launches, device {ms:.3f} ms")
    for key in sorted(ranges, key=lambda k: -ranges[k][1]):
        n, ms = ranges[key]
        print(f"[{label}] {key}: {n} calls, PyTorch kernels {ms:.3f} ms")
    rest = kernel_ms - sum(ms for _, ms in ranges.values()) - sum(
        ms for _, ms in sweeps.values())
    print(f"[{label}] outside the ranges: device {rest:.3f} ms")


def phase_profile_pair(dev, work):
    """``torch.profiler`` over one SMC iteration (``csmc_step``, after the
    first temper step) of the ``[pair]`` batch at the config's width: the
    kernels' device time in each ``smc.*`` range, K2's share of it, and the
    time per sweep of the plain relocation and of the plain pair move."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from smcdet_tpu_torch.config import (
        build_image_model,
        build_kernel,
        build_prior,
    )
    from smcdet_tpu_torch.inference.smc import (
        SMCConfig,
        csmc_init,
        csmc_step,
    )

    cfg = _pair_config(work)
    s = cfg.sampler
    prior = build_prior(cfg.prior, dev)
    model = build_image_model(cfg.image_model, dev)
    kernel = build_kernel(cfg.kernel, dev)
    smc_cfg = SMCConfig(num_catalogs=s.num_catalogs,
                        ess_threshold_prop=s.ess_threshold_prop,
                        resample_method=s.resample_method,
                        flux_detection_threshold=s.flux_detection_threshold,
                        relocate_sweeps=s.relocate_sweeps,
                        pair_sweeps=s.pair_sweeps)
    images = torch.as_tensor(np.load(cfg.data_path)["images"][:10],
                             device=dev)
    state = csmc_init(torch.Generator(device=dev).manual_seed(0), images,
                      prior, model, smc_cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        csmc_step(images, prior, model, kernel, smc_cfg, state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    # Each kernel is charged to the range whose device-side span holds its
    # start: on this iteration the host-side ranges' device totals add up
    # to more than the kernels' time, and K2, launched through its own CUDA
    # runtime, has no host range at all.
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in events
             if e.name.startswith("smc.")]
    ranges, k2_ms, kernel_ms = {}, 0.0, 0.0
    for e in events:
        if e.name.startswith("smc."):
            continue
        ms = (e.time_range.end - e.time_range.start) / 1e3
        kernel_ms += ms
        if kernel_id(e.name) == "K2":
            k2_ms += ms
        key = next((name for lo, hi, name in spans
                    if lo <= e.time_range.start < hi), "outside")
        ranges[key] = ranges.get(key, 0.0) + ms
    T, C, N = images.shape[0], prior.num_counts, s.num_catalogs
    print(f"[profile] one cells_pair SMC iteration ({T} tiles x {C} x "
          f"N={N}, {cfg.kernel.num_iters} sweeps + {s.relocate_sweeps} "
          f"relocations + {s.pair_sweeps} pair sweeps) under the profiler: "
          f"wall {wall * 1e3:.1f} ms, kernels {kernel_ms:.1f} ms, device "
          f"idle {1 - kernel_ms / (wall * 1e3):.3f}")
    print(f"[profile] cells_pair K2 (in smc.mutate): {k2_ms:.3f} ms, "
          f"{k2_ms / kernel_ms:.3f} of the kernels' time")
    for key in ("smc.resample", "smc.rerender", "smc.mutate", "smc.relocate",
                "smc.pair", "smc.temper", "outside"):
        ms = ranges.get(key, 0.0)
        print(f"[profile] cells_pair {key}: device {ms:.3f} ms "
              f"({ms / kernel_ms:.3f})")
    reloc = ranges.get("smc.relocate", 0.0) / s.relocate_sweeps
    pair = ranges.get("smc.pair", 0.0) / s.pair_sweeps
    print(f"[profile] cells_pair per sweep: plain relocation {reloc:.3f} ms, "
          f"plain pair move {pair:.3f} ms, K2 "
          f"{k2_ms / cfg.kernel.num_iters:.3f} ms")
    assert ranges.get("smc.pair", 0.0) > 0, ranges
    assert 0 < k2_ms <= ranges.get("smc.mutate", 0.0) + 1e-6, (ranges, k2_ms)


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


# ----------------------------------------------------------------------
# The baselines: the MH chain (one chain per tile, N = 1 launches), the
# reversible-jump chain and transdimensional SMC, the source extractor
# ----------------------------------------------------------------------
# (label, suite, kernel kind, the sweep kernel its chain launches); the
# m71 fixture first: its chain is never cut
MCMC_CHAINS = (("m71 fixture", "m71", "mh", "K2"),
               ("m71synthetic", "m71synthetic", "mh", "K1"),
               ("basic", "basic", "mh", "K2"),
               ("cells", "cells", "mh", "K2"),
               ("basic under MALA", "basic", "mala", "K4"))
# the [mcmc] batches' budget: past it, the chains after the m71 fixture's
# keep fewer samples (the burn-in stays whole)
MCMC_BUDGET_S = 10.0
# the plain chain's drift check: tiles and sweeps
MCMC_PLAIN_DRIFT = (2, 1000)
# the equilibrium check's chains (copies of one tile) and sweeps: the
# chains start burnt in, and the plain version's sweeps (host-bound, about
# 15 ms each) were most of the phase at 800
MCMC_EQ_CHAINS = 512
MCMC_EQ_SWEEPS = 400
# keys of the chain launches' agreement check, at the batch's launch and
# at the equilibrium check's
MCMC_AGREEMENT_KEYS = 4


def _mcmc_setup(dev, suite, kind):
    """A suite's config at one batch (``kernel.kind`` set to ``kind``), its
    prior, image model, chain kernel and ``MCMCConfig``, and the batch's
    tiles and backgrounds on ``dev`` (as ``run_experiment`` reads them)."""
    from smcdet_tpu_torch.config import (
        build_image_model,
        build_kernel,
        build_prior,
    )
    from smcdet_tpu_torch.run_experiment import load_suite_config
    from smcdet_tpu_torch.runner import _load_tiles, mcmc_chain

    cfg = load_suite_config(f"experiments/{suite}")
    cfg.kernel.kind = kind
    cfg.num_images = cfg.batch_size
    prior = build_prior(cfg.prior, dev)
    model = build_image_model(cfg.image_model, dev)
    chain, mc = mcmc_chain(cfg, build_kernel(cfg.kernel, dev), dev)
    tiles = _load_tiles(cfg)
    T = cfg.batch_size
    imgs = torch.as_tensor(tiles["images"][:T], dtype=torch.float32,
                           device=dev)
    if cfg.use_tile_backgrounds:
        model = model.with_background(torch.as_tensor(
            tiles["background"][:T], dtype=torch.float32,
            device=dev)[:, None])
    return cfg, prior, model, chain, mc, imgs, tiles


def _chain_args(key, kernel, ctx, counts, state, num_iters):
    """The flattened arguments of a sweep kernel's wrapper for chains
    ``counts [T, 1]`` (what ``run_from_state`` passes: G = T, N = 1)."""
    T = counts.shape[0]
    HW = ctx.model.height * ctx.model.width
    return [key, kernel.proposal(ctx.prior), ctx.prior, ctx.model,
            ctx.image.reshape(T, HW).contiguous(),
            ctx.temperature.reshape(T).contiguous(),
            counts.to(torch.int32).contiguous(), state.locs.contiguous(),
            state.fluxes.contiguous(), state.rate.contiguous(),
            state.parent_ll.contiguous(), state.logprior.contiguous(),
            num_iters]


def _cache_drift(ctx, counts, state):
    """The cached rate against a fresh render, ``max |rate - fresh| /
    fresh``, and the cached log-likelihood against the recomputed one (max
    relative and absolute)."""
    from smcdet_tpu_torch.inference.kernels import init_kernel_state

    fresh = init_kernel_state(ctx, counts, state.locs, state.fluxes)
    rate = float(((state.rate - fresh.rate).abs() / fresh.rate).max())
    d = (state.parent_ll - fresh.parent_ll).abs()
    ll_rel = float((d / fresh.parent_ll.abs().clamp(min=1.0)).max())
    return rate, ll_rel, float(d.max())


def chain_vs_plain(dev, label, kid, suite, kind, peaks):
    """The chain kernel ``kid`` at its ``[mcmc]`` launch shapes (G = a
    batch's tiles, N = 1: one live particle in each block), from the empty
    start moved 200 sweeps: zero-count passthrough bit-exact, >= 99% of
    chains agree with the plain version after 20 same-stream sweeps,
    ``MCMC_EQ_SWEEPS``-sweep equilibrium and cache drift
    (``_equilibrium``), two launches
    on one key bit-identical, ``launch_agreement`` pooled over
    ``MCMC_AGREEMENT_KEYS`` keys at the batch's launch and at the
    equilibrium chains'; then the burn-in launch
    and a block launch timed beside their bounds, and the burn-in's cache
    drift. The equilibrium runs on ``MCMC_EQ_CHAINS`` copies of one tile
    (the quantiles are over chains of one target). Returns the two launch
    records."""
    from smcdet_tpu_torch.inference.mcmc import init_chain, with_iters
    from smcdet_tpu_torch.ops import mala_sweep, mh_sweep

    cfg, prior, model, chain, mc, imgs, _ = _mcmc_setup(dev, suite, kind)
    M, mala = prior.max_objects, kind == "mala"
    if mala:
        assert mala_sweep.mala_kernel(prior, model, M) == "K4"
        run, plain = mala_sweep.mala_sweeps, mala_sweep.mala_sweeps_reference
    else:
        assert mh_sweep.sweep_kernel(prior, model, M) == kid
        run, plain = mh_sweep.mh_sweeps, mh_sweep.mh_sweeps_reference
    gen = torch.Generator(device=dev).manual_seed(11)
    ctx, counts, state = init_chain(gen, imgs, prior, model, chain)
    state, _ = with_iters(chain, 200).run_from_state(gen, ctx, counts, state)
    T = counts.shape[0]
    shape = f"{T} tiles x 1 chain, {model.height}x{model.width}, M={M}"
    _passthrough(dev, chain, ctx, counts, state)
    share, abs_err, _ = _same_stream(dev, chain, ctx, counts, state)
    print(f"[mcmc {label}] {kid} at {shape}: zero-count passthrough "
          f"bit-exact; 20 same-stream sweeps: {share:.6f} of chains agree "
          f"(pll/lp max abs err {abs_err:.3e})")
    assert share >= 0.99, share
    # in law: MCMC_EQ_CHAINS chains of the batch's first tile (N = 1 each:
    # one chain a block), burnt in by the kernel for the config's burn-in
    reps = MCMC_EQ_CHAINS
    ctx_eq, counts_eq, state_eq = init_chain(
        gen, imgs[:1].expand(reps, -1, -1), prior, _first_tiles(model, reps),
        chain)
    state_eq, _ = with_iters(chain, mc.num_samples_burnin).run_from_state(
        gen, ctx_eq, counts_eq, state_eq)
    _equilibrium(dev, f"mcmc {label}", chain, ctx_eq, counts_eq, state_eq,
                 MCMC_EQ_SWEEPS)

    key = torch.tensor([4242, 2424], dtype=torch.int64, device=dev)
    k, nb = mc.keep_every_k, mc.num_samples_burnin
    block = _chain_args(key, chain, ctx, counts, state, k)
    first, again = run(*block), run(*block)
    assert all(torch.equal(a, b) for a, b in zip(first, again)), (
        "two launches on one key differ")
    # one rounding flip is 2-10% of a batch's chains: the share is pooled
    # over MCMC_AGREEMENT_KEYS keys at the batch's launch and as many on the
    # equilibrium check's chains (one launch shape but for G), each
    # launch's passthrough held
    eq_block = _chain_args(key, chain, ctx_eq, counts_eq, state_eq, k)
    shares = [(len(args[6]), launch_agreement(
        run, plain, [torch.tensor([4242 + i, 2424], dtype=torch.int64,
                                  device=dev)] + args[1:], bar=0.0)[0])
        for args in (block, eq_block) for i in range(MCMC_AGREEMENT_KEYS)]
    del ctx_eq, counts_eq, state_eq, eq_block
    n_runs = sum(n for n, _ in shares)
    agree = sum(n * a for n, a in shares) / n_runs
    print(f"[mcmc {label}] two launches on one key bit-identical; "
          f"launch_agreement over {len(shares)} launches ({n_runs} chain "
          f"runs): {agree:.6f} (at the batch's launch "
          f"{np.mean([a for n, a in shares[:MCMC_AGREEMENT_KEYS]]):.6f}, "
          f"lowest {min(a for _, a in shares):.6f})")
    assert agree >= 0.99, shares

    records = _chain_launch_records(kid, label, run, plain, chain, ctx,
                                    counts, state, nb, k, mala, peaks)

    # the rate cache's f32 drift over a whole burn-in launch
    ctx, counts, state = init_chain(gen, imgs, prior, model, chain)
    burnt, _ = with_iters(chain, nb).run_from_state(gen, ctx, counts, state)
    rate, ll_rel, ll_abs = _cache_drift(ctx, counts, burnt)
    print(f"[mcmc {label}] after a {nb}-sweep burn-in launch on the card: "
          f"rate cache vs fresh render max rel {rate:.3e}; cached vs "
          f"recomputed log-likelihood max rel {ll_rel:.3e} (abs "
          f"{ll_abs:.3e})")
    assert rate < 1e-2 and ll_rel < 1e-2, (rate, ll_rel)
    if label == "m71 fixture":
        n, sweeps = MCMC_PLAIN_DRIFT
        sub = init_chain(gen, imgs[:n], prior, _first_tiles(model, n),
                         chain)
        plain_chain = with_iters(chain, sweeps)
        plain_chain.backend = "torch"
        burnt, _ = plain_chain.run_from_state(gen, *sub)
        rate, ll_rel, ll_abs = _cache_drift(sub[0], sub[1], burnt)
        print(f"[mcmc {label}] the plain version, {n} tiles x {sweeps} "
              f"sweeps: rate drift max rel {rate:.3e}; log-likelihood max "
              f"rel {ll_rel:.3e} (abs {ll_abs:.3e})")
    return records


def _chain_launch_records(kid, label, run, plain, chain, ctx, counts, state,
                          nb, k, mala, peaks):
    """The chain kernel's burn-in launch (``nb`` sweeps) and block launch
    (``k`` sweeps) at the chains ``counts [T, 1]``, each timed beside its
    bound and its plain version. Returns ``{"burn-in": rec, "block":
    rec}``."""
    prior, model = ctx.prior, ctx.model
    M, T = prior.max_objects, counts.shape[0]
    key = torch.tensor([4242, 2424], dtype=torch.int64, device=counts.device)
    records = {}
    for name, sweeps, reps in (("burn-in", nb, 1), ("block", k, 200)):
        args = _chain_args(key, chain, ctx, counts, state, sweeps)
        wall_ms = _time_ms(lambda: run(*args), reps=reps)
        plain_args = _chain_args(key, chain, ctx, counts, state,
                                 min(sweeps, 20))
        plain_ms = _time_ms(lambda: plain(*plain_args), reps=1) * (
            sweeps / min(sweeps, 20))
        geo = launch_geometry(lambda: run(*args))
        # a block launch is shorter than the host's work between two: its
        # time is the profiler's, the events' is the host's a launch. A
        # trace that missed the kernel leaves the record unranked: the
        # host's wall is never a kernel's time
        ms = geo.get("device_ms")
        bound = [sweep_bound(prior, model, args[6], args[9], M, sweeps,
                             mala=mala, peaks=p)
                 for p in ((PEAK_FP32, PEAK_SFU), peaks)]
        rec = {"ms": ms, "wall_ms": wall_ms, "plain_ms": plain_ms,
               "bound_ms": bound[0][0],
               "bound_by": bound[0][1], "measured_bound_ms": bound[1][0],
               "shape": f"{T} groups x 1, {model.height}x{model.width}, "
                        f"M={M}, {sweeps} sweeps", "geometry": geo}
        kernel_text = ("unranked: the trace missed the kernel" if ms is None
                       else f"{ms:.4f} ms in the trace")
        print(f"[shapes] {kid} {label} MCMC {name} ({rec['shape']}): kernel "
              f"{kernel_text}, {wall_ms:.4f} ms a launch back to "
              f"back ({_geometry_text(geo)}), plain {plain_ms:.3f} "
              f"ms (timed at {min(sweeps, 20)} sweeps), bound "
              f"{bound[0][0]:.3e} ms ({bound[0][1]}; at K5's measured rates "
              f"{bound[1][0]:.3e} ms)")
        records[name] = rec
    return records


def _first_tiles(model, n):
    """The model with its per-tile background (if any) cut to the first
    ``n`` tiles, or the first tile's repeated ``n`` times when ``n`` is
    more than the batch's."""
    bg = model.background
    if bg.ndim < 3:
        return model
    if n > bg.shape[0]:
        return model.with_background(bg[:1].expand((n,) + bg.shape[1:]))
    return model.with_background(bg[:n])


def _mcmc_batch(dev, label, suite, kind, kid, keep=None):
    """One batch of ``suite`` under ``--method mcmc`` through
    ``run_experiment``, ``keep`` kept samples (default: the config's):
    every launch a ``kid`` launch, one burn-in and one a kept sample.
    Returns (launches, wall, results)."""
    from smcdet_tpu_torch.inference.mcmc import num_kept
    from smcdet_tpu_torch.runner import load_results, run_experiment

    cfg, _, _, _, mc, _, tiles = _mcmc_setup(dev, suite, kind)
    if keep is not None:
        cfg.mcmc.num_samples_total = (mc.num_samples_burnin
                                      + keep * mc.keep_every_k)
        mc.num_samples_total = cfg.mcmc.num_samples_total
    K = num_kept(mc)
    with tempfile.TemporaryDirectory() as tmp:
        cfg.output_dir = tmp
        _reset_launches()
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = run_experiment(cfg, method="mcmc", device=dev, verbose=False)
        wall = time.perf_counter() - start
        launches = _launches()
        res = load_results(out, "mcmc")
    name = "K4 tile" if kid == "K4" else kid
    assert launches[name] == 1 + K, (launches, K)
    assert sum(launches.values()) == launches[name], launches
    T, M = cfg.batch_size, cfg.prior.max_objects
    assert res["locs"].shape == (T, K, M, 2), res["locs"].shape
    assert np.isfinite(res["fluxes"]).all() and np.isfinite(
        res["locs"]).all()
    acc = res["acc_rate"]
    assert (acc > 0).all() and (acc < 1).all(), acc
    mean = res["pruned_counts"].mean(-1)
    truth = tiles["true_counts"][:T]
    within = np.abs(mean - truth) <= 1.0
    runtime = float(res["runtime"][0])
    print(f"[mcmc] {label}: {T} chains x {mc.num_samples_total} sweeps "
          f"({mc.num_samples_burnin} burn-in, {K} kept, every "
          f"{mc.keep_every_k}), M={M}: batch {runtime:.3f} s "
          f"(run_experiment {wall:.3f} s); acceptance "
          f"{acc.min():.4f}-{acc.max():.4f} (mean {acc.mean():.4f}); "
          f"launches {launches}; posterior mean pruned count within +-1 of "
          f"truth on {int(within.sum())}/{T}")
    return launches[name], runtime, res


def phase_mcmc(dev, peaks):
    """``[mcmc]``: the chain kernels held to their plain versions at N = 1
    (``chain_vs_plain``), then one batch of each of ``MCMC_CHAINS`` under
    ``--method mcmc`` at the configs' chain lengths, the chains after the
    m71 fixture's cut (and each cut printed) when the batches would take
    over ``MCMC_BUDGET_S``. Returns ``{kid: launches}``, the launch
    records by (kid, path) and the batches' results by label."""
    records, launches, results = {}, {}, {}
    for label, suite, kind, kid in MCMC_CHAINS:
        records[label] = chain_vs_plain(dev, label, kid, suite, kind, peaks)
    keep, spent = None, 0.0
    for i, (label, suite, kind, kid) in enumerate(MCMC_CHAINS):
        n, wall, results[label] = _mcmc_batch(dev, label, suite, kind, kid,
                                              keep)
        launches[kid] = launches.get(kid, 0) + n
        records[label]["launches"] = n
        spent += wall
        if i == 0 and wall * len(MCMC_CHAINS) > MCMC_BUDGET_S:
            share = (MCMC_BUDGET_S - wall) / (wall * (len(MCMC_CHAINS) - 1))
            keep = min(n - 1, max(100, int((n - 1) * share)))
            print(f"[mcmc] cut: the chains after the m71 fixture's keep "
                  f"{keep} samples of {n - 1} (its batch took {wall:.1f} s; "
                  f"budget {MCMC_BUDGET_S:.0f} s)")
    print(f"[mcmc] batches {spent:.1f} s")
    return launches, records, results


def phase_mcmc_profile(dev, blocks=1000):
    """``torch.profiler`` over one m71 fixture MCMC batch cut to its whole
    burn-in and ``blocks`` kept samples: wall, the kernels' device time,
    the device's idle share, the sweep kernel's device time per launch and
    the host's time per block."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from smcdet_tpu_torch.inference.mcmc import run_mh

    cfg, prior, model, chain, mc, imgs, _ = _mcmc_setup(dev, "m71", "mh")
    mc.num_samples_total = mc.num_samples_burnin + blocks * mc.keep_every_k
    gen = torch.Generator(device=dev).manual_seed(3)
    run_mh(gen, imgs, prior, model, chain, mc)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        run_mh(gen, imgs, prior, model, chain, mc)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    kernel_ms, sweep = 0.0, []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kernel_ms += e.device_time_total / 1e3
            if kernel_id(e.name) is not None:
                sweep.append(e.device_time_total / 1e3)
    assert len(sweep) == blocks + 1, (len(sweep), blocks)
    burn = max(sweep)
    block_ms = (sum(sweep) - burn) / max(len(sweep) - 1, 1)
    host_block = (wall * 1e3 - burn) / blocks
    print(f"[profile] m71 fixture MCMC batch, {imgs.shape[0]} chains, "
          f"{mc.num_samples_burnin}-sweep burn-in + {blocks} blocks of "
          f"{mc.keep_every_k}: wall {wall * 1e3:.1f} ms, kernels "
          f"{kernel_ms:.1f} ms, device idle {1 - kernel_ms / (wall * 1e3):.3f};"
          f" {len(sweep)} sweep launches: burn-in {burn:.3f} ms, a block "
          f"{block_ms:.4f} ms on the device and {host_block:.4f} ms of wall")


def phase_rjmh(dev):
    """``[rjmh]``: ``run_rjmh`` on basic's 20 tiles (all five proposal
    kinds; the move at the SMC kernel's scales), finite; then the kernel's
    caches after 200 sweeps from the empty start against a fresh
    render."""
    from smcdet_tpu_torch.inference.kernels import (
        SingleComponentMH,
        TargetContext,
        init_kernel_state,
    )
    from smcdet_tpu_torch.inference.mcmc import MCMCConfig, run_rjmh
    from smcdet_tpu_torch.inference.transdimensional import (
        BirthDeathMH,
        TDKernelState,
    )

    cfg, prior, model, _, mc, imgs, tiles = _mcmc_setup(dev, "basic", "mh")
    move = SingleComponentMH(1, cfg.kernel.locs_stdev,
                             cfg.kernel.fluxes_stdev, cfg.kernel.fluxes_min,
                             cfg.kernel.fluxes_max, device=dev)
    kernel = BirthDeathMH(1, move, prob_birth=0.15, prob_death=0.15,
                          prob_split=0.1, prob_merge=0.1)
    run_cfg = MCMCConfig(400, 200, 2, mc.flux_detection_threshold)
    gen = torch.Generator(device=dev).manual_seed(4)
    torch.cuda.synchronize()
    start = time.perf_counter()
    res = run_rjmh(gen, imgs, prior, model, kernel, run_cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    T = imgs.shape[0]
    assert torch.isfinite(res.fluxes).all() and torch.isfinite(
        res.locs).all()
    assert res.counts.shape == (T, 100)
    mean = res.pruned_counts.float().mean(-1).cpu().numpy()
    within = np.abs(mean - tiles["true_counts"][:T]) <= 1.0
    acc = res.acc_rate.cpu().numpy()
    print(f"[rjmh] basic: {T} chains x 400 sweeps (birth/death/split/merge "
          f"0.15/0.15/0.1/0.1): {wall:.3f} s; acceptance "
          f"{acc.min():.4f}-{acc.max():.4f}; posterior mean pruned count "
          f"within +-1 of truth on {int(within.sum())}/{T}")
    M = prior.max_objects
    counts = torch.zeros((T, 1), dtype=torch.int32, device=dev)
    zeros = torch.zeros((T, 1, M), device=dev)
    ctx = TargetContext(prior, model, imgs[:, None],
                        torch.ones((T, 1), device=dev))
    st = TDKernelState(counts, init_kernel_state(
        ctx, counts, torch.zeros((T, 1, M, 2), device=dev), zeros))
    for _ in range(200):
        st, _ = kernel.sweep(gen, ctx, st)
    rate, ll_rel, ll_abs = _cache_drift(ctx, st.counts, st.inner)
    print(f"[rjmh] after 200 sweeps: cached rate vs fresh render max rel "
          f"{rate:.3e}; log-likelihood max rel {ll_rel:.3e} (abs "
          f"{ll_abs:.3e}); counts {st.counts[:, 0].tolist()}")
    assert rate < 1e-4 and ll_rel < 1e-4, (rate, ll_rel)


def phase_tdsmc(dev):
    """``[tdsmc]``: ``run_tdsmc`` on basic's 20 tiles, N = 512, 10 sweeps
    of all five kinds an iteration: every tile at temperature 1, finite
    log Z."""
    from smcdet_tpu_torch.inference.kernels import SingleComponentMH
    from smcdet_tpu_torch.inference.transdimensional import (
        BirthDeathMH,
        TDSMCConfig,
        run_tdsmc,
    )

    cfg, prior, model, _, _, imgs, tiles = _mcmc_setup(dev, "basic", "mh")
    move = SingleComponentMH(1, cfg.kernel.locs_stdev,
                             cfg.kernel.fluxes_stdev, cfg.kernel.fluxes_min,
                             cfg.kernel.fluxes_max, device=dev)
    kernel = BirthDeathMH(10, move, prob_birth=0.15, prob_death=0.15,
                          prob_split=0.1, prob_merge=0.1)
    td_cfg = TDSMCConfig(num_particles=512, max_smc_iters=100,
                         flux_detection_threshold=(
                             cfg.sampler.flux_detection_threshold))
    torch.cuda.synchronize()
    start = time.perf_counter()
    res = run_tdsmc(torch.Generator(device=dev).manual_seed(5), imgs, prior,
                    model, kernel, td_cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    T = imgs.shape[0]
    assert torch.all(res.temperature == 1.0), res.temperature
    assert torch.isfinite(res.log_normalizing_constant).all()
    mean = res.pruned_counts.float().mean(-1).cpu().numpy()
    within = np.abs(mean - tiles["true_counts"][:T]) <= 1.0
    print(f"[tdsmc] basic: {T} tiles x N=512, 10 sweeps an iteration: "
          f"{res.num_iters} iterations in {wall:.3f} s; min ESS/N "
          f"{float(res.ess.min()) / 512:.4f}; posterior mean pruned count "
          f"within +-1 of truth on {int(within.sum())}/{T}")


# [sep]'s cut of the default grid (72 points, ~55 s of matching on the
# card; tests/torch_baseline_suites.py runs it whole): it holds the
# default grid's best point on the m71 fixture
SEP_GRID = dict(thresh_grid=(1.0, 4.0), minarea_grid=(1, 3),
                deblend_cont_grid=(1e-6,), clean_param_grid=(0.0, 1.0))
# the extractor on the card against the CPU: locations to 1e-3 px and
# fluxes to 1e-4 relative (float32 sums in another order)
SEP_LOC_ATOL = 1e-3
SEP_FLUX_RTOL = 1e-4


def phase_sep(dev):
    """``[sep]``: the tuned extractor baseline on the m71 fixture on the
    card (``run_sep_baseline``: ``SEP_GRID`` by F1 on the 50 tuning tiles,
    the tuned extractor on the 344 evaluation tiles), and the extractor with
    the tuned parameters on all 688 tiles on the card and on the CPU:
    counts equal on >= 99% of tiles, and where equal the locations and
    fluxes within ``SEP_LOC_ATOL`` / ``SEP_FLUX_RTOL``."""
    from smcdet_tpu_torch.detect.baseline import run_sep_baseline
    from smcdet_tpu_torch.detect.extractor import extract_batch
    from smcdet_tpu_torch.run_experiment import load_suite_config
    from smcdet_tpu_torch.runner import _load_tiles

    cfg = load_suite_config("experiments/m71")
    tiles = _load_tiles(cfg)
    torch.cuda.synchronize()
    start = time.perf_counter()
    score, best, res = run_sep_baseline(cfg, tiles, device=dev, **SEP_GRID)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    print(f"[sep] m71 fixture: tuned on 50 tiles in {wall:.3f} s: F1 "
          f"{score:.4f} with {best}; {int(res['counts'].sum())} detections "
          f"on {res['counts'].shape[0]} evaluation tiles")
    sub = (np.asarray(tiles["images"], np.float32)
           - np.asarray(tiles["background"], np.float32))
    err = float(np.sqrt(np.asarray(tiles["background"])[
        np.asarray(tiles["checkerboard"], bool)][:50].mean()))
    kw = dict(thresh=best["thresh"], err=err, minarea=best["minarea"],
              deblend_cont=best["deblend_cont"],
              clean_param=best["clean_param"])
    card = [a.cpu() for a in extract_batch(torch.from_numpy(sub).to(dev),
                                           **kw)]
    cpu = extract_batch(torch.from_numpy(sub), **kw)
    same = card[0] == cpu[0]
    share = float(same.float().mean())
    loc_err = float((card[1][same] - cpu[1][same]).abs().max())
    flux_err = float(((card[2][same] - cpu[2][same]).abs()
                      / cpu[2][same].abs().clamp(min=1e-6)).max())
    print(f"[sep] extractor on all {sub.shape[0]} tiles, card vs CPU: "
          f"counts equal on {share:.6f}; there locations max abs err "
          f"{loc_err:.3e} px, fluxes max rel err {flux_err:.3e}")
    assert share >= 0.99, share
    assert loc_err <= SEP_LOC_ATOL and flux_err <= SEP_FLUX_RTOL, (
        loc_err, flux_err)
    assert int(card[0].sum()) > 0


class _EarlyStopRuns:
    """While the ``with`` block runs, every mutation (``run_from_state`` of
    ``SingleComponentMH`` and ``SingleComponentMALA``, tile and bridge)
    whose kernel has ``sqjumpdist_tol`` set is recorded: the sweeps it ran
    (``kernels.early_stop_sweeps``), its particles and its wall. With
    ``compare``, the plain version then runs from the same state on a copy
    of the generator, so on the same Philox keys, and its sweeps and the
    share of particles that agree with the kernel's (``_agreement``) are
    recorded too, on every ``compare``-th mutation from the first (0: on
    none); that comparison's time is kept apart (``compare_s``) and
    launches nothing. ``mutations``: ``[sweeps, plain sweeps, agreeing
    share, particles, wall s]``, the plain ones None where not compared."""

    def __init__(self, compare=0):
        self.compare = compare
        self.mutations, self.compare_s = [], 0.0

    def __enter__(self):
        from smcdet_tpu_torch.inference import kernels

        self._kernels = kernels
        classes = (kernels.SingleComponentMH, kernels.SingleComponentMALA)
        self._saved = (kernels.early_stop_sweeps,
                       {c: c.run_from_state for c in classes})
        stop, sweeps = kernels.early_stop_sweeps, []

        def recorded(*args, **kwargs):
            out = stop(*args, **kwargs)
            sweeps.append(out[2])
            return out

        def wrap(run):
            def run_from_state(kernel, gen, ctx, counts, state):
                if kernel.sqjumpdist_tol is None:
                    return run(kernel, gen, ctx, counts, state)
                saved = gen.get_state()
                sweeps.clear()
                torch.cuda.synchronize()
                start = time.perf_counter()
                out = run(kernel, gen, ctx, counts, state)
                torch.cuda.synchronize()
                rec = [sweeps[0], None, None, counts.numel(),
                       time.perf_counter() - start]
                if self.compare and len(self.mutations) % self.compare == 0:
                    mark = time.perf_counter()
                    copy = torch.Generator(device=gen.device)
                    copy.set_state(saved)
                    backend, kernel.backend = kernel.backend, "torch"
                    try:
                        ref = run(kernel, copy, ctx, counts, state)
                    finally:
                        kernel.backend = backend
                    rec[1] = sweeps[1]
                    rec[2] = float(_agreement(
                        _present(out[0]), _present(ref[0]),
                        counts.shape).float().mean())
                    self.compare_s += time.perf_counter() - mark
                self.mutations.append(rec)
                return out
            return run_from_state

        kernels.early_stop_sweeps = recorded
        for cls, run in self._saved[1].items():
            cls.run_from_state = wrap(run)
        return self

    def __exit__(self, *exc):
        self._kernels.early_stop_sweeps = self._saved[0]
        for cls, run in self._saved[1].items():
            cls.run_from_state = run


def _one_sweep_record(dev, path, name, prior, model, kernel, tiles, N,
                      peaks):
    """A one-sweep launch of ``name`` (K1, K2 or K4) at a path's tile
    shape: its time, its plain version's and its bound (what the early
    stop launches once a sweep)."""
    from smcdet_tpu_torch.ops import mala_sweep, mh_sweep

    mala = name == "K4"
    run, plain = ((mala_sweep.mala_sweeps, mala_sweep.mala_sweeps_reference)
                  if mala else (mh_sweep.mh_sweeps,
                                mh_sweep.mh_sweeps_reference))
    args = _sweep_args(torch.tensor([12345, 67890], dtype=torch.int64,
                                    device=dev), kernel,
                       *_kernel_inputs(dev, prior, model, tiles, N, 0), 1)
    ms = _time_ms(lambda: run(*args), reps=50)
    plain_ms = _time_ms(lambda: plain(*args), reps=3)
    M = prior.max_objects
    bound = [sweep_bound(prior, model, args[6], args[9], M, 1, mala=mala,
                         peaks=p) for p in ((PEAK_FP32, PEAK_SFU), peaks)]
    G = args[6].shape[0]
    shape = f"{G} groups x {N}, {model.height}x{model.width}, M={M}, 1 sweep"
    print(f"[sqjd] {name} {path} ({shape}): one-sweep launch {ms:.4f} ms, "
          f"plain {plain_ms:.3f} ms, bound {bound[0][0]:.4g} ms "
          f"({bound[0][1]}; at K5's measured rates {bound[1][0]:.4g} ms)")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0][0],
            "bound_by": bound[0][1], "measured_bound_ms": bound[1][0],
            "shape": shape}


def phase_sqjd(dev, peaks):
    """The ``sqjumpdist_tol`` early stop on the card, at the jsm2024 value
    ``SQJD_TOL``, on four paths: the quick cell (K1), one basic batch (K2),
    the basic batch under MALA (K4) and one divideandconquer image (K1
    tiles, K3 bridges). Each path runs twice, its launch counts set to 0
    just before each run: at tolerance 0 every mutation must run exactly
    ``num_iters`` sweeps, one launch each; at ``SQJD_TOL`` every sweep of a
    mutation is one launch of the path's kernel, counted, and the plain
    version, run from the same state on the same Philox keys on every
    ``SQJD_COMPARE_EVERY``-th mutation, must stop at the same sweep in at
    least 99% of those with at least 99% of particles in agreement
    (``launch_agreement``'s bar). Prints the sweeps
    per mutation, the launches, the host's wall per sweep beside the
    kernel's one-sweep launch time, and the batch wall without the
    comparison. Returns ``(launches by kernel, {path: record})``: the
    launches of both runs, and the one-sweep launch records of K1, K2 and
    K4 at their paths' tile shapes."""
    from smcdet_tpu_torch.inference.smc import run_csmc_chunked
    from smcdet_tpu_torch.runner import load_results, run_experiment

    totals = dict.fromkeys(("K1", "K2", "K3", "K4 tile", "K4 bridge"), 0)
    records = {}
    with tempfile.TemporaryDirectory() as tmp:
        def quick(tol):
            sim, prior, model, kernel, cfg = build_problem(
                dev, num_tiles=SQJD_QUICK_TILES)
            kernel.sqjumpdist_tol = tol
            res = run_csmc_chunked(torch.Generator(device=dev).manual_seed(1),
                                   sim.images.to(dev), prior, model, kernel,
                                   cfg, sort_tiles=True)
            assert torch.isfinite(res.log_normalizing_constant).all()
            print(f"[sqjd] quick cell, tolerance {tol}: {res.num_iters} SMC "
                  f"iterations, final temperatures "
                  f"[{float(res.temperature.min()):.4f}, 1]")
            return kernel.num_iters

        def batch(suite, mala_steps=None, images=None):
            def run(tol):
                cfg = _suite_config(suite, tmp, mala_steps)
                cfg.kernel.sqjumpdist_tol = tol
                cfg.output_dir = f"{tmp}/{suite}_{mala_steps is None}_{tol}"
                cfg.num_images = cfg.batch_size = images or cfg.batch_size
                res = load_results(run_experiment(cfg, device=dev,
                                                  verbose=False))
                assert np.isfinite(res["log_normalizing_constant"]).all()
                np.testing.assert_allclose(res["weights"].sum(-1), 1.0,
                                           atol=1e-5)
                if "temperature" in res:  # the per-image pipeline keeps none
                    print(f"[sqjd] {suite} under {cfg.kernel.kind}, "
                          f"tolerance {tol}: "
                          f"{res['num_iters'].tolist()} SMC iterations, "
                          f"final temperatures "
                          f"[{float(res['temperature'].min()):.4f}, 1]")
                return cfg.kernel.num_iters
            return run

        paths = (("quick cell", ("K1",), quick),
                 ("basic", ("K2",), batch("basic")),
                 ("basic under MALA", ("K4 tile",),
                  batch("basic", MALA_BASIC_STEPS)),
                 ("divideandconquer image", ("K1", "K3"),
                  batch("divideandconquer", images=1)))
        for label, kids, run in paths:
            with _EarlyStopRuns() as every:
                _reset_launches()
                iters = run(0.0)
                launches = _launches()
            n = sum(launches[k] for k in kids)
            print(f"[sqjd] {label}, tolerance 0: {len(every.mutations)} "
                  f"mutations, every one {iters} sweeps; launches "
                  f"{launches}")
            assert all(m[0] == iters for m in every.mutations)
            assert n == iters * len(every.mutations) > 0, (n, iters)
            for k in totals:
                totals[k] += launches[k]

            with _EarlyStopRuns(SQJD_COMPARE_EVERY) as runs:
                _reset_launches()
                start = time.perf_counter()
                run(SQJD_TOL)
                wall = time.perf_counter() - start - runs.compare_s
                launches = _launches()
            muts = runs.mutations
            sweeps = [m[0] for m in muts]
            n = sum(launches[k] for k in kids)
            others = sum(launches.values()) - n - launches["K5"]
            held = [m for m in muts if m[1] is not None]
            same = sum(m[0] == m[1] for m in held) / len(held)
            agree = sum(m[2] * m[3] for m in held) / sum(m[3] for m in held)
            host_ms = sum(m[4] for m in muts) / sum(sweeps) * 1e3
            print(f"[sqjd] {label}, tolerance {SQJD_TOL}: {len(muts)} "
                  f"mutations, sweeps per mutation mean "
                  f"{np.mean(sweeps):.2f}, min {min(sweeps)}, max "
                  f"{max(sweeps)} (of {iters}); {n} launches of "
                  f"{'+'.join(kids)} ({launches}), one a sweep; host wall "
                  f"per sweep {host_ms:.4f} ms; run wall {wall:.3f} s "
                  f"without the comparison ({runs.compare_s:.3f} s)")
            print(f"[sqjd] {label}: the plain version on the same keys, "
                  f"on {len(held)} of the {len(muts)} mutations, stops at "
                  f"the same sweep in {same:.4f} of them, {agree:.6f} of "
                  f"particles agree")
            assert n == sum(sweeps) and others == 0, (n, sum(sweeps),
                                                      launches)
            assert same >= 0.99 and agree >= 0.99, (same, agree)
            for k in totals:
                totals[k] += launches[k]
            records[label] = {"mutations": len(muts),
                              "sweeps_mean": float(np.mean(sweeps)),
                              "host_ms_per_sweep": host_ms, "wall_s": wall,
                              "launches": n}
    sim, prior, model, kernel, _ = build_problem(
        dev, num_tiles=SQJD_QUICK_TILES)
    one = {"quick cell": _one_sweep_record(dev, "quick cell", "K1", prior,
                                           model, kernel, SQJD_QUICK_TILES,
                                           2048, peaks)}
    prior, model, kernel, _ = suite_problem(dev, "basic")
    one["basic"] = _one_sweep_record(dev, "basic", "K2", prior, model,
                                     kernel, 20, 512, peaks)
    one["basic under MALA"] = _one_sweep_record(
        dev, "basic under MALA", "K4", prior, model,
        mala_kernel_for(kernel, MALA_BASIC_STEPS, dev), 20, 512, peaks)
    for label, rec in one.items():
        print(f"[sqjd] {label}: host wall per sweep "
              f"{records[label]['host_ms_per_sweep']:.4f} ms against the "
              f"one-sweep launch's {rec['ms']:.4f} ms on the card")
        rec["launches"] = records[label]["launches"]
    return totals, one


def phase_history(dev):
    """The quick cell with ``record_history`` and the fixed ladder
    ``HISTORY_LADDER``, unchunked and in chunks of 4 tiles (sorted by
    flux): every tile steps through the ladder (the recorded temperatures
    equal it bit for bit, zeros past the last iteration), the history's
    shapes are the JAX package's (``[max_smc_iters, T]``, ``[...,
    T, C]``), the chunked history equals the unchunked one's shape and
    temperatures, and every mutate call is a K1 launch. Returns K1's
    launches."""
    from smcdet_tpu_torch.inference.smc import (
        chunk_bytes_per_tile,
        run_csmc_chunked,
    )

    sim, prior, model, kernel, cfg = build_problem(dev)
    cfg = dataclasses.replace(cfg, record_history=True,
                              fixed_schedule=HISTORY_LADDER)
    images = sim.images.to(dev)
    T, C = images.shape[0], prior.num_counts
    steps = len(HISTORY_LADDER) - 1
    launches, hist = 0, {}
    for label, budget in (("unchunked", None), ("chunked", 4 * (
            chunk_bytes_per_tile(prior, cfg.num_catalogs, TILE * TILE)))):
        _reset_launches()
        start = time.perf_counter()
        res = run_csmc_chunked(torch.Generator(device=dev).manual_seed(1),
                               images, prior, model, kernel, cfg,
                               budget_bytes=budget, sort_tiles=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        k1 = _launches()["K1"]
        h = res.history
        chunks = 1 if budget is None else T // 4
        print(f"[history] {label}: {res.num_iters} iterations in {wall:.3f} "
              f"s, {chunks} chunk(s), K1 launches {k1}; history shapes "
              f"{ {k: tuple(v.shape) for k, v in h.items()} }")
        assert res.num_iters == steps and k1 == steps * chunks, (
            res.num_iters, k1)
        assert tuple(h["temperature"].shape) == (cfg.max_smc_iters, T)
        assert tuple(h["ess"].shape) == (cfg.max_smc_iters, T, C)
        assert tuple(h["acc_rate"].shape) == (cfg.max_smc_iters, T)
        ladder = torch.tensor(HISTORY_LADDER[1:], device=dev)[:, None]
        assert torch.equal(h["temperature"][:steps],
                           ladder.expand(steps, T))
        assert torch.all(h["temperature"][steps:] == 0)
        assert torch.all(h["ess"][:steps] > 0)
        assert torch.all(res.temperature == 1.0)
        launches += k1
        hist[label] = h
    assert torch.equal(hist["chunked"]["temperature"],
                       hist["unchunked"]["temperature"])
    print(f"[history] recorded temperatures equal the ladder "
          f"{list(HISTORY_LADDER[1:])} on all {T} tiles, chunked and not; "
          f"per-stratum ESS/N at the last rung "
          f"{float(hist['unchunked']['ess'][steps - 1].min()) / cfg.num_catalogs:.4f}"
          f" (min)")
    return launches


def fit_problem(device, size=64, stars=60, seed=0):
    """A ``size`` x ``size`` patch rendered from the m71 fixture's fitted
    ``params.yaml`` with known stars (positions up to the PSF radius
    outside the patch, as ``prepare_data.py`` includes them; fluxes from
    the fitted flux prior, capped at 300 nmgy) over a sloped sky map, the
    noise from a CPU generator. Returns ``(image, locs, fluxes, sky,
    params)``."""
    import yaml

    from smcdet_tpu_torch.models.imaging import M71ImageModel

    with open("experiments/m71/data/m71/params.yaml") as f:
        p = yaml.safe_load(f)
    rng = np.random.default_rng(seed)
    r = p["psf_radius"]
    locs = rng.uniform(-r, size + r, (stars, 2)).astype(np.float32)
    a, lo, hi = p["flux_alpha"], p["flux_lower"], p["flux_upper"]
    u = rng.uniform(size=stars)
    fluxes = np.minimum(lo * (1 - u * (1 - (lo / hi) ** a)) ** (-1 / a),
                        300.0).astype(np.float32)
    yy, xx = np.mgrid[:size, :size]
    sky = (p["background"] + 0.5 * (yy - size / 2)
           - 0.3 * (xx - size / 2)).astype(np.float32)
    truth = M71ImageModel(size, size, torch.from_numpy(sky).to(device),
                          p["adu_per_nmgy"], p["psf_params"], r,
                          p["noise_additive"], p["noise_multiplicative"],
                          device=device)
    image = truth.sample(torch.Generator().manual_seed(seed + 5),
                         torch.from_numpy(locs).to(device),
                         torch.from_numpy(fluxes).to(device))
    return image, locs, fluxes, sky, p


def phase_fit(dev):
    """``fitting.fit_image_model`` on the card (200 L-BFGS steps, as
    ``prepare_data.py``) against a 64x64 patch from ``fit_problem``,
    started 10% off on the PSF and 5% off on the calibration: the
    recovered parameters beside the truth, the steps and the wall. Held:
    a finite loss no higher than the truth's (to 1e-4 relative: the fit is
    the maximum of the likelihood), the calibration as it reaches the
    pixels (``fitting.in_window_calibration``) within 1% and the PSF core
    width within 5% of the truth. ``adu_per_nmgy`` alone is printed: it
    trades with the wing's mass outside the render window, which this
    patch barely constrains (the JAX package's fit of it ends 8.5% above
    the truth, its float64 optimum 35% above)."""
    from smcdet_tpu_torch import convert, fitting

    image, locs, fluxes, sky, p = fit_problem(dev)
    steps = 200
    torch.cuda.synchronize()
    start = time.perf_counter()
    fit = fitting.fit_image_model(
        image, locs, fluxes, tuple(1.1 * v for v in p["psf_params"]), sky,
        0.95 * p["adu_per_nmgy"], psf_radius=p["psf_radius"],
        num_steps=steps, device=dev)
    wall = time.perf_counter() - start
    truth = convert.m71_model_from_fit(
        fitting.FittedImageModel(tuple(p["psf_params"]), 0.0,
                                 p["adu_per_nmgy"], p["noise_additive"],
                                 p["noise_multiplicative"], 0.0),
        64, 64, p["psf_radius"], torch.from_numpy(sky).to(dev), dev)
    truth_loss = -float(truth.loglikelihood(
        image, torch.from_numpy(locs).to(dev),
        torch.from_numpy(fluxes).to(dev))) / (64 * 64)
    print(f"[fit] 64x64 patch, {len(fluxes)} stars: {steps} L-BFGS steps in "
          f"{wall:.3f} s on the card; loss {fit.final_loss:.6f} (the "
          f"truth's {truth_loss:.6f})")
    names = ("sigma1", "sigma2", "sigmap", "beta", "b", "p0")
    for name, got, want in zip(names, fit.psf_params, p["psf_params"]):
        print(f"[fit] {name}: {got:.6g} (truth {want:.6g})")
    for name in ("adu_per_nmgy", "noise_additive", "noise_multiplicative"):
        print(f"[fit] {name}: {getattr(fit, name):.6g} (truth {p[name]:.6g})")
    print(f"[fit] background (the sky map's mean, held): "
          f"{fit.background:.4f}")
    calibration = (
        fitting.in_window_calibration(fit.adu_per_nmgy, fit.psf_params,
                                      p["psf_radius"]),
        fitting.in_window_calibration(p["adu_per_nmgy"], p["psf_params"],
                                      p["psf_radius"]))
    print(f"[fit] in-window calibration: {calibration[0]:.6g} (truth "
          f"{calibration[1]:.6g})")
    assert np.isfinite(fit.final_loss)
    assert fit.final_loss <= truth_loss * (1 + 1e-4), (fit.final_loss,
                                                       truth_loss)
    assert abs(calibration[0] / calibration[1] - 1) < 0.01, calibration
    assert abs(fit.psf_params[0] / p["psf_params"][0] - 1) < 0.05
    return wall


def phase_m71ss(dev, workers=None):
    """The m71semisynthetic generate step on the card: all 688 fixture
    tiles in each ``--catalog`` mode (timed; the rate on the card, the
    noise from the config's CPU generator, so the tiles equal a CPU
    render's to the render's rounding, checked), then the first 8 tiles of
    the padded render through ``run_experiment`` (per-tile backgrounds, K2
    with the fitted general wing) at ``M71SS_RUNS`` sampler seeds: the
    config seed's run printed beside the JAX runner's single-run share on
    the same tiles, the tile-runs within +-1 over all seeds held to
    ``binomial_floor`` of the JAX runner's count on the same seeds
    (``M71SS_JAX_WITHIN``). Returns the runs' launches."""
    from smcdet_tpu_torch import semisynthetic
    from smcdet_tpu_torch.run_experiment import load_suite_config

    suite = "experiments/m71semisynthetic"
    renders = {}
    for config, catalog in (("config.yaml", "padded"),
                            ("config_nospill.yaml", "intile"),
                            ("config_reach.yaml", "reach")):
        cfg = load_suite_config(suite, config)
        torch.cuda.synchronize()
        start = time.perf_counter()
        tiles = semisynthetic.render_tiles(cfg, catalog, device=dev)
        wall = time.perf_counter() - start
        cpu = semisynthetic.render_tiles(cfg, catalog, 8, device="cpu")
        diff = float(np.abs(tiles["images"][:8] - cpu["images"]).max())
        images = tiles["images"]
        print(f"[m71ss] {cfg.name} ({catalog}): {images.shape[0]} tiles "
              f"rendered in {wall:.3f} s on the card; pixels "
              f"[{images.min():.1f}, {images.max():.1f}], first 8 tiles "
              f"within {diff:.3e} ADU of the CPU render")
        assert images.shape == (688, 8, 8) and np.isfinite(images).all()
        assert diff < 1e-2, diff
        renders[catalog] = tiles
    cfg = load_suite_config(suite)
    cfg.num_images = cfg.batch_size = 8
    tiles = {k: v[:8] for k, v in renders["padded"].items()}
    truth = tiles["true_counts"]
    seed, runs = cfg.seed, []
    launches = dict.fromkeys(("K1", "K2", "K3"), 0)
    with tempfile.TemporaryDirectory() as tmp:
        # the tiles stay the config seed's render; the seed drives the
        # sampler
        cfg.output_dir = tmp
        seeds = range(seed, seed + M71SS_RUNS)
        for run_seed, (run, levels, means) in zip(seeds, _seed_runs(
                dev, cfg, tiles, seeds, "m71ss", workers)):
            assert run["K2"] > 0 and run["K1"] == run["K3"] == 0, run
            assert all(lv == [] for lv in levels)  # one tile: no level
            for k in launches:
                launches[k] += run[k]
            runs.append(_share_of_means(f"m71ss seed {run_seed}", means,
                                        truth))
    within = [round(r * len(truth)) for r in runs]
    n, hits = len(truth) * len(runs), sum(within)
    floor = binomial_floor(n, M71SS_JAX_WITHIN)
    print(f"[m71ss] the config seed's run: {within[0]}/8 within +-1 (the "
          f"JAX runner's single runs {M71SS_REFERENCE_COUNT_SHARE * 8:.0f}/8;"
          f" printed, not held); over {len(runs)} sampler seeds {hits}/{n} "
          f"tile-runs within +-1 (the JAX runner {M71SS_JAX_WITHIN}/{n}; "
          f"at least {floor}, outside the lower {DNC_ALPHA} tail at its "
          f"rate)")
    assert hits >= floor, (hits, floor)
    return launches


# ``[bench]``: the sorted-chunk runs of ``smcdet_tpu_torch.bench`` (label,
# tiles, N, chunk); then, for information, the full frame at the memory
# model's largest chunk (``max_tiles_per_chunk``)
BENCH_RUNS = (("quick", 16, 2048, 16), ("full frame", 332, 4096, 14))
# ``[stream]``: the streaming pool's runs (label, tiles, N, pool), and the
# profiled run's tiles (the frame's first ones) at the frame's pool
STREAM_RUNS = (("quick", 16, 2048, 16), ("full frame", 332, 4096, 28))
STREAM_PROFILE_TILES = 56


def phase_bench_shapes(dev, peaks):
    """K1 at the bench's launch shapes, each timed beside its bound and its
    plain version and held to it by ``launch_agreement`` (``time_launch``):
    a 14-tile chunk at N = 4096 (98 groups), the 28-slot pool at N = 4096
    (196 groups) and the quick cell (112 groups x 2048), 100 sweeps.
    Returns the records by path."""
    from smcdet_tpu_torch import bench

    key = torch.tensor([24680, 13579], dtype=torch.int64, device=dev)
    records = {}
    for path, tiles, N in (("chunk 14", 14, 4096), ("pool 28", 28, 4096),
                           ("quick", 16, 2048)):
        _, prior, model, kernel, _ = bench.build_problem(dev)
        records[path] = time_launch(
            f"bench {path}", "K1",
            _sweep_args(key, kernel, *_kernel_inputs(dev, prior, model, tiles,
                                                     N, 0), kernel.num_iters),
            peaks, label="bench")
    return records


def _bench_run(dev, fn, *args, **kwargs):
    """``fn(dev, *args, **kwargs)`` (``bench.sorted_chunks`` or
    ``bench.streaming``) with the launch counts set to 0 just before and
    read just after, every mutate call counted: every one a K1 launch, no
    other kernel launched.
    Returns the bench's record and info, K1's launches and the peak memory
    above the allocation before the run."""
    with _Calls() as calls:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        _reset_launches()
        record, info = fn(dev, *args, **kwargs)
        launches = _launches()
    peak = torch.cuda.max_memory_allocated(dev) - before
    assert calls.tile["mh"] == launches["K1"] > 0, (calls.tile, launches)
    assert sum(launches.values()) == launches["K1"], launches
    return record, info, launches["K1"], peak


def _bench_share(info):
    """The share of tiles whose posterior-mean pruned count lies within
    +-1 of the truth, and the count of them."""
    within = (info["mean_count"] - info["truth"].float()).abs() <= 1.0
    return float(within.float().mean()), int(within.sum())


def phase_bench(dev):
    """``[bench]``: the bench module's sorted-chunk main (``BENCH_RUNS``)
    through ``_bench_run``: every tile at temperature 1 with finite log Z
    and weights summing to 1 (the bench checks), peak memory under
    ``run_csmc_chunked``'s estimate for one chunk, the quick tiles' +-1
    share at or above the JAX runner's (``BENCH_REFERENCE_COUNT_SHARE``);
    the frame's share, chunks, iterations per chunk and peak printed with
    the JSON line. Then the full frame at the memory model's largest
    chunk, printed for information (not in ``[paths]``). Returns K1's launches by run and the runs' infos."""
    from smcdet_tpu_torch import bench
    from smcdet_tpu_torch.inference.smc import (
        default_budget_bytes,
        max_tiles_per_chunk,
    )

    prior = bench.build_problem("cpu")[1]
    launches, infos = {}, {}
    largest = max_tiles_per_chunk(prior, 4096, TILE * TILE,
                                  default_budget_bytes(dev))
    runs = list(BENCH_RUNS) + [(f"full frame chunk {largest}", 332, 4096,
                                largest)]
    for label, T, N, chunk in runs:
        record, info, n, peak = _bench_run(
            dev, bench.sorted_chunks, T, N, 100, chunk,
            label=None if chunk == 14 or T <= 16
            else f"M71 full frame, chunks of {chunk}")
        launches[label], infos[label] = n, info
        share, within = _bench_share(info)
        print(f"[bench] {label}: {T} tiles, N={N}, chunk {chunk}: "
              f"{info['chunks']} chunks, SMC iterations per chunk "
              f"{info['num_iters']}, {info['elapsed']:.3f} s, {within}/{T} "
              f"tiles within +-1 ({share:.4f}), peak {peak} B "
              f"({peak / 2**30:.3f} GiB), K1 launches {n}")
        _check_chunk_budget("bench", label, prior, N, TILE * TILE,
                            min(chunk, T), peak)
        print(f"[bench] {label}: {json.dumps(record)}")
        if label == "quick":
            assert share >= BENCH_REFERENCE_COUNT_SHARE - 1e-9, (
                share, BENCH_REFERENCE_COUNT_SHARE)
    return launches, infos


def _result_bytes_per_tile(dev, prior, model, cfg):
    """Device bytes of one tile's ``SMCResult`` (``csmc_finalize`` of a
    fresh one-tile state)."""
    from smcdet_tpu_torch.inference.smc import csmc_finalize, csmc_init

    state = csmc_init(torch.Generator(device=dev).manual_seed(0),
                      torch.full((1, TILE, TILE), 179.0, device=dev), prior,
                      model, cfg)
    res = csmc_finalize(prior, model, cfg, state)
    return sum(v.numel() * v.element_size() for v in res
               if isinstance(v, torch.Tensor))


def phase_stream(dev, chunked):
    """``[stream]``: the bench module's ``--streaming`` main (``STREAM_RUNS``)
    through ``_bench_run``, held as ``[bench]``'s runs, its peak held to
    the memory model's estimate for the pool plus twice the results it
    returns (the finalized tiles and their stacking); tiles/s beside the
    sorted-chunk run on the same tiles (``chunked``: ``[bench]``'s infos)
    and the mean SMC iterations a tile against the chunks' (every tile of a
    chunk runs its chunk's longest). Then ``torch.profiler`` over a warm
    streaming run of the frame's first ``STREAM_PROFILE_TILES`` tiles at
    the frame's pool: the device's idle share, the host's time a step and
    the ``stream.*`` ranges' host time. Returns K1's launches by run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from smcdet_tpu_torch import bench
    from smcdet_tpu_torch.inference import smc
    from smcdet_tpu_torch.inference.streaming import run_csmc_streaming

    launches = {}
    for label, T, N, pool in STREAM_RUNS:
        record, info, n, peak = _bench_run(dev, bench.streaming, T, N, 100,
                                           pool)
        launches[label] = n
        share, within = _bench_share(info)
        _, prior, model, _, cfg = bench.build_problem(dev, T, N)
        per_tile = smc.chunk_bytes_per_tile(prior, N, TILE * TILE)
        results = _result_bytes_per_tile(dev, prior, model, cfg)
        limit = pool * per_tile + 2 * T * results
        base = chunked[label]
        real = [min(base["chunk"], T - c * base["chunk"])
                for c in range(base["chunks"])]
        chunk_iters = sum(r * i for r, i in zip(real, base["num_iters"])) / T
        print(f"[stream] {label}: {T} tiles, N={N}, pool {info['pool']}: "
              f"{info['steps']} steps, {info['elapsed']:.3f} s, "
              f"{T / info['elapsed']:.4f} tiles/s against the sorted "
              f"chunks' {T / base['elapsed']:.4f}; mean iterations a tile "
              f"{record['mean_tile_iters']:.3f} against the chunks' "
              f"{chunk_iters:.3f} (slot-steps {record['slot_steps']}); "
              f"{within}/{T} tiles within +-1 ({share:.4f}); K1 launches {n}")
        print(f"[stream] {label}: peak {peak} B ({peak / 2**30:.3f} GiB) "
              f"against the pool's estimate {pool * per_tile} B + 2 x "
              f"{T} x {results} B of results = {limit} B (ratio "
              f"{peak / limit:.3f})")
        print(f"[stream] {label}: {json.dumps(record)}")
        assert peak <= limit, (peak, limit)
        if label == "quick":
            assert share >= BENCH_REFERENCE_COUNT_SHARE - 1e-9, (
                share, BENCH_REFERENCE_COUNT_SHARE)

    label, T, N, pool = STREAM_RUNS[-1]
    tiles, prior, model, kernel, cfg = bench.build_problem(
        dev, STREAM_PROFILE_TILES, N)
    images = tiles.images.to(dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        _, info = run_csmc_streaming(
            torch.Generator(device=dev).manual_seed(2), images, prior, model,
            kernel, cfg, pool=pool, return_info=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    # a range's device-side twin spans the gaps between its kernels: only
    # the kernels are summed
    kernel_ms, k1_ms, ranges = 0.0, 0.0, {}
    for e in prof.events():
        in_range = e.name.startswith(("stream.", "smc."))
        if e.device_type == DeviceType.CUDA and not in_range:
            kernel_ms += e.device_time_total / 1e3
            if kernel_id(e.name) == "K1":
                k1_ms += e.device_time_total / 1e3
        elif e.device_type == DeviceType.CPU and e.name.startswith(
                "stream."):
            n, ms = ranges.get(e.name, (0, 0.0))
            ranges[e.name] = (n + 1, ms + e.cpu_time_total / 1e3)
    steps = info["steps"]
    print(f"[stream] profile: {STREAM_PROFILE_TILES} tiles at pool {pool}, "
          f"N={N}: {steps} steps, wall {wall * 1e3:.1f} ms, kernels "
          f"{kernel_ms:.1f} ms (K1 {k1_ms:.1f}), device idle "
          f"{1 - kernel_ms / (wall * 1e3):.3f}; host {wall * 1e3 / steps:.2f} "
          f"ms a step")
    for name in sorted(ranges, key=lambda k: -ranges[k][1]):
        n, ms = ranges[name]
        print(f"[stream] profile: {name}: {n} calls, host {ms:.1f} ms "
              f"({ms / n:.3f} ms a call)")
    return launches


def phase_stream_entry(dev):
    """The pool through the entry points a user calls: ``run_experiment`` on
    one batch of ``experiments/basic/config.yaml`` with ``sampler.streaming``
    (the memory model's pool: all 20 tiles, K2 at basic's batch shape), and
    ``SMCSampler.run(streaming=True)`` on a 32x32 image tiled from the
    bench's 16 quick tiles (K1 at the quick cell's shape). Each run's
    launches counted from 0 and every tile at temperature 1 with finite
    log Z; the basic batch's +-1 share printed (one draw, not held).
    Returns the launches by path."""
    from smcdet_tpu_torch import bench
    from smcdet_tpu_torch.inference.smc import SMCSampler
    from smcdet_tpu_torch.runner import load_results, run_experiment

    out = {}
    cfg = _suite_config("basic")
    cfg.num_images = cfg.batch_size
    cfg.sampler.streaming = True
    with tempfile.TemporaryDirectory() as tmp:
        cfg.output_dir = tmp
        with _Calls() as calls:
            _reset_launches()
            start = time.perf_counter()
            res = load_results(run_experiment(cfg, device=dev,
                                              verbose=False))
            wall = time.perf_counter() - start
            launches = _launches()
        truth = _write_tiles(cfg, tmp)["true_counts"]
    assert launches["K2"] == calls.tile["mh"] > 0, (launches, calls.tile)
    assert sum(launches.values()) == launches["K2"], launches
    assert np.all(res["temperature"] == 1.0), res["temperature"]
    assert np.isfinite(res["log_normalizing_constant"]).all()
    np.testing.assert_allclose(res["weights"].sum(-1), 1.0, atol=1e-5)
    mean = (res["weights"] * res["pruned_counts"]).sum(-1)
    within = int((np.abs(mean - truth) <= 1.0).sum())
    out["basic"] = launches["K2"]
    print(f"[stream] run_experiment basic with sampler.streaming: "
          f"{cfg.batch_size} tiles, {launches['K2']} K2 launches, "
          f"{float(res['runtime'][0]):.3f} s batch ({wall:.3f} s with the "
          f"simulation), {within}/{cfg.batch_size} tiles within +-1 (one "
          f"draw; the chunked batch's bar {BASIC_REFERENCE_COUNT_SHARE})")

    tiles, prior, model, kernel, cfg = bench.build_problem(dev)
    image = tiles.images.reshape(4, 4, TILE, TILE).permute(0, 2, 1, 3)
    sampler = SMCSampler(image.reshape(4 * TILE, 4 * TILE), TILE, prior,
                         model, kernel, cfg.num_catalogs,
                         ess_threshold_prop=cfg.ess_threshold_prop,
                         resample_method=cfg.resample_method,
                         flux_detection_threshold=0.7)
    with _Calls() as calls:
        _reset_launches()
        start = time.perf_counter()
        r = sampler.run(torch.Generator(device=dev).manual_seed(1),
                        streaming=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        launches = _launches()
    assert launches["K1"] == calls.tile["mh"] > 0, (launches, calls.tile)
    assert sum(launches.values()) == launches["K1"], launches
    assert torch.all(r.temperature == 1.0), r.temperature
    assert torch.isfinite(r.log_normalizing_constant).all()
    assert torch.equal(sampler.tiled_image.cpu(), tiles.images)
    out["sampler"] = launches["K1"]
    print(f"[stream] SMCSampler.run(streaming=True) on the 16 quick tiles "
          f"as a 32x32 image: {launches['K1']} K1 launches, {wall:.3f} s; "
          f"posterior mean counts "
          f"{[round(float(x), 3) for x in sampler.posterior_mean_count()]}")
    return out


# ``[studies]``: the studies' cuts (compare_kernels' basic images, the
# single-tile run's divideandconquer images, compare_pooled's images and
# reps), on the JAX package's tiles of the suites (tests/data)
STUDIES_KERNELS_IMAGES = 20
STUDIES_SINGLETILE_IMAGES = 4
STUDIES_POOLED = (2, 2)


def _stage_suite_tiles(out, suite):
    """The JAX package's tiles of ``suite`` (``tests/data``) as
    ``out/<suite>/tiles.npz``, where the studies read them."""
    dst = Path(out) / suite / "tiles.npz"
    dst.parent.mkdir(parents=True, exist_ok=True)
    shutil.copy(f"tests/data/{suite}_tiles.npz", dst)
    return dst


def _studies_singletile(dev, peaks, out, tmp):
    """K2 at the single-tile run's launch (``config_singletile.yaml``: 4
    16x16 images x 9 strata x 2048, the M71 model's Gaussian noise and
    beta = 3 wing, Pareto flux, M = 8, 50 sweeps) and at compare_pooled's
    single-tile arm's (``STUDIES_POOLED`` images) against its plain version
    and its bound (``time_launch``), then that run through
    ``run_experiment`` on the first 4 divideandconquer images, every mutate
    call a K2 launch. Returns the two records by path and K2's launches."""
    from smcdet_tpu_torch.config import (
        build_image_model,
        build_kernel,
        build_prior,
        load_config,
    )
    from smcdet_tpu_torch.runner import load_results, run_experiment

    cfg = load_config("experiments/divideandconquer/config_singletile.yaml")
    key = torch.tensor([97531, 86420], dtype=torch.int64, device=dev)
    n = STUDIES_SINGLETILE_IMAGES
    prior = build_prior(cfg.prior, dev)
    model = build_image_model(cfg.image_model, dev)
    kernel = build_kernel(cfg.kernel, dev)
    records = {path: time_launch(
        path, "K2",
        _sweep_args(key, kernel, *_kernel_inputs(
            dev, prior, model, images, cfg.sampler.num_catalogs, 0),
            kernel.num_iters), peaks, label="studies")
        for path, images in (("single-tile", n),
                             ("pooled single-tile", STUDIES_POOLED[0]))}
    cfg.num_images = cfg.batch_size = n
    cfg.data_path = str(out / "divideandconquer" / "tiles.npz")
    cfg.output_dir = tmp
    with _Calls() as calls:
        _reset_launches()
        start = time.perf_counter()
        res = load_results(run_experiment(cfg, device=dev, verbose=False))
        wall = time.perf_counter() - start
        launches = _launches()
    assert launches["K2"] == calls.tile["mh"] > 0, (launches, calls.tile)
    assert sum(launches.values()) == launches["K2"], launches
    assert np.isfinite(res["log_normalizing_constant"].max(-1)).all()
    np.testing.assert_allclose(res["weights"].sum(-1), 1.0, atol=1e-5)
    truth = np.load(cfg.data_path)["true_counts"][:n]
    mean = (res["weights"] * res["pruned_counts"]).sum(-1)
    print(f"[studies] single-tile run: {n} 16x16 images, "
          f"{int(res['num_iters'][0])} SMC iterations, batch "
          f"{float(res['runtime'][0]):.3f} s ({wall:.3f} s with loading), "
          f"K2 launches {launches['K2']}; temperatures "
          f"{res['temperature'].tolist()}; posterior mean pruned count "
          f"{[round(float(x), 3) for x in mean]} against truth "
          f"{truth.tolist()}")
    return records, launches["K2"]


def phase_studies(dev, peaks):
    """``[studies]``: the three study modules on the card, on the JAX
    package's tiles (``tests/data``). compare_kernels on the first
    ``STUDIES_KERNELS_IMAGES`` basic images (K2 against K4, a warm and a
    timed run each); the single-tile path on the first
    ``STUDIES_SINGLETILE_IMAGES`` divideandconquer images
    (``_studies_singletile``: K2 at its new 16x16 M71 launch shape);
    compare_pooled at ``STUDIES_POOLED`` images x reps with the dump
    (single-tile arm K2, divide-and-conquer arm K1 tiles and K3 bridges),
    then the numpy-only ``attribute_pooled.py`` and
    ``truth_score_pooled.py`` on the dump (exit 0). Each study's launches
    counted from 0. Returns K2's records at the single-tile run's and the
    pooled arm's launch, and the launches by path."""
    from smcdet_tpu_torch.studies import compare_kernels, compare_pooled

    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "output"
        _stage_suite_tiles(out, "basic")
        _stage_suite_tiles(out, "divideandconquer")

        with _Calls() as calls:
            _reset_launches()
            report = compare_kernels.main([
                "--num-images", str(STUDIES_KERNELS_IMAGES), "--output-dir",
                str(out), "--device", "cuda"])
            run = _launches()
        assert run["K2"] == calls.tile["mh"] > 0, (run, calls.tile)
        assert run["K4 tile"] == calls.tile["mala"] > 0, (run, calls.tile)
        assert run["K1"] == run["K3"] == run["K4 bridge"] == 0, run
        launches["compare_kernels MH"] = run["K2"]
        launches["compare_kernels MALA"] = run["K4 tile"]
        k = report["kernels"]
        print(f"[studies] compare_kernels on {report['images']} basic "
              f"images: MH {k['mh']['smc_iterations']} SMC iterations, "
              f"acceptance {k['mh']['acceptance_rate_mean']}, wall "
              f"{k['mh']['wall_s']} s; MALA "
              f"{k['mala']['smc_iterations']} iterations, acceptance "
              f"{k['mala']['acceptance_rate_mean']}, wall "
              f"{k['mala']['wall_s']} s; count-pmf TVD "
              f"{report['count_pmf_tvd']}; K2 launches {run['K2']}, K4 "
              f"{run['K4 tile']}")
        for entry in k.values():
            assert 0 < entry["acceptance_rate_mean"] < 1, entry
        assert 0 <= report["count_pmf_tvd"]["mean"] <= 1

        records, launches["single-tile"] = _studies_singletile(dev, peaks,
                                                               out, tmp)

        images, reps = STUDIES_POOLED
        with _Calls() as calls:
            _reset_launches()
            start = time.perf_counter()
            report = compare_pooled.main([
                "--num-images", str(images), "--reps", str(reps), "--dump",
                "--suffix", "_dump", "--output-dir", str(out), "--device",
                "cuda"])
            wall = time.perf_counter() - start
            run = _launches()
        per_level = [sum(lv[k][0] for lv in calls.levels if len(lv) > k)
                     for k in range(max(len(lv) for lv in calls.levels))]
        assert run["K2"] > 0 and run["K1"] > 0 and run["K3"] > 0, run
        assert run["K4 tile"] == run["K4 bridge"] == 0, run
        assert sum(per_level) == run["K3"] == calls.bridge["mh"], (
            per_level, run)
        assert run["K1"] + run["K2"] == calls.tile["mh"], (run, calls.tile)
        launches["pooled single-tile"] = run["K2"]
        launches["pooled D&C tiles"] = run["K1"]
        launches["pooled D&C bridge levels"] = per_level
        print(f"[studies] compare_pooled {images} images x {reps} reps in "
              f"{wall:.3f} s: launches {run}, bridge launches by level "
              f"{per_level}; {json.dumps(report)}")
        for key, stats in report.items():
            if key.startswith("tvd"):
                assert all(0.0 <= v <= 1.0 for v in stats.values()), key
        for script, name in (("attribute_pooled.py",
                              "pooled_attribution_dump.json"),
                             ("truth_score_pooled.py",
                              "truth_score_dump.json")):
            proc = subprocess.run(
                [sys.executable, str(Path.cwd() / "experiments"
                                     / "divideandconquer" / script)],
                cwd=tmp, capture_output=True, text=True, timeout=120)
            assert proc.returncode == 0, proc.stderr
            result = json.loads((out / "divideandconquer" / name)
                                .read_text())
            print(f"[studies] {script} on the port's dump: exit 0, "
                  f"{json.dumps(result)[:400]}")
    return records, launches


# ``[m71studies]``: the M71 studies' cuts (the crowded probe's tiles, the
# scoring studies' one-batch runs a suite, repeated_runs' reps, N and
# sweeps, split_mode's chains and sweeps), sized to keep the phase near 75
# s on an H100 (its three crowded arms take about 1.2 s a tile, the plain
# reversible-jump anchors 8-17 ms a sweep)
M71STUDIES_CROWDED_TILES = 4
M71STUDIES_SUITE_TILES = 4
M71STUDIES_REPEATED = (8, (512, 2048), (10, 100))
M71STUDIES_SPLIT = (8, 150)
# repeated_runs at its committed size: runs a setting, particles per
# stratum (K1 is timed at each N's call shape, at the grid's 10 sweeps)
M71STUDIES_REPEATED_FULL = (100, (512, 2048, 8192))
M71STUDIES_SUITES = {"m71": "config.yaml", "m71_nogiants":
                     "config_nogiants.yaml", "m71_mis": "config_mis.yaml",
                     "m71_vary": "config_vary.yaml"}


class _SMCResults:
    """Keeps every tile-level ``SMCResult`` (``inference.smc.run_csmc``'s,
    which ``run_csmc_chunked``, ``SMCSampler`` and the per-image pipeline
    call) while the ``with`` block runs."""

    def __enter__(self):
        from smcdet_tpu_torch.inference import smc

        self.results = []
        self._saved = smc.run_csmc

        def kept(*args, **kwargs):
            res = self._saved(*args, **kwargs)
            self.results.append(res)
            return res

        smc.run_csmc = kept
        return self

    def __exit__(self, *exc):
        from smcdet_tpu_torch.inference import smc

        smc.run_csmc = self._saved

    def check(self, label):
        """Every tile of every run at temperature 1, a finite log Z in its
        best stratum and flat weights summing to 1. Returns the runs and
        tiles checked."""
        assert self.results, label
        tiles = 0
        for res in self.results:
            assert bool((res.temperature == 1.0).all()), (
                label, res.temperature.min())
            assert bool(torch.isfinite(
                res.log_normalizing_constant.max(-1).values).all()), label
            torch.testing.assert_close(
                res.weights.sum(-1), torch.ones_like(res.weights[:, 0]),
                atol=1e-5, rtol=0)
            tiles += res.temperature.numel()
        return len(self.results), tiles


def _m71_studies_run(label, fn, smc=True, tag="m71studies"):
    """``fn()`` with the launches counted from 0 and, with ``smc``, every
    SMC result held to the limits; its line tagged ``[tag]``. Returns its
    value and the launches."""
    with _SMCResults() as kept:
        _reset_launches()
        start = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - start
        launches = _launches()
    held = ""
    if smc:
        runs, tiles = kept.check(label)
        held = (f", {runs} SMC runs over {tiles} tiles, every tile at "
                f"temperature 1, finite log Z, weights summing to 1")
    print(f"[{tag}] {label} in {wall:.3f} s: launches "
          f"{ {k: v for k, v in launches.items() if v} }{held}", flush=True)
    return out, launches


def _figure_data(tag, path, shapes, recomputed):
    """One figure-data file a study of the phase wrote (``figures.py``'s
    names): it exists, holds every key of ``shapes`` (key to its shape, or
    None for any) with every array finite, and ``recomputed(arrays)``, a
    dict of label to (the figure recomputed from the file, the JSON's),
    agrees in every label. Prints one line; any miss fails the phase."""
    with np.load(path) as d:
        arrays = {k: d[k] for k in d.files}
    missing = [k for k in shapes if k not in arrays]
    assert not missing, (path, missing)
    for key, shape in shapes.items():
        assert shape is None or arrays[key].shape == shape, (
            path, key, arrays[key].shape, shape)
        assert np.isfinite(arrays[key]).all(), (path, key)
    pairs = recomputed(arrays)
    unequal = {k: v for k, v in pairs.items() if v[0] != v[1]}
    print(f"[{tag}] figure data {Path(path).name}: {Path(path).stat().st_size}"
          f" bytes, {len(arrays)} keys, shapes "
          f"{ {k: arrays[k].shape for k in shapes} } finite; recomputed "
          f"from the file = the JSON's: "
          + ", ".join(f"{k} {a} = {b}" for k, (a, b) in pairs.items()),
          flush=True)
    assert not unequal, (path, unequal)


def _misspec_figure_data(path, report):
    """``misspec_study``'s figure reads its JSON alone: the report, at
    least two variants finished, each with the coverage at every level and
    by region row."""
    from smcdet_tpu_torch.figures import MISSPEC_LEVELS
    from smcdet_tpu_torch.studies import misspec_study

    saved = json.loads(Path(path).read_text())
    assert saved == json.loads(json.dumps(report)), path
    rows = f"coverage_{misspec_study.LEVEL}_by_region_row"
    done = {k: v for k, v in saved["variants"].items() if isinstance(v, dict)}
    assert len(done) >= 2, saved
    for name, entry in done.items():
        assert sorted(entry["total_flux_coverage"]) == sorted(
            str(lv) for lv in MISSPEC_LEVELS), (name, entry)
        assert len(entry[rows]) == 4, (name, entry)
    print(f"[m71studies] figure data {Path(path).name}: "
          f"{Path(path).stat().st_size} bytes, {len(done)} "
          f"variants finished, each with its coverage at "
          f"{list(MISSPEC_LEVELS)} and by 4 bands of region rows", flush=True)


def _simulator_figure_data(out, report):
    from smcdet_tpu_torch.figures import (
        SIMULATOR_QUANTILES,
        figure_data_path,
    )
    from smcdet_tpu_torch.studies.simulator_checks import ks_statistic

    T = report["tiles"]
    ks = report["pixel_log_intensity_quantiles"]
    pp = report["posterior_predictive_image"]

    def recomputed(d):
        got = {f"KS {q}": (round(ks_statistic(d[f"sq_{q}"], d[f"rq_{q}"]),
                                 4), ks[q]["ks_statistic"])
               for q in SIMULATOR_QUANTILES}
        # a Python float, as the study compares: in float32
        truth = float(d["true_observed"])
        got["pp_flux_quantile_of_truth"] = (
            round(float((d["ppflux"] < truth).mean()), 4),
            pp["pp_flux_quantile_of_truth"])
        got["true_total_observed_flux"] = (round(truth, 1),
                                           pp["true_total_observed_flux"])
        got["index"] = (int(d["img_idx"]), pp["index"])
        got["tiles"] = (int(d["T"]), T)
        return got

    _figure_data("m71studies", figure_data_path(out / "m71",
                                                "simulator_checks"),
                 {**{f"{side}_{q}": (T,) for q in SIMULATOR_QUANTILES
                     for side in ("sq", "rq")},
                  "ppflux": None, "true_observed": (), "img_idx": (),
                  "T": ()}, recomputed)


def _repeated_figure_data(path, report, reps, Ns, steps):
    from smcdet_tpu_torch.studies import repeated_runs

    def recomputed(d):
        got = repeated_runs.summarize(
            d["logpx"], d["count_pmf"], int(d["image_index"]),
            report["true_count"], d["num_catalogs"], d["mh_steps"])
        return {k: (got[k], report[k]) for k in (
            "image_index", "num_catalogs", "mh_steps",
            "logpx_mid90_width_at_true_count",
            "count_prob_mid90_width_at_true_count",
            "shrinks_with_N_and_steps")}

    grid = (len(Ns), len(steps), reps)
    _figure_data("m71studies", path, {
        "logpx": None, "count_pmf": None, "smc_iters": grid,
        "num_catalogs": (len(Ns),), "mh_steps": (len(steps),),
        "image_index": ()}, recomputed)
    with np.load(path) as d:
        assert d["logpx"].shape[:3] == d["count_pmf"].shape[:3] == grid
        np.testing.assert_allclose(d["count_pmf"].sum(-1), 1.0, atol=1e-9)


def _split_figure_data(out, report):
    from smcdet_tpu_torch.figures import figure_data_path
    from smcdet_tpu_torch.studies.split_mode_study import ANCHORS

    anchors = report["anchors"]
    K = len(anchors["mh"]["pooled_count_pmf"])

    def recomputed(d):
        got = {f"pooled_count_pmf {a}": (
            [round(float(p), 4) for p in d[f"pmf_{a}"]],
            anchors[a]["pooled_count_pmf"]) for a in ANCHORS}
        got["image_index"] = (int(d["image_index"]), report["image_index"])
        got["true_flux_nmgy"] = (round(float(d["true_flux"]), 2),
                                 report["true_flux_nmgy"])
        got["chains"] = (int(d["chains"]), report["chains"])
        return got

    _figure_data("m71studies", figure_data_path(out, "split_mode_study"),
                 {**{f"pmf_{a}": (K,) for a in ANCHORS}, "image_index": (),
                  "true_flux": (), "chains": ()}, recomputed)


def _study_inputs(dev, prior, model, images, backgrounds, N, seed):
    """``_kernel_inputs`` on a study's own tiles: ``images [T, h, w]`` (and
    their ``backgrounds``, or the model's), prior catalogs, temperature
    0.8."""
    from smcdet_tpu_torch.inference.kernels import (
        TargetContext,
        init_kernel_state,
    )

    images = torch.as_tensor(images, dtype=torch.float32, device=dev)
    T = images.shape[0]
    if backgrounds is not None:
        model = model.with_background(torch.as_tensor(
            backgrounds, dtype=torch.float32, device=dev)[:, None, None])
    g = torch.Generator(device=dev).manual_seed(seed)
    strata, locs, fluxes = prior.sample_stratified(g, N, (T,))
    counts = strata[None, :, None].expand(T, prior.num_counts,
                                          N).contiguous()
    ctx = TargetContext(prior, model, images[:, None, None],
                        torch.full((T, 1, 1), 0.8, device=dev))
    return ctx, counts, init_kernel_state(ctx, counts, locs, fluxes)


def _m71_study_shapes(dev, peaks):
    """K1 and K2 at the launch shapes the M71 studies add, on the studies'
    own tiles, each against its plain version (``launch_agreement``) and
    its bound (``time_launch``): the crowded probe's hiN arm (its first
    tile x 11 strata x 8192, 100 sweeps) and hiS arm (x 2048, 200 sweeps)
    on the seed-6839 fit (K2), the oracle run's tile (the m71 fixture's
    first, x 2048, 100 sweeps, the literal beta = 3 wing: K1),
    simulator_checks' one tile (the fitted m71 model on fixture tile 585, x
    2048: K2), repeated_runs' calls on its s = 3 image at the committed
    size (100 runs x 7 strata at N = 512, 2048 and the largest call at
    8192, 10 sweeps: K1) and at ``[m71studies]``' cut (8 runs x 7 x 2048,
    100 sweeps). The crowded arms' and the oracle's disagreements after
    single sweeps are also classified (``_single_sweep_steps``)."""
    from smcdet_tpu_torch.config import build_prior
    from smcdet_tpu_torch.inference.smc import default_budget_bytes
    from smcdet_tpu_torch.run_experiment import load_suite_config
    from smcdet_tpu_torch.studies import repeated_runs, run_smc_oracle

    key = torch.tensor([24680, 13579], dtype=torch.int64, device=dev)
    records = {}

    def timed(path, name, cfg, tiles, N, sweeps, steps=False):
        images, backgrounds = tiles
        prior, model, kernel = _built(cfg, dev)
        problem = _study_inputs(dev, prior, model, images, backgrounds, N, 0)
        records[path] = time_launch(
            path, name, _sweep_args(key, kernel, *problem, sweeps), peaks,
            label="m71studies")
        if steps:
            _print_steps(f"m71studies {path}", problem[1],
                         _single_sweep_steps(dev, kernel, *problem))

    def fixture(path, idx):
        with np.load(path) as t:
            return t["images"][idx], t["background"][idx]

    crowded = fixture("experiments/m71/data_seed2/m71/tiles_crowded.npz",
                      [0])
    for arm in ("hiN", "hiS"):
        cfg = load_suite_config("experiments/m71",
                                f"config_seed2_crowded_{arm}.yaml")
        timed(f"crowded {arm} arm", "K2", cfg, crowded,
              cfg.sampler.num_catalogs, cfg.kernel.num_iters, steps=True)
    cfg = run_smc_oracle.oracle_config()
    timed("oracle tile", "K1", cfg, fixture(cfg.data_path, [0]),
          cfg.sampler.num_catalogs, cfg.kernel.num_iters, steps=True)
    cfg = load_suite_config("experiments/m71")
    timed("simulator_checks tile", "K2", cfg, fixture(cfg.data_path, [585]),
          2048, cfg.kernel.num_iters)
    cfg = load_suite_config("experiments/m71synthetic")
    prior = build_prior(cfg.prior, dev)
    with np.load("tests/data/m71synthetic_tiles.npz") as t:
        image = t["images"][190]
    reps, Ns = M71STUDIES_REPEATED_FULL
    for N in Ns:
        rpc = repeated_runs.reps_per_call(prior, N, reps, 64,
                                          default_budget_bytes(dev))
        timed(f"repeated_runs N={N}", "K1", cfg,
              (np.repeat(image[None], rpc, 0), None), N, 10)
    cut_reps, cut_Ns, cut_steps = M71STUDIES_REPEATED
    timed("repeated_runs cut", "K1", cfg,
          (np.repeat(image[None], cut_reps, 0), None), max(cut_Ns),
          max(cut_steps))
    return records


def phase_m71studies(dev, peaks):
    """``[m71studies]``: the seven M71 study modules on the card at cuts,
    in a temporary output directory, each run with the launches counted
    from 0 and every tile-level SMC run held to temperature 1, a finite
    log Z and weights summing to 1 (``_SMCResults``):

    - the crowded probe's three arms on the first
      ``M71STUDIES_CROWDED_TILES`` crowded tiles (the base arm on the
      crowded subset itself), scored (``crowded_budget_probe``);
    - the oracle run on ``M71STUDIES_SUITE_TILES`` fixture tiles (K1) and
      its analysis;
    - the m71, m71_nogiants, m71_mis and m71_vary suites on their first
      ``M71STUDIES_SUITE_TILES`` tiles (one batch each, K2), then
      ``compare_nogiants`` (its geometry equal to the committed one) and
      ``misspec_study`` on them;
    - ``simulator_checks`` (688 simulated tiles, one N = 2048 run: K2);
    - ``repeated_runs`` on the committed s = 3 image at
      ``M71STUDIES_REPEATED`` (K1);
    - ``split_mode_study`` at ``M71STUDIES_SPLIT`` chains x sweeps (K1 at
      N = 1, the two reversible-jump anchors plain).

    Then K1 and K2 at the launch shapes the studies add at their committed
    sizes (``_m71_study_shapes``). Returns those records and the launches
    by path."""
    from smcdet_tpu_torch import analyze
    from smcdet_tpu_torch.ops import mh_sweep
    from smcdet_tpu_torch.run_experiment import load_suite_config
    from smcdet_tpu_torch.runner import run_experiment
    from smcdet_tpu_torch.studies import (
        compare_nogiants,
        crowded_budget_probe,
        m71_fixture,
        misspec_study,
        repeated_runs,
        run_smc_oracle,
        simulator_checks,
        split_mode_study,
    )

    launches = {}
    n_suite = M71STUDIES_SUITE_TILES
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "output"
        assert all(crowded_budget_probe.subsets_match().values())
        n = M71STUDIES_CROWDED_TILES
        for arm in crowded_budget_probe.ARMS:
            _, run = _m71_studies_run(
                f"crowded probe {arm}, {n} tiles",
                lambda: crowded_budget_probe.run_arms(
                    out, "cuda", n, arms=[arm], verbose=False))
            assert run["K2"] > 0 and sum(run.values()) == run["K2"], run
            launches[f"crowded {arm}"] = run["K2"]
        report = crowded_budget_probe.compare(out, num_tiles=n)
        print(f"[m71studies] crowded probe, {n} tiles: "
              f"{json.dumps(report)}")
        for arm, entry in report["arms"].items():
            assert isinstance(entry, dict), (arm, entry)
            assert 0.0 <= entry["mean_sbc_rank"] <= 1.0, entry

        cfg = run_smc_oracle.oracle_config(n_suite, out)
        cfg.batch_size = n_suite
        assert mh_sweep.sweep_kernel(
            *_built(cfg, dev)[:2], cfg.prior.max_objects) == "K1"
        oracle_dir, run = _m71_studies_run(
            "oracle run", lambda: run_experiment(cfg, device=dev,
                                                 verbose=False))
        assert run["K1"] > 0 and sum(run.values()) == run["K1"], run
        launches["oracle"] = run["K1"]
        _quiet(analyze.main, [str(oracle_dir), "--tiles", cfg.data_path,
                              "--bootstrap", "50", "--device", "cuda",
                              "--no-figures"])
        got = json.loads((oracle_dir / "smc_analysis.json").read_text())
        print(f"[m71studies] oracle analysis, {got['images']} tiles: count "
              f"accuracy {got['count_accuracy']}, coverage 0.95 "
              f"{got['total_flux_coverage']['0.95']}, F1 by bin "
              f"{got['detection']['f1_by_bin']['point']}")

        def suites():
            for name, config in M71STUDIES_SUITES.items():
                c = load_suite_config("experiments/m71", config)
                c.output_dir = str(out)
                c.num_images = c.batch_size = n_suite
                run_experiment(c, device=dev, verbose=False)

        _, run = _m71_studies_run(
            f"m71, m71_nogiants, m71_mis, m71_vary on {n_suite} tiles each",
            suites)
        assert run["K2"] > 0 and sum(run.values()) == run["K2"], run
        launches["suites"] = run["K2"]
        report = _quiet(compare_nogiants.main, [
            "--base", str(out / "m71"), "--ablat", str(out / "m71_nogiants"),
            "--out", str(out / "nogiants_comparison.json")])
        assert report["geometry"]["num_giants"] == 4, report
        assert report["geometry"]["kept_tiles_within_render_reach"] == 0
        # over every kept tile of the fixture, the committed geometry
        with np.load("experiments/m71/data/m71/tiles.npz") as t:
            geometry = compare_nogiants.geometry(
                m71_fixture.default_truth_stars(), t["tile_index"])
        committed = json.loads(Path(
            "docs/results/m71/nogiants_comparison.json").read_text())
        assert geometry == committed["geometry"], geometry
        print(f"[m71studies] compare_nogiants: {json.dumps(report)}; the "
              f"whole fixture's geometry {geometry}, the committed one")
        report = _quiet(misspec_study.main, ["--output-dir", str(out)])
        assert all(isinstance(v, dict)
                   for v in report["variants"].values()), report
        print(f"[m71studies] misspec_study: {json.dumps(report)}")
        _misspec_figure_data(out / "m71" / "misspec_study.json", report)

        report, run = _m71_studies_run(
            "simulator_checks", lambda: _quiet(simulator_checks.main, [
                "--output-dir", str(out), "--device", "cuda"]))
        assert run["K2"] > 0 and sum(run.values()) == run["K2"], run
        launches["simulator"] = run["K2"]
        print(f"[m71studies] simulator_checks: {json.dumps(report)}")
        _simulator_figure_data(out, report)

        _stage_suite_tiles(out, "m71synthetic")
        reps, Ns, steps = M71STUDIES_REPEATED
        report, run = _m71_studies_run(
            "repeated_runs", lambda: _quiet(repeated_runs.main, [
                "--true-count", "3", "--image-index", "190", "--reps",
                str(reps), "--num-catalogs", *map(str, Ns), "--mh-steps",
                *map(str, steps), "--output-dir", str(out), "--device",
                "cuda"]))
        assert run["K1"] > 0 and sum(run.values()) == run["K1"], run
        launches["repeated"] = run["K1"]
        print(f"[m71studies] repeated_runs: {json.dumps(report)}")
        _repeated_figure_data(out / "m71synthetic" / "repeatedruns_s3.npz",
                              report, reps, Ns, steps)

        chains, sweeps = M71STUDIES_SPLIT
        report, run = _m71_studies_run(
            f"split_mode_study, {chains} chains x {sweeps} sweeps",
            lambda: _quiet(split_mode_study.main, [
                "--chains", str(chains), "--num-samples", str(sweeps),
                "--burnin", str(sweeps // 2), "--output-dir", str(out),
                "--device", "cuda"]), smc=False)
        assert run["K1"] > 0 and sum(run.values()) == run["K1"], run
        launches["split MH"] = run["K1"]
        for name, entry in report["anchors"].items():
            assert 0.0 <= entry["acc_rate_mean"] <= 1.0, (name, entry)
            assert abs(sum(entry["pooled_count_pmf"]) - 1.0) < 1e-3
        print(f"[m71studies] split_mode_study: {json.dumps(report)}")
        _split_figure_data(out / "m71synthetic", report)
    return _m71_study_shapes(dev, peaks), launches


ALIGN_REL_TOL = 1e-5  # card against CPU, of the frame's peak
# the joint footprint's edge: the fixture's bands share one WCS, so a
# pixel's source coordinate on the sampling window's edge (rows and
# columns 1 and size - 2) is an integer up to float64 rounding, which
# decides on either device whether it lies inside
ALIGN_EDGE_PX = 2


def _ingest_align(dev, data_dir):
    """``SurveyPredictIterator`` with ``align_to_band = r`` over the whole
    five-band frame on the card against the same on the CPU: within
    ``ALIGN_REL_TOL`` of the peak where both footprints hold the pixel,
    the footprints differing only within ``ALIGN_EDGE_PX`` of the frame's
    edge; the align's CUDA-event time, after one untimed call."""
    from smcdet_tpu_torch.data_prep import prepare_data as P
    from smcdet_tpu_torch.ingest import (
        SloanDigitalSkySurvey,
        SurveyPredictIterator,
        align,
    )

    survey = SloanDigitalSkySurvey(
        [{"run": P.RUN, "camcol": P.CAMCOL, "fields": [P.FIELD]}],
        f"{data_dir}/sdss", load_image_data=True, align_to_band=P.RBAND)
    survey.prepare_data(download=False)
    torch.cuda.synchronize()
    start = time.perf_counter()
    card = SurveyPredictIterator(survey, dev)[0]["images"]
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    start = time.perf_counter()
    cpu = SurveyPredictIterator(survey, "cpu")[0]["images"]
    cpu_s = time.perf_counter() - start
    card = card.cpu()
    both = (card != 0) & (cpu != 0)
    err = float((card - cpu)[both].abs().max() / cpu.abs().max())
    _, rows, cols = torch.nonzero((card == 0) != (cpu == 0), as_tuple=True)
    H, W = cpu.shape[1:]
    e = ALIGN_EDGE_PX
    off_edge = int(((rows > e) & (rows < H - 1 - e) & (cols > e)
                    & (cols < W - 1 - e)).sum())
    item = survey[0]
    images = torch.as_tensor(
        (item["image"] - item["background"])
        / item["flux_calibration"][:, None, :], device=dev)
    ms = _time_ms(lambda: align(images, item["wcs"], P.RBAND, device=dev), 3)
    print(f"[ingest] (e) SurveyPredictIterator, align_to_band r, "
          f"{tuple(images.shape)} float64 -> {tuple(card.shape)}: card "
          f"{wall:.3f} s (first call), CPU {cpu_s:.3f} s; max |card - "
          f"CPU| / peak {err:.3g} (tolerance {ALIGN_REL_TOL}) where both "
          f"footprints hold the pixel; the footprints differ on "
          f"{len(rows)} pixels, {off_edge} of them more than "
          f"{ALIGN_EDGE_PX} px from the edge; the align alone {ms:.3f} ms "
          "on the card (CUDA events, 3 calls)")
    assert err <= ALIGN_REL_TOL and off_edge == 0, (err, off_edge)
    return ms


def _psf_figure_data(out, report):
    from smcdet_tpu_torch.figures import figure_data_path
    from smcdet_tpu_torch.studies.psf_comparison import STAMP, fwhm

    psf, star = report["psf"], report["empirical_star"]

    def recomputed(d):
        return {
            "residual_rms_over_noise": (round(float(np.sqrt(np.mean(
                (d["resid"] / d["sigma"]) ** 2))), 3),
                star["residual_rms_over_noise"]),
            "tile_index": (int(d["idx"]), star["tile_index"]),
            "peak_adu": (round(float(d["tile"].max()), 1), star["peak_adu"]),
            "gaussian_fwhm_px": (float(d["gaussian_fwhm_px"]),
                                 psf["gaussian_fwhm_px"]),
            "fitted_model_fwhm_px": (round(fwhm(d["fitted"]), 3),
                                     psf["fitted_model_fwhm_px"]),
        }

    _figure_data("ingest", figure_data_path(out, "psf_comparison"), {
        **{k: (STAMP, STAMP) for k in ("gauss", "survey", "fitted", "diff")},
        **{k: (8, 8) for k in ("tile", "recon", "resid", "sigma")},
        "loc": (2,), "idx": (), "gaussian_fwhm_px": ()}, recomputed)


def phase_ingest(dev, m71_share):
    """The M71 data front from the survey's bytes to a posterior, in a
    temporary directory: (a) ``make_fixture`` (default seed), (b)
    ``prepare_data --no-download`` with the fit on the card, held to the
    committed fixture by ``data_prep.compare``, (c) ``sky_exactness`` and
    (d) ``psf_comparison`` (m71, the regenerated psField and tiles, the
    committed ``params.yaml``) held to their committed JSONs, (e) the
    align, (f) ``[m71]``'s cut on the port's tiles and fitted parameters:
    K2 and no K1 or K3 in the counters, the count share at least
    ``M71_REFERENCE_COUNT_SHARE``. Returns the launches of (f) and the
    align's time."""
    import yaml

    from smcdet_tpu_torch.config import load_config
    from smcdet_tpu_torch.data_prep import compare, make_fixture, prepare_data
    from smcdet_tpu_torch.studies import psf_comparison, sky_exactness_probe

    committed = Path("experiments/m71/data/m71")
    results = Path("docs/results/m71")
    fails = []
    with tempfile.TemporaryDirectory() as tmp:
        start = time.perf_counter()
        fx = make_fixture.make_fixture(tmp, device=dev)
        print(f"[ingest] (a) make_fixture: {fx['stars']} stars, the render "
              f"{fx['render_s']:.3f} s on the card, {fx['wall_s']:.3f} s "
              f"of wall with the frames")
        info = prepare_data.prepare(tmp, download=False, device=dev)
        fit = info["fit"]
        print(f"[ingest] (b) prepare_data: {info['wall_s']:.3f} s of wall; "
              f"the fit on {dev}: {info['fit_steps']} L-BFGS steps in "
              f"{info['fit_s']:.3f} s, loss {fit.final_loss:.6f}; "
              f"{info['kept']} tiles kept")
        got = Path(tmp) / "m71"
        fails += compare.hold_npz(got / "tiles.npz", committed / "tiles.npz",
                                  "tiles.npz", exact_images=False)
        zpt = (got / "hubble_ngc6838.zpt").read_bytes() == (
            committed / "hubble_ngc6838.zpt").read_bytes()
        print(f"[ingest] hubble_ngc6838.zpt byte-equal: {zpt}")
        fails += [] if zpt else ["hubble_ngc6838.zpt differs"]
        want = yaml.safe_load((committed / "params.yaml").read_text())
        fails += compare.hold_params(
            info["params"], want, fit.final_loss,
            compare.patch_loss(tmp, want, dev), "params.yaml")
        sky = sky_exactness_probe.sky_exactness(tmp)
        same = json.dumps(sky, indent=2) + "\n" == (
            results / "sky_exactness.json").read_text()
        print(f"[ingest] (c) sky_exactness equal to the committed JSON: "
              f"{same} (max abs err {sky['max_abs_err_electrons']:.6g} e-)")
        fails += [] if same else ["sky_exactness.json differs"]
        psf_out = Path(tmp) / "psf_comparison"
        report = _quiet(psf_comparison.main, [
            "--config", "config.yaml", "--data-root", tmp, "--output-dir",
            str(psf_out), "--device", str(dev)])
        print("[ingest] (d) psf_comparison m71:")
        fails += compare.hold_psf_comparison(
            report, json.loads((results / "psf_comparison.json")
                               .read_text()), "m71")
        _psf_figure_data(psf_out / "m71", report)
        align_ms = _ingest_align(dev, tmp)
        print(f"[time] ingest (a)-(e) in {time.perf_counter() - start:.1f} s")

        raw = yaml.safe_load(Path("experiments/m71/config.yaml").read_text())
        raw.update(data_path=str(got / "tiles.npz"),
                   params_path=str(got / "params.yaml"),
                   num_images=8, batch_size=8, output_dir=f"{tmp}/out")
        (Path(tmp) / "config.yaml").write_text(yaml.safe_dump(raw))
        cfg = load_config(Path(tmp) / "config.yaml")
        assert cfg.image_model.psf_params == tuple(
            info["params"]["psf_params"]), cfg.image_model
        launches, res, levels, _ = _aggregation_batch(dev, cfg,
                                                      "ingest m71")
        assert launches["K2"] > 0 and launches["K1"] == launches["K3"] == 0, (
            launches)
        truth = np.load(got / "tiles.npz")["true_counts"][:8]
        share = _count_share("ingest m71", res, truth)
        print(f"[ingest] (f) the m71 cut on the port's tiles and fit: count "
              f"share {share} ([m71] on the committed parameters "
              f"{m71_share}; JAX reference {M71_REFERENCE_COUNT_SHARE})")
        assert share >= M71_REFERENCE_COUNT_SHARE - 1e-9
    assert not fails, fails
    return launches, align_ms


# ----------------------------------------------------------------------
# [anchor]: the SMC-versus-MCMC anchor (studies/compare_mcmc.py) at a cut
# ----------------------------------------------------------------------
# images, reps, sweeps, burn-in, thin: printed beside the committed
# figures, not held to them
ANCHOR_CUT = (16, 2, 400, 200, 2)
# the committed anchor's images and reps (K1's 800 x 1 launch), burn-in
# and thin
ANCHOR_FULL = (200, 4, 30000, 2)
# the RJ sweep's wall a sweep is read at these chain counts
ANCHOR_RJ_CHAINS = (32, 800)
ANCHOR_RJ_SWEEPS = 50


def _anchor_chain_shape(dev, label, imgs, prior, model, chain, nb, k, peaks):
    """K1 at the anchor's launch shape (one chain a tile of ``imgs``, N =
    1) from the empty start moved 200 sweeps: ``launch_agreement`` with
    the plain version pooled over ``MCMC_AGREEMENT_KEYS`` keys (each
    launch's zero-count passthrough held, the pool >= 0.99), then the
    burn-in (``nb`` sweeps) and block (``k``) launches timed beside their
    bounds. Returns the two launch records."""
    from smcdet_tpu_torch.inference.mcmc import init_chain, with_iters
    from smcdet_tpu_torch.ops import mh_sweep

    assert mh_sweep.sweep_kernel(prior, model, prior.max_objects) == "K1"
    run, plain = mh_sweep.mh_sweeps, mh_sweep.mh_sweeps_reference
    gen = torch.Generator(device=dev).manual_seed(21)
    ctx, counts, state = init_chain(gen, imgs, prior, model, chain)
    state, _ = with_iters(chain, 200).run_from_state(gen, ctx, counts, state)
    block = _chain_args(None, chain, ctx, counts, state, k)
    shares = [launch_agreement(run, plain, [torch.tensor(
        [4242 + i, 2424], dtype=torch.int64, device=dev)] + block[1:],
        bar=0.0)[0] for i in range(MCMC_AGREEMENT_KEYS)]
    agree = float(np.mean(shares))
    print(f"[anchor] K1 at {label} ({counts.shape[0]} chains x 1): zero-count "
          f"passthrough bit-exact; launch_agreement over "
          f"{MCMC_AGREEMENT_KEYS} keys {agree:.6f} (lowest "
          f"{min(shares):.6f})")
    assert agree >= 0.99, shares
    return _chain_launch_records("K1", f"anchor {label}", run, plain, chain,
                                 ctx, counts, state, nb, k, False, peaks)


def _mcmc_figure_data(out, report, n):
    from smcdet_tpu_torch.figures import MCMC_STATS, figure_data_path

    def recomputed(d):
        return {
            "count_pmf_tvd.mean": (round(float(d["tvd"].mean()), 4),
                                   report["count_pmf_tvd"]["mean"]),
            "rjmh.count_pmf_tvd_mean": (round(float(d["rj_tvd"].mean()), 4),
                                        report["rjmh"]["count_pmf_tvd_mean"]),
            "well_mixed_chains.n": (int(d["mixed"].sum()),
                                    report["well_mixed_chains"]["n"]),
            "mcmc_samples": (int(d["num_samples"]), report["mcmc_samples"]),
        }

    _figure_data("anchor", figure_data_path(out, "mcmc_comparison"),
                 {**{k: (n,) for k in MCMC_STATS}, "num_samples": ()},
                 recomputed)


def phase_anchor(dev, peaks):
    """``[anchor]``: ``studies/compare_mcmc`` at the cut ``ANCHOR_CUT`` on
    the JAX package's m71synthetic tiles, after the port's CS-SMC on those
    images (every tile-level run at temperature 1): its launches counted
    from 0 (K1 once for the burn-in and once a kept sample, the RJ sweep
    plain), every chain finite and in its support, the acceptances in
    [0, 1], its report printed beside the committed figures (not held);
    K1 at the CS-SMC's launch shape and at the anchor's (the cut's chains,
    and the committed anchor's 800 x 1 with its 30,000-sweep burn-in)
    against its plain version and its bound; the RJ sweep's wall a sweep at
    ``ANCHOR_RJ_CHAINS``. Returns (the K1 launches of the CS-SMC and of the
    anchor, the launch records)."""
    from smcdet_tpu_torch.inference.mcmc import MCMCConfig, num_kept
    from smcdet_tpu_torch.run_experiment import load_suite_config
    from smcdet_tpu_torch.runner import mcmc_chain, run_experiment
    from smcdet_tpu_torch.studies import compare_mcmc

    n, reps, total, burnin, thin = ANCHOR_CUT
    committed = json.loads(Path(
        "docs/results/m71synthetic/mcmc_comparison.json").read_text())
    cfg = load_suite_config("experiments/m71synthetic")
    prior, model, kernel = _built(cfg, dev)
    chain, _ = mcmc_chain(cfg, kernel, dev)
    with np.load("tests/data/m71synthetic_tiles.npz") as t:
        images = torch.as_tensor(t["images"][:ANCHOR_FULL[0]],
                                 dtype=torch.float32, device=dev)
    launches, records = {}, {}
    key = torch.tensor([97531, 86420], dtype=torch.int64, device=dev)
    problem = _study_inputs(dev, prior, model, images[:1].cpu().numpy(),
                            None, cfg.sampler.num_catalogs, 0)
    records["smc"] = time_launch(
        "m71synthetic image", "K1",
        _sweep_args(key, kernel, *problem, cfg.kernel.num_iters), peaks,
        label="anchor")
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "output"
        _stage_suite_tiles(out, "m71synthetic")
        cfg.output_dir, cfg.num_images, cfg.batch_size = str(out), n, n
        _, smc = _m71_studies_run(
            f"m71synthetic CS-SMC on {n} images",
            lambda: run_experiment(cfg, device=dev, verbose=False),
            tag="anchor")
        assert smc["K1"] > 0 and sum(smc.values()) == smc["K1"], smc
        launches["smc"] = smc["K1"]

        kept = {}
        saved = compare_mcmc.run_anchors

        def keep(*args, **kwargs):
            kept["runs"], kept["walls"] = saved(*args, **kwargs)
            return kept["runs"], kept["walls"]

        compare_mcmc.run_anchors = keep
        try:
            got, run = _m71_studies_run(
                f"compare_mcmc {n} images x {reps} reps x {total} sweeps",
                lambda: _quiet(compare_mcmc.main, [
                    "--num-images", str(n), "--reps", str(reps),
                    "--num-samples", str(total), "--burnin", str(burnin),
                    "--thin", str(thin), "--output-dir", str(out),
                    "--device", "cuda"]), smc=False, tag="anchor")
        finally:
            compare_mcmc.run_anchors = saved
        _mcmc_figure_data(out / "m71synthetic", got, n)
    K = num_kept(MCMCConfig(total, burnin, thin))
    assert run["K1"] == 1 + K and sum(run.values()) == run["K1"], run
    launches["anchor"] = run["K1"]
    M = prior.max_objects
    for name, (counts, fluxes, acc) in kept["runs"].items():
        assert counts.shape == (n, reps * K), (name, counts.shape)
        assert fluxes.shape == (n, reps * K, M), (name, fluxes.shape)
        assert ((counts >= 0) & (counts <= M)).all(), name
        assert np.isfinite(fluxes).all() and (fluxes >= 0).all(), name
        assert np.isfinite(acc).all() and ((acc >= 0) & (acc <= 1)).all(), (
            name, acc)
    walls = kept["walls"]
    print(f"[anchor] {n * reps} chains x {total} sweeps ({burnin} burn-in, "
          f"{K} kept, every {thin}): MH {walls['mh']:.3f} s, RJ "
          f"{walls['rj']:.3f} s; every chain finite, acceptance in [0, 1]")
    for path in (("count_pmf_tvd", "mean"), ("count_pmf_tvd", "p90"),
                 ("well_mixed_chains", "n"),
                 ("mean_count_agreement", "mean_abs_diff"),
                 ("median_total_flux_mean_abs_rel_diff",),
                 ("mcmc_acc_rate_range",), ("rjmh", "count_pmf_tvd_mean"),
                 ("rjmh", "mean_count_mean_abs_diff")):
        a, b = got, committed
        for k in path:
            a, b = a[k], b[k]
        print(f"[anchor] cut {'.'.join(path)}: {a} (committed at 200 x 4 x "
              f"50,000, not held: {b})")

    sub = compare_mcmc.stack_reps(images[:n], reps)
    records["cut"] = _anchor_chain_shape(dev, "the cut", sub, prior, model,
                                         chain, burnin, thin, peaks)
    N_img, N_reps, nb, k = ANCHOR_FULL
    full = compare_mcmc.stack_reps(images[:N_img], N_reps)
    records["full"] = _anchor_chain_shape(dev, "the committed anchor", full,
                                          prior, model, chain, nb, k, peaks)
    for chains in ANCHOR_RJ_CHAINS:
        ms = compare_mcmc.rj_sweep_ms(images, prior, model, chain, chains,
                                      sweeps=ANCHOR_RJ_SWEEPS, warm=10)
        print(f"[anchor] RJ sweep (birth/death, plain) at {chains} chains: "
              f"{ms:.3f} ms a sweep ({ANCHOR_RJ_SWEEPS} sweeps after 10)")
    return launches, records


# ----------------------------------------------------------------------
# [parallel]: two job processes of run_experiment.py --distributed
# ----------------------------------------------------------------------
# divideandconquer cut to this many images, at batch size 1
PARALLEL_IMAGES = 4
PARALLEL_TIMEOUT_S = 600


def _parallel_config(tmp, name):
    cfg = _suite_config("divideandconquer")
    cfg.num_images, cfg.batch_size = PARALLEL_IMAGES, 1
    cfg.output_dir = f"{tmp}/{name}"
    return cfg


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _batches_differ(a_dir, b_dir):
    """``{batch file: [(array, share of its elements that differ)]}`` for
    every array but the run times that is not equal between the batch
    files of two run directories."""
    differ = {}
    for q in sorted(Path(a_dir).glob("smc_batch*.npz")):
        with np.load(q) as a, np.load(Path(b_dir) / q.name) as b:
            bad = [(key, float(np.mean(a[key] != b[key])))
                   for key in a.files if not key.startswith("runtime")
                   and not np.array_equal(a[key], b[key])]
        if bad:
            differ[q.name] = bad
    return differ


def _parallel_mismatch(tmp, ref, out, differ):
    """The job processes' batches differ from this process's run: print
    which, run the single-process reference again in a fresh process and
    say which of the three runs it equals, then fail the phase."""
    from smcdet_tpu_torch.config import save_config

    print(f"[parallel] MISMATCH job processes against this process's run: "
          f"{differ}")
    fresh = _parallel_config(tmp, "fresh")
    save_config(fresh, f"{tmp}/fresh.yaml")
    proc = subprocess.run(
        [sys.executable, "-m", "smcdet_tpu_torch.run_experiment",
         f"{tmp}/fresh.yaml", "--device", "cuda"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=PARALLEL_TIMEOUT_S)
    if proc.returncode != 0:
        print(proc.stdout[-4000:])
    else:
        again = Path(fresh.output_dir) / fresh.name
        print(f"[parallel] a fresh single process against this process's "
              f"run: {_batches_differ(ref, again) or 'equal'}; against the "
              f"job processes: {_batches_differ(out, again) or 'equal'}")
    raise AssertionError(f"[parallel] job processes differ from the "
                         f"single-process run: {differ}")


def phase_parallel(dev):
    """``[parallel]``: the divideandconquer cut (``PARALLEL_IMAGES`` images,
    batch size 1) through ``run_experiment`` in this process (launches
    counted; every tile-level run and every bridge level at temperature 1),
    then through two job processes of ``python -m
    smcdet_tpu_torch.run_experiment --distributed`` (gloo over localhost,
    both on ``cuda:0``): each exits 0, their batch files are disjoint and
    their union is the single-process run's, each file is finite with
    weights summing to 1 and equal, array for array, to the single-process
    run's (so at temperature 1 as it is; on a mismatch
    ``_parallel_mismatch`` runs the reference again in a fresh process,
    says which run it equals, and fails). Then ``SMCSampler.run(devices=
    [cuda:0])`` bit-equal to ``devices=None`` on one image,
    ``select_device()`` the card, and ``describe_devices()``. Returns the
    K1 and K3 launches (K3's by bridge level) and the sampler's K1
    launches."""
    import os

    from smcdet_tpu_torch.config import save_config
    from smcdet_tpu_torch.inference.aggregate import expand_prior
    from smcdet_tpu_torch.inference.smc import SMCSampler
    from smcdet_tpu_torch.runner import load_results
    from smcdet_tpu_torch.utils.devices import describe_devices, select_device

    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        single = _parallel_config(tmp, "single")
        with _SMCResults() as kept:
            run, res, levels, _ = _aggregation_batch(dev, single, "parallel")
        runs, tiles = kept.check("parallel")
        temps = [t for image in levels for _, ts, _ in image
                 for t in np.ravel(ts)]
        assert min(temps) == 1.0, temps
        launches["K1"], launches["K3"] = run["K1"], run["K3"]
        # one K3 launch a bridge iteration
        launches["bridge levels"] = [
            sum(lv[k][0] for lv in levels if len(lv) > k)
            for k in range(max(len(lv) for lv in levels))]
        assert sum(launches["bridge levels"]) == run["K3"], (levels, run)
        print(f"[parallel] single process: {runs} SMC runs over {tiles} "
              f"tiles and {len(temps)} merged tiles, all at temperature 1")

        jobs = _parallel_config(tmp, "jobs")
        save_config(jobs, f"{tmp}/config.yaml")
        port = _free_port()
        procs = []
        for rank in range(2):
            env = dict(os.environ, MASTER_ADDR="localhost",
                       MASTER_PORT=str(port), WORLD_SIZE="2", RANK=str(rank),
                       PYTHONPATH=os.getcwd())
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "smcdet_tpu_torch.run_experiment",
                 f"{tmp}/config.yaml", "--distributed", "--device", "cuda"],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        start = time.perf_counter()
        try:
            logs = [p.communicate(timeout=PARALLEL_TIMEOUT_S)[0]
                    for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - start
        for rank, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                print(log[-4000:])
            assert p.returncode == 0, f"job process {rank}: {p.returncode}"
        out = Path(jobs.output_dir) / jobs.name
        by_job = {rank: {b["batch"] for b in json.loads(
            (out / f"smc_manifest_job{rank}.json").read_text())["batches"]}
            for rank in range(2)}
        ref = Path(single.output_dir) / single.name
        assert not by_job[0] & by_job[1], by_job
        assert by_job[0] | by_job[1] == set(range(PARALLEL_IMAGES)), by_job
        assert (sorted(q.name for q in out.glob("smc_batch*.npz"))
                == sorted(q.name for q in ref.glob("smc_batch*.npz")))
        for q in sorted(out.glob("smc_batch*.npz")):
            with np.load(q) as b:
                assert np.isfinite(b["log_normalizing_constant"].max(-1)
                                   ).all(), q.name
                np.testing.assert_allclose(b["weights"].sum(-1), 1.0,
                                           atol=1e-5)
        differ = _batches_differ(ref, out)
        if differ:
            _parallel_mismatch(tmp, ref, out, differ)
        got = load_results(out)
        print(f"[parallel] two job processes (--distributed, gloo, both on "
              f"cuda:0) in {wall:.3f} s: batches {by_job}, disjoint, their "
              f"union the single-process run's; {len(got['image_index'])} "
              f"images, every array equal to the single-process run's")

    cfg = _suite_config("divideandconquer")
    prior, model, kernel = _built(cfg, dev)
    td = cfg.sampler.tile_dim
    with np.load("tests/data/divideandconquer_tiles.npz") as t:
        image = t["images"][0]
    sampler = SMCSampler(image, td, expand_prior(prior, td, td,
                                                 prior.max_objects),
                         model.with_shape(td, td), kernel,
                         num_catalogs=cfg.sampler.num_catalogs,
                         max_smc_iters=cfg.sampler.max_smc_iters)
    _reset_launches()
    outs = [sampler.run(torch.Generator(device=dev).manual_seed(8),
                        devices=d) for d in (None, [torch.device("cuda", 0)])]
    sampler_launches = _launches()
    for f in outs[0]._fields:
        a, b = getattr(outs[0], f), getattr(outs[1], f)
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b), f
    assert sampler_launches["K1"] > 0, sampler_launches
    launches["sampler K1"] = sampler_launches["K1"]
    print(f"[parallel] SMCSampler.run(devices=[cuda:0]) bit-equal to "
          f"devices=None ({outs[0].temperature.numel()} tiles, "
          f"{sampler_launches['K1']} K1 launches in both runs)")
    assert select_device() == torch.device("cuda", 0), select_device()
    print(f"[parallel] select_device() = {select_device()}")
    print("[parallel] describe_devices():")
    for line in describe_devices().splitlines():
        print(f"[parallel]   {line}")
    return launches


# [dnc4]: the divideandconquer suite on 32x32 images, a 4x4 grid of 8x8
# tiles (smcdet_tpu_torch/studies/dnc_grid.py derives its configs), on the
# JAX package's draw of its images (tests/torch_dnc4_tiles.py)
DNC4_DIM = 32
DNC4_TILES = "tests/data/divideandconquer32_tiles.npz"
DNC4_IMAGES = 2  # through the tree under MH
DNC4_MALA_IMAGES = 1
# through the single tile, cut to DNC4_SINGLE_ITERS SMC iterations: at
# the config's 100 it reaches temperature 0.039 on the first image in 96 s
# (N = 8192 x 33 strata re-rendered every iteration; PERF.md), so no run
# within this script's time reaches 1
DNC4_SINGLE_IMAGES = 1
DNC4_SINGLE_ITERS = 3
# the single tile's launch is held to its plain version on its first groups
DNC4_SINGLE_GROUPS = 2
# the shape off the path: a 24x24 tile with 20 slots, 256 particles a
# stratum on one tile (the bridge: 2 groups of 256)
DNC4_OFF_PATH = ((24, 24), 20, 256)
# particles a group of the 800-sweep equilibria on the bridge (K3g, K4g)
DNC4_EQ_PARTICLES = 256


def _dnc4_levels(label, levels, images):
    """Per image the four levels' bridge iterations, every merged tile at
    temperature 1; returns the bridge launches of each level over the
    images (one a bridge iteration)."""
    assert len(levels) == images, levels
    for i, lv in enumerate(levels):
        assert len(lv) == 4, lv
        print(f"[{label}] image {i}: bridge iterations per level "
              f"{[it for it, _, _ in lv]}, last acceptance "
              f"{[round(acc, 4) for _, _, acc in lv]}")
        assert all(all(x == 1.0 for x in np.ravel(temp))
                   for _, temp, _ in lv), lv
    return [sum(lv[k][0] for lv in levels) for k in range(4)]


def _dnc4_agree(path, name, args, child=None):
    """``launch_agreement`` of kernel ``name`` with its plain version at a
    launch off the path (no timing); returns ``{"agreement",
    "max_abs_err"}``."""
    run, plain, _ = _sweep_route(name, args, child)
    share, err = launch_agreement(run, plain, args, child)
    G, N = args[6].shape
    print(f"[dnc4] {name} {path} ({G} groups x {N}, {args[3].height}x"
          f"{args[3].width}, M={args[8].shape[-1]}): zero-count particles "
          f"pass through bit-exactly, {share:.6f} of particles agree after "
          f"20 same-stream sweeps (pll/lp max abs err {err:.3e})")
    return {"agreement": share, "max_abs_err": err}


def _dnc4_off_path(dev, mh, mala):
    """K2g, K3g and K4g (tile and bridge) held against their plain versions
    at a shape no path runs: ``DNC4_OFF_PATH``'s 24x24 tile with 20 slots,
    from prior catalogs, the bridge with random origin tags and a split at
    row 12."""
    from smcdet_tpu_torch.inference.aggregate import SideMask, expand_prior
    from smcdet_tpu_torch.inference.kernels import (
        TargetContext,
        init_kernel_state,
    )

    (h, w), M, N = DNC4_OFF_PATH
    _, tprior, tmodel, _, _ = _dnc_problem(dev)
    prior, model = expand_prior(tprior, h, w, M), tmodel.with_shape(h, w)
    key = torch.tensor([24024, 20], dtype=torch.int64, device=dev)
    ctx, counts, state = _kernel_inputs(dev, prior, model, 1, N, 3)
    records = {}
    for name, kernel in (("K2g", mh), ("K4g", mala)):
        records[f"{name} tile"] = _dnc4_agree(
            "off-path 24x24 tile", name,
            _sweep_args(key, kernel, ctx, counts, state, kernel.num_iters))
    g = torch.Generator(device=dev).manual_seed(4)
    counts = torch.randint(0, M + 1, (1, 2, N), generator=g, device=dev,
                           dtype=torch.int32)
    locs, fluxes = prior.sample_marks(g, counts, (1, 2, N))
    tags = (torch.rand((1, 2, N, M), generator=g, device=dev) < 0.5).float()
    ctx = TargetContext(prior, model, ctx.image[:1].expand(1, 2, 1, h, w),
                        torch.full((1, 2, 1), 0.5, device=dev),
                        child_model=model,
                        child_side_mask=SideMask(0, h // 2, h, w),
                        child_slot_side=tags)
    state = init_kernel_state(ctx, counts, locs, fluxes)
    for name, kernel in (("K3g", mh), ("K4g", mala)):
        records[f"{name} bridge"] = _dnc4_agree(
            "off-path 24x24 bridge", name,
            _sweep_args(key, kernel, ctx, counts, state, kernel.num_iters),
            _flat_child(ctx, counts, state))
    return records


def _singletile_figure_data(out, report):
    from smcdet_tpu_torch.figures import figure_data_path
    from smcdet_tpu_torch.studies import tvd_stats

    def recomputed(d):
        diff = np.abs(d["mean_dc"] - d["mean_st"])
        return {"count_pmf_tvd": (tvd_stats(d["tvd"]),
                                  report["count_pmf_tvd"]),
                "mean_count.mean_abs_diff": (round(float(diff.mean()), 4),
                                             report["mean_count"][
                                                 "mean_abs_diff"])}

    n = report["images"]
    _figure_data("dnc4", figure_data_path(out, "singletile_comparison"),
                 {"mean_dc": (n,), "mean_st": (n,), "tvd": (n,)}, recomputed)


def phase_dnc4(dev, peaks):
    """The divideandconquer suite on 32x32 images through ``run_experiment``
    with the configs ``studies/dnc_grid.py`` derives: ``DNC4_IMAGES`` of the
    JAX package's images through the tree under MH (K1 on the 16 tiles, K3
    at levels 0-1, K3g at levels 2-3: 32x16 with 64 slots, 32x32 with 128),
    ``DNC4_MALA_IMAGES`` under MALA (K4, then K4g at levels 2-3), and
    ``DNC4_SINGLE_IMAGES`` of them through the single 32x32 tile (K2g, 32
    slots, N = 8192) cut to ``DNC4_SINGLE_ITERS`` SMC iterations,
    then ``compare_singletile`` on the images both ran. Every tree level and
    tile at temperature 1, finite log Z, weights summing to 1. Then each
    new kernel against its plain version at each launch shape of the path
    (its first launch there, captured; ``time_launch``: the zero-count
    passthrough bit for bit, >= 99% agreement after 20 sweeps, time beside
    the bound), K4g also at the single tile's first groups under MALA (no
    path runs it: the MH run's state), at the shape off the path
    (``launch_agreement`` alone), and K3g and K4g over 800 sweeps at level
    2 (q50/q75 and acceptance against the plain version, the caches against
    a fresh render).
    (The profile of a tree image is ``tests/torch_synthetic_suites.py
    --dnc4``'s, which has the time.) Returns the launches of the runs, the
    records of the kernels line and the ``[paths]`` rows."""
    from smcdet_tpu_torch.run_experiment import load_suite_config
    from smcdet_tpu_torch.studies import compare_singletile
    from smcdet_tpu_torch.studies.dnc_grid import derived_configs

    key = torch.tensor([32032, 4444], dtype=torch.int64, device=dev)
    launches, records, paths, first = {}, {}, [], {}
    mark = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cfgs = derived_configs(f"{tmp}/configs", DNC4_DIM, output_dir=tmp,
                               mala_steps=MALA_DNC_STEPS)
        with np.load(DNC4_TILES) as t:
            tiles = {k: t[k][:DNC4_IMAGES] for k in t.files}
        truth = tiles["true_counts"]
        staged = Path(tmp) / "divideandconquer" / "tiles.npz"
        staged.parent.mkdir()
        np.savez(staged, **tiles)
        for name, path in cfgs.items():
            cfg = load_suite_config(str(path))
            print(f"[dnc4] {name} config: {cfg.image_model.image_height}x"
                  f"{cfg.image_model.image_width} images, tile "
                  f"{cfg.sampler.tile_dim}, N {cfg.sampler.num_catalogs}, "
                  f"max_objects {cfg.prior.max_objects}, kernel "
                  f"{cfg.kernel.kind}")

        def batch(name, images, label, capture):
            cfg = load_suite_config(str(cfgs[name]))
            cfg.num_images = cfg.batch_size = images
            start = time.perf_counter()
            out = _aggregation_batch(dev, cfg, label, capture)
            print(f"[{label}] {images} image(s) in "
                  f"{time.perf_counter() - start:.1f} s")
            return out

        mh_first, mala_first = {}, {}
        run, res, levels, _ = batch("dnc", DNC4_IMAGES, "dnc4", mh_first)
        per_level = _dnc4_levels("dnc4", levels, DNC4_IMAGES)
        assert run["K1"] > 0 and run["K3"] > 0 and run["K3g"] > 0, run
        assert run["K3"] == sum(per_level[:2]), (run, per_level)
        assert run["K3g"] == sum(per_level[2:]), (run, per_level)
        _count_share("dnc4", res, truth)
        launches["MH"], paths_mh = run, per_level

        run, res, levels, _ = batch("mala", DNC4_MALA_IMAGES, "dnc4 mala",
                                    mala_first)
        mala_level = _dnc4_levels("dnc4 mala", levels, DNC4_MALA_IMAGES)
        assert run["K4 tile"] > 0 and run["K4g bridge"] > 0, run
        assert run["K4 bridge"] == sum(mala_level[:2]), (run, mala_level)
        assert run["K4g bridge"] == sum(mala_level[2:]), (run, mala_level)
        assert run["K1"] + run["K3"] + run["K3g"] == 0, run
        _count_share("dnc4 mala", res, truth[:DNC4_MALA_IMAGES])
        launches["MALA"] = run

        cfg = load_suite_config(str(cfgs["singletile"]))
        cfg.batch_size = DNC4_SINGLE_IMAGES
        cfg.sampler.max_smc_iters = DNC4_SINGLE_ITERS
        start = time.perf_counter()
        _, run, res = _entry_batch(dev, cfg, "dnc4 single tile", tmp, first,
                                   tempered=False)
        print(f"[dnc4 single tile] {DNC4_SINGLE_IMAGES} image(s) in "
              f"{time.perf_counter() - start:.1f} s")
        assert run["K2g"] > 0 and sum(run.values()) == run["K2g"], run
        _count_share("dnc4 single tile", res, truth[:DNC4_SINGLE_IMAGES])
        launches["single"] = run
        report = _quiet(compare_singletile.main, ["--config",
                                                  str(cfgs["dnc"])])
        print(f"[dnc4] compare_singletile over {report['images']} image(s), "
              f"the single tile at temperature "
              f"{res['temperature'].ravel().tolist()} after "
              f"{DNC4_SINGLE_ITERS} SMC iterations: {json.dumps(report)}")
        assert report["images"] == DNC4_SINGLE_IMAGES
        _singletile_figure_data(Path(tmp) / "divideandconquer", report)

    print(f"[dnc4] runs in {time.perf_counter() - mark:.1f} s")
    # the new kernels at the path's launch shapes, against plain
    mark = time.perf_counter()

    def args_of(capture, kind, bridge, h, w, M, cut=None):
        kernel, ctx, counts, state = capture[(kind, bridge, h, w, M)]
        args = _sweep_args(key, kernel, ctx, counts, state, kernel.num_iters)
        child = _flat_child(ctx, counts, state)
        if cut is not None:
            args, child = _groups(args, child, cut)
        return args, child

    mala = mala_first[("mala", False, 8, 8, 8)][0]
    levels_shape = [(16, 8, 16), (16, 16, 32), (32, 16, 64), (32, 32, 128)]
    for i, (h, w, M) in enumerate(levels_shape):
        name = "K3" if i < 2 else "K3g"
        args, child = args_of(mh_first, "mh", True, h, w, M)
        rec = time_launch(f"dnc4 bridge level {i}", name, args, peaks, child,
                          label="dnc4", check=i >= 2)
        records[f"{name} level {i}"] = rec
        paths.append((name, f"dnc4 bridge level {i}", paths_mh[i], rec))
        name = "K4" if i < 2 else "K4g"
        path = f"dnc4 bridge level {i} under MALA"
        if ("mala", True, h, w, M) not in mala_first:
            # the MALA run's bridge reached temperature 1 in its first step
            # here and launched nothing: MALA at the MH run's first launch
            mala_first[("mala", True, h, w, M)] = (
                mala, *mh_first[("mh", True, h, w, M)][1:])
            path += " (at the MH run's state: no MALA launch there)"
        args, child = args_of(mala_first, "mala", True, h, w, M)
        rec = time_launch(path, name, args, peaks, child, label="dnc4",
                          check=i >= 2)
        records[f"{name} level {i}"] = rec
        paths.append((name, f"dnc4 bridge level {i} under MALA",
                      mala_level[i], rec))
    args, _ = args_of(mh_first, "mh", False, 8, 8, 8)
    rec = time_launch("dnc4 tiles", "K1", args, peaks, label="dnc4",
                      check=False)
    paths.append(("K1", "dnc4 tiles", launches["MH"]["K1"], rec))
    args, _ = args_of(mala_first, "mala", False, 8, 8, 8)
    rec = time_launch("dnc4 tiles under MALA", "K4", args, peaks,
                      label="dnc4", check=False)
    paths.append(("K4", "dnc4 tiles under MALA", launches["MALA"]["K4 tile"],
                  rec))
    args, _ = args_of(first, "mh", False, 32, 32, 32)
    rec = time_launch("dnc4 single tile", "K2g", args, peaks, label="dnc4",
                      check=False)
    paths.append(("K2g", "dnc4 single tile", launches["single"]["K2g"], rec))
    args, _ = args_of(first, "mh", False, 32, 32, 32, DNC4_SINGLE_GROUPS)
    records["K2g single tile"] = time_launch(
        f"dnc4 single tile's first {DNC4_SINGLE_GROUPS} groups", "K2g",
        args, peaks, label="dnc4")
    kernel, ctx, counts, state = first[("mh", False, 32, 32, 32)]
    records["K4g tile"] = time_launch(
        f"single tile's first {DNC4_SINGLE_GROUPS} groups under MALA (off "
        f"the path)", "K4g",
        _groups(_sweep_args(key, mala, ctx, counts, state, mala.num_iters),
                None, DNC4_SINGLE_GROUPS)[0], peaks, label="dnc4")
    records.update({f"off-path {k}": v for k, v in _dnc4_off_path(
        dev, kernel, mala).items()})
    print(f"[dnc4] kernel checks in {time.perf_counter() - mark:.1f} s")
    mark = time.perf_counter()

    # 800 sweeps at level 2 on K3g's and K4g's first particles; K4g's
    # caches held within 1e-6 of a fresh render (K3g's were 6.1e-7)
    for name, capture, kind, tol in (("K3g", mh_first, "mh", 2e-3),
                                     ("K4g", mala_first, "mala", 1e-6)):
        kernel, ctx, counts, state = capture[(kind, True, 32, 16, 64)]
        _equilibrium(dev, f"dnc4 {name} level 2", kernel,
                     *_first_particles(ctx, counts, state, DNC4_EQ_PARTICLES),
                     cache_tol=tol)
        print(f"[dnc4] {name} equilibrium in "
              f"{time.perf_counter() - mark:.1f} s")
        mark = time.perf_counter()
    return launches, records, paths


def _quiet(main, argv):
    """A study's ``main(argv)`` with its printed report swallowed (the
    phase prints its own line); returns what ``main`` returns."""
    import contextlib
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        return main(argv)


def _built(cfg, dev):
    """The prior, image model and mutation kernel of config ``cfg``."""
    from smcdet_tpu_torch.config import (
        build_image_model,
        build_kernel,
        build_prior,
    )

    return (build_prior(cfg.prior, dev), build_image_model(cfg.image_model,
                                                           dev),
            build_kernel(cfg.kernel, dev))


def print_paths(paths):
    """``paths``: ``(kernel, path, launches, record)``. Per path, the
    kernel's launches in this run, its launch shape, its time and bound
    there and launches x (time - bound); then the kernels ranked by the sum
    of that over their paths."""
    totals = {}
    for kid, path, n, rec in paths:
        if rec["ms"] is None:
            print(f"[paths] {kid} {path}: {n} launches at {rec['shape']}: "
                  f"unranked (the trace missed the kernel), bound "
                  f"{rec['bound_ms']:.4g} ms")
            continue
        gap = n * (rec["ms"] - rec["bound_ms"]) / 1e3
        totals[kid] = totals.get(kid, 0.0) + gap
        print(f"[paths] {kid} {path}: {n} launches at {rec['shape']}: "
              f"{rec['ms']:.3f} ms, bound {rec['bound_ms']:.4g} ms (at K5's "
              f"rates {rec['measured_bound_ms']:.4g} ms); launches x (time "
              f"- bound) {gap:.3f} s")
    ranking = sorted(totals.items(), key=lambda kv: -kv[1])
    print("[paths] kernels by launches x (time - bound): "
          + ", ".join(f"{k} {v:.3f} s" for k, v in ranking))


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

    workers = _Workers(SEED_WORKERS)
    eq_workers = _Workers(EQ_WORKERS)
    try:
        with tempfile.TemporaryDirectory() as eq_dir:
            _DEFERRED["dir"] = eq_dir
            _phases(smi, dev, workers, eq_workers)
    finally:
        workers.close()
        eq_workers.close()


def _phases(smi, dev, workers, eq_workers):
    """Phases 2-32 (the module's docstring), then the paths, the kernels
    line and the device line."""
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
    shapes = phase_launch_shapes(dev, levels, peaks)
    del levels
    quick, _ = phase_main_path(dev)
    launches["K1"] = quick
    work = tempfile.TemporaryDirectory()
    k2_entry, mh_basic, scored = phase_entry_point(dev, work.name)
    k2_pair, scored["cells_pair"] = phase_pair(dev, work.name,
                                               scored["cells"])
    k2_entry.update(k2_pair)
    launches["K4"] = mala_basic = phase_mala_entry(dev, mh_basic)
    eq_jobs = [eq_workers.submit(path, label, kind="equilibrium")
               for path, label in _DEFERRED["jobs"]]
    eq_start = time.perf_counter()
    dnc, m71, m71_share = phase_aggregation(dev, workers)
    launches["K1"] += dnc["K1"] + m71["K1"]
    launches["K2"] = sum(k2_entry.values()) + dnc["K2"] + m71["K2"]
    launches["K3"] = dnc["K3"] + m71["K3"]
    mala_dnc = phase_mala_dnc(dev, workers)
    launches["K4"] += mala_dnc["K4 tile"] + mala_dnc["K4 bridge"]
    mark = time.perf_counter()
    print(f"[time] dnc and mala dnc in {mark - eq_start:.1f} s")
    for job in eq_jobs:
        eq_workers.result(job)
    print(f"[time] K1-K4's {len(eq_jobs)} equilibria in {EQ_WORKERS} "
          f"workers: {time.perf_counter() - eq_start:.1f} s, "
          f"{time.perf_counter() - mark:.1f} s of it waited for after "
          f"[mala dnc]")
    phase_profile(dev)
    phase_profile_pair(dev, work.name)
    # the cells_pair batch ran on the cells batch's tiles
    tiles = {name: scored[name] / "tiles.npz" for name in ("basic", "cells")}
    tiles["cells_pair"] = tiles["cells"]
    phase_score(dev, scored, tiles)
    work.cleanup()
    mark = time.perf_counter()
    print(f"[time] phases 2-16 in {mark - start:.1f} s")
    mcmc, mcmc_records, _ = phase_mcmc(dev, peaks)
    launches["K1"] += mcmc["K1"]
    launches["K2"] += mcmc["K2"]
    launches["K4"] += mcmc["K4"]
    print(f"[time] mcmc in {time.perf_counter() - mark:.1f} s")
    for name, phase in (("profile", phase_mcmc_profile), ("rjmh", phase_rjmh),
                        ("tdsmc", phase_tdsmc), ("sep", phase_sep)):
        mark = time.perf_counter()
        phase(dev)
        print(f"[time] {name} in {time.perf_counter() - mark:.1f} s")
    mark = time.perf_counter()
    sqjd, sqjd_records = phase_sqjd(dev, peaks)
    for k in ("K1", "K2", "K3"):
        launches[k] += sqjd[k]
    launches["K4"] += sqjd["K4 tile"] + sqjd["K4 bridge"]
    print(f"[time] sqjd in {time.perf_counter() - mark:.1f} s")
    mark = time.perf_counter()
    history = phase_history(dev)
    launches["K1"] += history
    print(f"[time] history in {time.perf_counter() - mark:.1f} s")
    mark = time.perf_counter()
    phase_fit(dev)
    print(f"[time] fit in {time.perf_counter() - mark:.1f} s")
    mark = time.perf_counter()
    m71ss = phase_m71ss(dev, workers)
    launches["K2"] += m71ss["K2"]
    print(f"[time] m71ss in {time.perf_counter() - mark:.1f} s")
    mark = time.perf_counter()
    bench_shapes = phase_bench_shapes(dev, peaks)
    bench, chunked = phase_bench(dev)
    launches["K1"] += sum(bench.values())
    print(f"[time] bench in {time.perf_counter() - mark:.1f} s")
    mark = time.perf_counter()
    stream = phase_stream(dev, chunked)
    launches["K1"] += sum(stream.values())
    stream_entry = phase_stream_entry(dev)
    launches["K1"] += stream_entry["sampler"]
    launches["K2"] += stream_entry["basic"]
    print(f"[time] stream in {time.perf_counter() - mark:.1f} s")
    mark = time.perf_counter()
    singletile, studies = phase_studies(dev, peaks)
    launches["K1"] += studies["pooled D&C tiles"]
    launches["K2"] += (studies["compare_kernels MH"] + studies["single-tile"]
                       + studies["pooled single-tile"])
    launches["K3"] += sum(studies["pooled D&C bridge levels"])
    launches["K4"] += studies["compare_kernels MALA"]
    print(f"[time] studies in {time.perf_counter() - mark:.1f} s")
    mark = time.perf_counter()
    m71_shapes, m71s = phase_m71studies(dev, peaks)
    launches["K1"] += m71s["oracle"] + m71s["repeated"] + m71s["split MH"]
    launches["K2"] += (sum(v for k, v in m71s.items()
                           if k.startswith("crowded"))
                       + m71s["suites"] + m71s["simulator"])
    print(f"[time] m71studies in {time.perf_counter() - mark:.1f} s")
    mark = time.perf_counter()
    ingest, _ = phase_ingest(dev, m71_share)
    launches["K2"] += ingest["K2"]
    print(f"[time] ingest in {time.perf_counter() - mark:.1f} s")
    mark = time.perf_counter()
    anchor, anchor_records = phase_anchor(dev, peaks)
    launches["K1"] += anchor["smc"] + anchor["anchor"]
    print(f"[time] anchor in {time.perf_counter() - mark:.1f} s")
    mark = time.perf_counter()
    parallel = phase_parallel(dev)
    launches["K1"] += parallel["K1"] + parallel["sampler K1"]
    launches["K3"] += parallel["K3"]
    print(f"[time] parallel in {time.perf_counter() - mark:.1f} s")
    mark = time.perf_counter()
    dnc4, dnc4_records, dnc4_paths = phase_dnc4(dev, peaks)
    for run in dnc4.values():
        for kid in ("K1", "K3", "K2g", "K3g"):
            launches[kid] = launches.get(kid, 0) + run[kid]
        launches["K4"] += run["K4 tile"] + run["K4 bridge"]
        launches["K4g"] = (launches.get("K4g", 0) + run["K4g tile"]
                           + run["K4g bridge"])
    print(f"[time] dnc4 in {time.perf_counter() - mark:.1f} s")
    print(f"[done] phases 2-32 in {time.perf_counter() - start:.1f} s on "
          f"{smi}")
    k2 = dict(records["K2 cells"])
    k2["max_abs_err"] = max(k2["max_abs_err"],
                            records["K2 basic"]["max_abs_err"], branch_err)
    for target, rec in k4.items():
        print(f"[done] K4 {target} ({rec['shape']}): {rec['ms']:.3f} ms vs "
              f"plain {rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.4f} "
              f"ms (at K5's rates {rec['measured_bound_ms']:.4f} ms)")
    records["K4"] = dict(k4["basic"])
    records["K4"]["max_abs_err"] = max(r["max_abs_err"] for r in k4.values())
    k3_levels = records["K3"]["levels"]
    print_paths([
        ("K1", "quick cell", quick, records["K1"]),
        ("K1", "divideandconquer tiles", dnc["K1"], shapes["dnc tile K1"]),
        ("K2", "basic", k2_entry["basic"], records["K2 basic"]),
        ("K2", "cells", k2_entry["cells"], shapes["cells batch K2"]),
        ("K2", "cells_pair", k2_entry["cells_pair"], shapes["cells batch K2"]),
        ("K2", "basic with moves", k2_entry["basic with moves"],
         records["K2 basic"]),
        ("K2", "m71 fixture", m71["K2"], shapes["m71 tile K2"]),
        *[("K3", f"divideandconquer bridge level {i}", n, k3_levels[i])
          for i, n in enumerate(dnc["bridge levels"])],
        ("K4", "basic under MALA", mala_basic, k4["basic"]),
        ("K4", "divideandconquer tiles under MALA", mala_dnc["K4 tile"],
         shapes["dnc tile K4"]),
        *[("K4", f"divideandconquer bridge level {i} under MALA", n,
           shapes[f"dnc bridge level {i} K4"])
          for i, n in enumerate(mala_dnc["bridge levels"])],
        *[path for label, _, _, kid in MCMC_CHAINS for path in (
            (kid, f"{label} MCMC burn-in", 1,
             mcmc_records[label]["burn-in"]),
            (kid, f"{label} MCMC blocks", mcmc_records[label]["launches"] - 1,
             mcmc_records[label]["block"]))],
        *[(kid, f"{label} early stop ({SQJD_TOL})", rec["launches"], rec)
          for kid, label in (("K1", "quick cell"), ("K2", "basic"),
                             ("K4", "basic under MALA"))
          for rec in (sqjd_records[label],)],
        ("K1", "quick cell on the ladder", history, records["K1"]),
        ("K2", "m71semisynthetic cut", m71ss["K2"], shapes["m71 tile K2"]),
        ("K1", "bench quick", bench["quick"], bench_shapes["quick"]),
        ("K1", "bench full frame (chunk 14)", bench["full frame"],
         bench_shapes["chunk 14"]),
        ("K1", "stream quick (pool 16)", stream["quick"],
         bench_shapes["quick"]),
        ("K1", "stream full frame (pool 28)", stream["full frame"],
         bench_shapes["pool 28"]),
        ("K2", "basic with sampler.streaming", stream_entry["basic"],
         records["K2 basic"]),
        ("K1", "SMCSampler.run(streaming=True)", stream_entry["sampler"],
         bench_shapes["quick"]),
        ("K2", "compare_kernels MH", studies["compare_kernels MH"],
         records["K2 basic"]),
        ("K4", "compare_kernels MALA", studies["compare_kernels MALA"],
         k4["basic"]),
        ("K2", "single-tile run", studies["single-tile"],
         singletile["single-tile"]),
        ("K2", "compare_pooled single-tile", studies["pooled single-tile"],
         singletile["pooled single-tile"]),
        ("K1", "compare_pooled D&C tiles", studies["pooled D&C tiles"],
         shapes["dnc tile K1"]),
        *[("K3", f"compare_pooled D&C bridge level {i}", n, k3_levels[i])
          for i, n in enumerate(studies["pooled D&C bridge levels"])],
        ("K2", "m71studies crowded base arm",
         m71s["crowded base_n2048_s100"], shapes["m71 tile K2"]),
        ("K2", "m71studies crowded hiN arm", m71s["crowded hiN_n8192_s100"],
         m71_shapes["crowded hiN arm"]),
        ("K2", "m71studies crowded hiS arm", m71s["crowded hiS_n2048_s200"],
         m71_shapes["crowded hiS arm"]),
        ("K1", "m71studies oracle run", m71s["oracle"],
         m71_shapes["oracle tile"]),
        ("K2", "m71studies scored suites", m71s["suites"],
         shapes["m71 tile K2"]),
        ("K2", "m71studies simulator_checks", m71s["simulator"],
         m71_shapes["simulator_checks tile"]),
        ("K1", "m71studies repeated_runs cut", m71s["repeated"],
         m71_shapes["repeated_runs cut"]),
        ("K1", "m71studies split_mode MH burn-in", 1,
         mcmc_records["m71synthetic"]["burn-in"]),
        ("K1", "m71studies split_mode MH blocks", m71s["split MH"] - 1,
         mcmc_records["m71synthetic"]["block"]),
        ("K2", "ingest m71 cut (the port's tiles and fit)", ingest["K2"],
         shapes["m71 tile K2"]),
        ("K1", "anchor's m71synthetic CS-SMC", anchor["smc"],
         anchor_records["smc"]),
        ("K1", "anchor cut MCMC burn-in", 1,
         anchor_records["cut"]["burn-in"]),
        ("K1", "anchor cut MCMC blocks", anchor["anchor"] - 1,
         anchor_records["cut"]["block"]),
        ("K1", "parallel divideandconquer tiles", parallel["K1"],
         shapes["dnc tile K1"]),
        *[("K3", f"parallel divideandconquer bridge level {i}", n,
           k3_levels[i]) for i, n in enumerate(parallel["bridge levels"])],
        ("K1", "SMCSampler.run(devices=[cuda:0])", parallel["sampler K1"],
         shapes["dnc tile K1"]),
        *dnc4_paths,
    ])
    print("[paths] not ranked: the committed anchor's 800 x 1 launches "
          "(timed in [anchor], its 30,000-sweep burn-in and 10,000 blocks "
          "not run here)")
    print("[paths] not ranked: the full frame at the memory "
          "model's largest chunk ("
          + ", ".join(f"{k}: {v} K1 launches" for k, v in bench.items()
                      if k not in ("quick", "full frame"))
          + "), launch shapes not timed; repeated_runs at its committed "
          "size (timed in [m71studies], not run here)")
    print("[done] the kernels line: K2's record at the cells shapes, K3's "
          "at one divideandconquer image's level-0 launch, K4's at the basic "
          "shapes; K2g's at the 32x32 single tile's first "
          f"{DNC4_SINGLE_GROUPS} groups, K3g's and K4g's at one 32x32 "
          "image's level-3 launch (max_abs_err: the largest over [dnc4]'s "
          "checks; K4g's time at level 2 and at the single tile's first "
          "groups under MALA in [dnc4]'s lines)")
    for name in ("K2g", "K3g", "K4g"):
        records[name] = dict(
            dnc4_records["K2g single tile" if name == "K2g"
                         else f"{name} level 3"],
            max_abs_err=max(r["max_abs_err"] for k, r in dnc4_records.items()
                            if k.startswith((name, f"off-path {name}"))
                            and "max_abs_err" in r))
    print(json.dumps({"kernels": [
        _record("mh_sweep", "K1", launches["K1"], records["K1"]),
        _record("mh_sweep_k2", "K2", launches["K2"], k2),
        _record("mh_sweep_k3", "K3", launches["K3"], records["K3"]),
        _record("mala_sweep_k4", "K4", launches["K4"], records["K4"]),
        _record("chain_k5", "K5", launches["K5"], records["K5"]),
        _record("mh_sweep_k2g", "K2g", launches["K2g"], records["K2g"]),
        _record("mh_sweep_k3g", "K3g", launches["K3g"], records["K3g"]),
        _record("mala_sweep_k4g", "K4g", launches["K4g"], records["K4g"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    if sys.argv[1:] == ["--worker"]:
        _worker()
    else:
        main()
