"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (a failing phase raises; there is no CPU fallback):

1. device: the card's name and power limit (nvidia-smi), CUDA and nvcc
   versions; exits non-zero without a CUDA card;
2. build: compiles the kernels from ``smcdet_tpu_torch/csrc`` into
   ``build/``;
3. kernel against plain: K1 (the fused MH sweep loop) against its plain
   PyTorch version on the card at the main path's shapes (16 8x8 tiles,
   M = 6, C = 7, N = 2048): zero-count passthrough, particle-by-particle
   agreement over 20 sweeps on the shared Philox stream and the time of
   100 sweeps of both; then equilibrium statistics over 800 sweeps on
   two tiles;
4. main path: the M71 quick cell (16 tiles from ``generate_images`` with
   seed 7, N = 2048, 100 sweeps per SMC iteration, systematic resampling,
   ESS 0.5) through ``run_csmc_chunked(sort_tiles=True)``, with every
   mutate call counted against the kernel's launch counter.

The last two lines of standard output are the kernels' JSON record and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# Share of the 16 quick-cell tiles whose posterior mean pruned count lies
# within +-1 of the true pruned count for the JAX reference
# (smcdet_tpu run_csmc_chunked, sort_tiles=True) run on CPU on the same
# tiles with the same configuration: 16/16 with seeds 0 and 1 (PERF.md).
REFERENCE_COUNT_SHARE = 1.0

TILE = 8
KERNEL_SOURCE = "smcdet_tpu_torch/csrc/mh_sweep.cu"
KERNEL_REPLACES = "smcdet_tpu/ops/pallas_sweep.py:178"


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


def phase_build():
    from smcdet_tpu_torch import _build

    info = _build.build()
    print(f"[build] {info['path']} in {info['seconds']:.1f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")
    _build.load_library()


def _kernel_inputs(dev, prior, model, num_tiles, N, seed):
    """Flattened K1 inputs for ``num_tiles`` tiles of the test_pallas
    target: prior catalogs, an image rendered from the last stratum's
    first catalog, temperature 0.8."""
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


def phase_kernel(dev, prior, model, kernel):
    from smcdet_tpu_torch.inference.kernels import (
        SingleComponentMH,
        init_kernel_state,
    )
    from smcdet_tpu_torch.ops import mh_sweep

    N = 2048

    def with_iters(n, backend):
        return SingleComponentMH(num_iters=n, locs_stdev=kernel.locs_stdev,
                                 fluxes_stdev=kernel.fluxes_stdev,
                                 fluxes_min=kernel.fluxes_min,
                                 fluxes_max=kernel.fluxes_max,
                                 backend=backend, device=dev)

    # the main path's shapes: 16 tiles x 7 strata x 2048 particles
    ctx, counts, state = _kernel_inputs(dev, prior, model, 16, N, 0)

    # zero-count passthrough is bit-exact and accepts nothing
    zc = torch.zeros_like(counts)
    zstate = init_kernel_state(ctx, zc, state.locs, state.fluxes)
    out, acc = with_iters(20, "auto").run_from_state(
        torch.Generator(device=dev).manual_seed(1), ctx, zc, zstate)
    torch.cuda.synchronize()
    for a, b in zip(out, zstate):
        assert torch.equal(a, b), "zero-count passthrough changed the state"
    assert float(acc.max()) == 0.0
    print("[kernel] zero-count passthrough: bit-exact, acc 0")

    # same key, 20 sweeps: particle-by-particle agreement
    res = {}
    for backend in ("auto", "torch"):
        res[backend], _ = with_iters(20, backend).run_from_state(
            torch.Generator(device=dev).manual_seed(2), ctx, counts, state)
    torch.cuda.synchronize()
    agree = torch.ones(counts.shape, dtype=torch.bool, device=dev)
    for a, b in zip(res["auto"], res["torch"]):
        close = torch.isclose(a, b, rtol=1e-4, atol=1e-4)
        agree &= close.reshape(counts.shape + (-1,)).all(-1)
    share = float(agree.float().mean())
    # pll and lp of the agreeing particles (the per-particle scalars)
    pairs = [(a[agree], b[agree]) for a, b in zip(res["auto"], res["torch"])
             if a.shape == counts.shape]
    max_abs_err = max(float((a - b).abs().max()) for a, b in pairs)
    max_rel_err = max(float(((a - b).abs() / b.abs().clamp(min=1.0)).max())
                      for a, b in pairs)
    print(f"[kernel] 20 sweeps, same stream: {share:.6f} of particles agree "
          f"to rtol 1e-4 (the rest are accept flips); on those, pll/lp max "
          f"abs err {max_abs_err:.3e}, max rel err {max_rel_err:.3e}")
    assert share >= 0.99, share

    # time of 100 sweeps on the same inputs
    G = counts.numel() // N
    HW = model.height * model.width
    key = torch.tensor([12345, 67890], dtype=torch.int64, device=dev)
    args = (
        key, kernel.proposal(prior), prior, model,
        ctx.image.expand(16, prior.num_counts, 1, TILE, TILE)
        .reshape(G, HW).contiguous(),
        torch.full((G,), 0.8, device=dev),
        counts.reshape(G, N).to(torch.int32).contiguous(),
        state.locs.reshape(G, N, -1, 2).contiguous(),
        state.fluxes.reshape(G, N, -1).contiguous(),
        state.rate.reshape(G, N, HW).contiguous(),
        state.parent_ll.reshape(G, N).contiguous(),
        state.logprior.reshape(G, N).contiguous(),
        100,
    )
    ms = _time_ms(lambda: mh_sweep.mh_sweeps(*args), reps=5)
    plain_ms = _time_ms(lambda: mh_sweep.mh_sweeps_reference(*args), reps=1)
    updates = G * N * 100
    print(f"[kernel] 100 sweeps, {G} groups x {N} particles: kernel "
          f"{ms:.3f} ms ({updates / (ms * 1e-3):.4e} updates/s), plain "
          f"{plain_ms:.3f} ms ({updates / (plain_ms * 1e-3):.4e} updates/s)")

    # 800 sweeps, different streams: equilibrium statistics, on two tiles
    # (the size and bounds of tests/test_pallas.py:107-154)
    ctx, counts, state = _kernel_inputs(dev, prior, model, 2, N, 0)
    stk, acck = with_iters(800, "auto").run_from_state(
        torch.Generator(device=dev).manual_seed(5), ctx, counts, state)
    stp, accp = with_iters(800, "torch").run_from_state(
        torch.Generator(device=dev).manual_seed(6), ctx, counts, state)
    torch.cuda.synchronize()
    ltk = (stk.logprior + 0.8 * stk.parent_ll).flatten().cpu().numpy()
    ltp = (stp.logprior + 0.8 * stp.parent_ll).flatten().cpu().numpy()
    for q in (50, 75):
        a, b = np.percentile(ltp, q), np.percentile(ltk, q)
        print(f"[kernel] 800 sweeps q{q}: plain {a:.3f} kernel {b:.3f}")
        assert abs(a - b) <= 0.05 * abs(a) + 5.0, (q, a, b)
    ak, ap = float(acck.mean()), float(accp.mean())
    print(f"[kernel] 800 sweeps acceptance: plain {ap:.5f} kernel {ak:.5f}")
    assert abs(ak - ap) < 0.02
    fresh = init_kernel_state(ctx, counts, stk.locs, stk.fluxes)
    drift = float(((stk.rate - fresh.rate).abs()
                   / fresh.rate.abs().clamp(min=1.0)).max())
    lp_err = float((stk.logprior - fresh.logprior).abs().max())
    print(f"[kernel] rate cache vs fresh render: max rel {drift:.3e}; "
          f"logprior max abs {lp_err:.3e}")
    assert drift < 2e-3 and lp_err < 0.01
    return {"max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms}


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
    mh_sweep.mh_sweeps.launches = 0
    start = time.perf_counter()
    res = run_csmc_chunked(gen, images, prior, model, kernel, cfg,
                           sort_tiles=True)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    launches = mh_sweep.mh_sweeps.launches
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


def main():
    smi = phase_device()
    dev = torch.device("cuda")
    import smcdet_tpu_torch  # noqa: F401  (fails outside the repository)

    start = time.perf_counter()
    phase_build()
    _, prior, model, kernel, _ = build_problem(dev)
    timing = phase_kernel(dev, prior, model, kernel)
    launches = phase_main_path(dev)
    print(f"[done] phases 2-4 in {time.perf_counter() - start:.1f} s on "
          f"{smi}")
    print(json.dumps({"kernels": [{
        "name": "mh_sweep",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches,
        "max_abs_err": timing["max_abs_err"],
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
