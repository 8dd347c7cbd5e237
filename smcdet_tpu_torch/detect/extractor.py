"""The source-extractor baseline (port of ``smcdet_tpu/detect/extractor.py``):
thresholding, 8-connected component labelling, steepest-ascent basin
deblending, centroid and flux measurement, and a sigma-clipped mesh
background, batched over images as ``[B, H, W]`` tensors.

The semantics are the JAX package's, which stand in for ``sep.extract``:
pixels above ``thresh * err`` are segmented, components smaller than
``minarea`` dropped, components split at interior local maxima whose peak
reaches ``deblend_cont`` times the component peak, and ``clean_param`` is a
significance cut ``flux >= clean_param * err * area``. Positions are
(row + 0.5, col + 0.5) centroids, sources sorted by decreasing flux (a
stable sort: ties keep the lower id, as JAX's ``argsort``). Every threshold
is formed in float32 from float32 operands, as under ``jax.jit``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = [
    "estimate_background",
    "extract",
    "extract_batch",
    "tune_extractor",
]

# labelling sweeps between two host checks for a fixed point (each check
# is a device sync; extra sweeps past the fixed point change nothing)
LABEL_CHECK_EVERY = 8


def _f32(v, device):
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _neighbor_stack(x, pad_value):
    """``[B, H, W] -> [B, 9, H, W]``: the 8-neighbourhood (and self) of
    every pixel, ``pad_value`` outside the image, in JAX's (dy, dx)
    order."""
    B, H, W = x.shape
    p = F.pad(x[:, None], (1, 1, 1, 1), value=pad_value)[:, 0]
    return torch.stack([p[:, dy:dy + H, dx:dx + W]
                        for dy in range(3) for dx in range(3)], dim=1)


def _label_components(mask):
    """8-connected component labels by min-propagation: int64 ``[B, H,
    W]``, the linear index of each component's smallest pixel, ``H*W`` on
    the background. Runs to the fixed point, checked every
    ``LABEL_CHECK_EVERY`` sweeps; a path inside a component is at most
    ``H*W`` pixels long, which bounds the sweeps."""
    B, H, W = mask.shape
    big = H * W
    idx = torch.arange(H * W, device=mask.device).reshape(1, H, W)
    labels = torch.where(mask, idx, big)
    for _ in range(0, H * W + 1, LABEL_CHECK_EVERY):
        before = labels
        for _ in range(LABEL_CHECK_EVERY):
            nmin = _neighbor_stack(labels, big).min(1).values
            labels = torch.where(mask, torch.minimum(labels, nmin), big)
        if torch.equal(labels, before):
            break
    return labels


def _basin_ascent(values, mask):
    """Steepest-ascent basin of each pixel: int64 ``[B, H, W]``, the
    linear index of the local maximum reached by moving to the largest
    neighbour (self included; ties to the smallest linear index), by
    eight pointer-jumping steps."""
    B, H, W = values.shape
    P = H * W
    neg = float("-inf")
    vals = torch.where(mask, values, neg)
    idx = torch.arange(P, device=values.device).reshape(1, H, W).expand(
        B, H, W)
    stacked_v = _neighbor_stack(vals, neg)
    stacked_i = _neighbor_stack(idx, P)
    order = stacked_v * P * 2 - stacked_i.to(torch.float32)
    best = order.argmax(1)  # the first of equal maxima, as JAX's argmax
    parent = torch.gather(stacked_i, 1, best[:, None])[:, 0]
    parent = torch.where(mask, parent, idx).reshape(B, P)
    for _ in range(8):
        parent = torch.gather(parent, 1, parent)
    return parent.reshape(B, H, W)


def _scatter(op, size, index, src, init):
    out = torch.full((index.shape[0], size), init, dtype=src.dtype,
                     device=src.device)
    if op == "sum":
        return out.scatter_add_(1, index, src)
    return out.scatter_reduce_(1, index, src, op, include_self=True)


def extract_batch(images, thresh, err=1.0, minarea=3, deblend_cont=0.005,
                  clean_param=0.0, max_detections: int = 32):
    """Detect sources in background-subtracted images ``[B, H, W]``.

    Returns ``(counts [B] int32, locs [B, max_detections, 2], fluxes [B,
    max_detections])``, the sources of each image sorted by decreasing flux
    and zero past its count."""
    images = torch.as_tensor(images, dtype=torch.float32)
    dev = images.device
    B, H, W = images.shape
    P = H * W
    err = _f32(err, dev)
    mask = images > _f32(thresh, dev) * err
    labels = _label_components(mask)
    lab = labels.clamp(max=P - 1).reshape(B, P)

    flat_labels = torch.where(mask, labels, P).reshape(B, P)
    area = _scatter("sum", P + 1, flat_labels,
                    mask.reshape(B, P).to(torch.float32), 0.0)[:, :P]
    big_enough = area >= _f32(minarea, dev)
    keep_px = mask & torch.gather(big_enough, 1, lab).reshape(B, H, W)

    # deblend: split components at interior local maxima whose peak
    # reaches deblend_cont times the component peak
    basins = _basin_ascent(images, keep_px).reshape(B, P)
    flat_img = images.reshape(B, P)
    peak_val = torch.gather(flat_img, 1, basins)
    keep_flat = keep_px.reshape(B, P)
    keep_labels = torch.where(keep_flat, labels.reshape(B, P), P)
    comp_peak = _scatter("amax", P + 1, keep_labels,
                         torch.where(keep_flat, flat_img, float("-inf")),
                         0.0)[:, :P]
    comp_peak_px = torch.gather(comp_peak, 1, lab)
    significant = peak_val >= _f32(deblend_cont, dev) * comp_peak_px
    # an insignificant basin joins the component's main basin: its peak
    # pixel, the smallest index among exact-max ties (comp_peak is a max of
    # these very values, so the equality is exact)
    idx = torch.arange(P, device=dev).expand(B, P)
    at_peak = keep_flat & (flat_img == comp_peak_px)
    comp_main = _scatter("amin", P + 1, keep_labels,
                         torch.where(at_peak, idx, P), P)[:, :P]
    main_px = torch.gather(comp_main, 1, lab)
    source_id = torch.where(keep_flat,
                            torch.where(significant, basins, main_px), P)

    # measurements per source id
    vals = torch.where(keep_flat, flat_img, 0.0)
    yy = ((torch.arange(H, device=dev)[:, None] + 0.5)
          * torch.ones((1, W), device=dev)).reshape(P)
    xx = (torch.ones((H, 1), device=dev)
          * (torch.arange(W, device=dev)[None, :] + 0.5)).reshape(P)
    flux = _scatter("sum", P + 1, source_id, vals, 0.0)[:, :P]
    wy = _scatter("sum", P + 1, source_id, vals * yy, 0.0)[:, :P]
    wx = _scatter("sum", P + 1, source_id, vals * xx, 0.0)[:, :P]
    src_area = _scatter("sum", P + 1, source_id,
                        keep_flat.to(torch.float32), 0.0)[:, :P]

    is_source = src_area > 0
    if clean_param is not None:
        is_source = is_source & (
            flux >= _f32(clean_param, dev) * err * src_area)

    # top max_detections by flux into fixed slots
    score = torch.where(is_source, flux, float("-inf"))
    top = torch.argsort(-score, dim=1, stable=True)[:, :max_detections]
    top_ok = torch.gather(is_source, 1, top)
    counts = top_ok.sum(-1).to(torch.int32)
    top_flux = torch.gather(flux, 1, top)
    safe_flux = torch.clamp(top_flux, min=1e-30)
    locs = torch.stack([torch.gather(wy, 1, top) / safe_flux,
                        torch.gather(wx, 1, top) / safe_flux], dim=-1)
    locs = torch.where(top_ok[..., None], locs, 0.0)
    fluxes = torch.where(top_ok, top_flux, 0.0)
    return counts, locs, fluxes


def extract(image, thresh, err=1.0, minarea=3, deblend_cont=0.005,
            clean_param=0.0, max_detections: int = 32):
    """``extract_batch`` of one image ``[H, W]``: ``(count, locs
    [max_detections, 2], fluxes [max_detections])``."""
    counts, locs, fluxes = extract_batch(
        torch.as_tensor(image, dtype=torch.float32)[None], thresh, err,
        minarea, deblend_cont, clean_param, max_detections)
    return counts[0], locs[0], fluxes[0]


def estimate_background(image, box_size: int = 16, n_sigma_iters: int = 5):
    """Sigma-clipped mesh background (the ``sep.Background`` analogue) of
    one image ``[H, W]``: each ``box_size`` mesh is 3-sigma clipped
    ``n_sigma_iters`` times, and the mesh means and rms are bilinearly
    interpolated back to the pixels. Returns ``(background, rms)``."""
    image = torch.as_tensor(image, dtype=torch.float32)
    dev = image.device
    H, W = image.shape
    bh, bw = H // box_size, W // box_size
    boxes = image[: bh * box_size, : bw * box_size].reshape(
        bh, box_size, bw, box_size).permute(0, 2, 1, 3).reshape(bh, bw, -1)

    def stats(mask):
        n = torch.clamp(mask.sum(-1), min=1.0)
        mean = (boxes * mask).sum(-1) / n
        var = (((boxes - mean[..., None]) ** 2) * mask).sum(-1) / n
        return mean, var

    mask = torch.ones_like(boxes)
    for _ in range(n_sigma_iters):
        mean, var = stats(mask)
        sd = torch.sqrt(var)
        mask = ((boxes - mean[..., None]).abs()
                <= 3.0 * sd[..., None] + 1e-12).to(torch.float32)
    mesh_mean, mesh_var = stats(mask)
    mesh_rms = torch.sqrt(mesh_var)

    # bilinear interpolation of the mesh values back to the pixels
    ys = (torch.arange(H, device=dev) + 0.5) / box_size - 0.5
    xs = (torch.arange(W, device=dev) + 0.5) / box_size - 0.5
    y0 = torch.floor(ys).to(torch.int64).clamp(0, bh - 1)
    x0 = torch.floor(xs).to(torch.int64).clamp(0, bw - 1)
    y1 = (y0 + 1).clamp(0, bh - 1)
    x1 = (x0 + 1).clamp(0, bw - 1)
    fy = (ys - y0).clamp(0.0, 1.0)[:, None]
    fx = (xs - x0).clamp(0.0, 1.0)[None, :]

    def interp(mesh):
        v00 = mesh[y0[:, None], x0[None, :]]
        v01 = mesh[y0[:, None], x1[None, :]]
        v10 = mesh[y1[:, None], x0[None, :]]
        v11 = mesh[y1[:, None], x1[None, :]]
        return (v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx
                + v10 * fy * (1 - fx) + v11 * fy * fx)

    return interp(mesh_mean), interp(mesh_rms)


def tune_extractor(images, true_counts, true_locs, true_fluxes, background,
                   err, adu_per_nmgy, mag_bins, thresh_grid, minarea_grid,
                   deblend_cont_grid, clean_param_grid, locs_tol=0.5,
                   mags_tol=0.5, max_detections: int = 32):
    """F1 grid search over the extractor's hyperparameters on tuning tiles
    (the reference ``run_sep.py``'s): each grid point runs the extractor on
    every tile, matches its one catalog per tile to the truth, and the best
    ``(thresh, minarea, deblend_cont, clean_param)`` by the last magnitude
    bin's F1 wins (the first of equal scores, in grid order). The JAX
    version takes a key, which draws nothing here: one catalog per tile
    leaves one choice. Everything runs on ``images``' device. Returns
    ``(best_f1, params)``."""
    from smcdet_tpu_torch.metrics import (
        compute_precision_recall_f1,
        match_catalogs,
    )

    images = torch.as_tensor(images, dtype=torch.float32)
    dev = images.device
    T = images.shape[0]
    true_counts, true_locs, true_fluxes = (
        torch.as_tensor(a, device=dev)
        for a in (true_counts, true_locs, true_fluxes))
    sub = images - _f32(background, dev)
    one = torch.zeros((T, 1), dtype=torch.int64, device=dev)

    def score_point(thresh, minarea, deblend_cont, clean_param):
        counts, locs, fluxes = extract_batch(
            sub, thresh=thresh, err=err, minarea=minarea,
            deblend_cont=deblend_cont, clean_param=clean_param,
            max_detections=max_detections)
        mc = match_catalogs(
            true_counts, true_locs, true_fluxes, counts[:, None],
            locs[:, None], fluxes[:, None] / _f32(adu_per_nmgy, dev),
            num_est_catalogs_to_match=1, locs_tol=locs_tol,
            mags_tol=mags_tol, mag_bins=mag_bins, indices=one)
        _, _, f1 = compute_precision_recall_f1(mc)
        return float(f1[0, -1])

    best = (-1.0, None)
    for thresh in thresh_grid:
        for minarea in minarea_grid:
            for deblend_cont in deblend_cont_grid:
                for clean_param in clean_param_grid:
                    score = score_point(thresh, minarea, deblend_cont,
                                        clean_param)
                    if score > best[0]:
                        best = (score, dict(
                            thresh=float(thresh), minarea=int(minarea),
                            deblend_cont=float(deblend_cont),
                            clean_param=float(clean_param)))
    return best
