"""Quickshift mode seeking in torch (port of ``obia_tpu/ops/quickshift.py``).

The two window scans (Parzen density, parent link) are the kernels of
:mod:`obia_tpu_torch.ops.quickshift_kernel`: hand-written CUDA on the card,
their plain twins on the CPU. The tree is flattened by pointer jumping
(``p = p[p]``) for the reference's fixed ``ceil(log2(H*W)) + 1`` rounds, and
the roots are compacted to labels in raster (first-occurrence) order, all
on the image's device.

Semantics follow skimage as the reference does: the image is scaled by
``ratio``; distances are Euclidean in (scaled colour, y, x); the density
kernel is ``exp(-d^2 / (2 kernel_size^2))`` over a window of radius
``ceil(3 kernel_size)``; the parent search uses the same window and cuts
links longer than ``max_dist``; pixels with no higher-density neighbour are
roots. A tiny noise seeded by ``random_seed`` breaks density ties.

The noise (:func:`_tie_noise`) is ``torch.randn`` from a CPU generator, not
the reference's ``jax.random`` threefry, so with the default noise the
labels on density plateaus differ from the reference's; the partition
elsewhere is the same. Tests hold the port to the reference by handing
both the reference's noise.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from .. import telemetry
from ..device import resolve_device
from .quickshift_kernel import quickshift_density, quickshift_parent
from .slic import _compact_first_occurrence


def _tie_noise(seed: int, shape, device) -> torch.Tensor:
    """(H, W) float32 N(0, 1) * 1e-5 from ``torch.Generator`` seeded with
    ``seed``, drawn on the CPU and moved, so every device gets the same
    noise."""
    g = torch.Generator().manual_seed(int(seed))
    return (torch.randn(tuple(shape), generator=g) * 1e-5).to(device)


def quickshift_core(img: torch.Tensor, noise: torch.Tensor,
                    kernel_size: float, max_dist: float, ratio: float,
                    radius: int):
    """(H, W, C) float32 image -> (root (H, W) int64, rho (H, W) float32
    noised density, parent (H, W) int64, dist (H, W) float32 feature-space
    distance to the parent, inf at roots). The reference's
    ``_quickshift_core`` / ``quickshift_core_pallas`` with one radius."""
    H, W, C = img.shape
    scaled = (img * ratio).permute(2, 0, 1).contiguous()
    with telemetry.stage("qs.density"):
        rho = quickshift_density(scaled, radius, kernel_size) + noise
    with telemetry.stage("qs.parent"):
        best_d2, doff = quickshift_parent(scaled, rho, radius, max_dist)
    with telemetry.stage("qs.jump"):
        root, parent = flatten_tree(doff)
    return root, rho, parent, torch.sqrt(best_d2)


def flatten_tree(doff: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(H, W) int32 parent offsets -> ((H, W) int64 roots, (H, W) int64
    parents): ``parent = idx + doff``, then ``p = p[p]`` for the
    reference's fixed ``ceil(log2(H*W)) + 1`` rounds."""
    H, W = doff.shape
    idx = torch.arange(H * W, dtype=torch.int64, device=doff.device)
    parent = idx + doff.reshape(-1).to(torch.int64)
    root = parent
    for _ in range(max(1, int(math.ceil(math.log2(max(H * W, 2)))) + 1)):
        root = root[root]
    return root.view(H, W), parent.view(H, W)


def _as_float_image(image, channel_axis: int, device=None) -> torch.Tensor:
    """(H, W, C) float32 tensor on ``device``: for a tensor, its own device
    when None; for an array, the card when None (``resolve_device``).
    Integer images scale to [0, 1] as skimage's ``img_as_float`` does."""
    if torch.is_tensor(image):
        t = image if device is None else image.to(device)
    else:
        t = torch.from_numpy(np.ascontiguousarray(image)).to(
            resolve_device(device))
    if t.is_floating_point():
        img = t.to(torch.float32)
    else:
        img = t.to(torch.float32) / float(torch.iinfo(t.dtype).max)
    if img.dim() == 2:
        img = img[:, :, None]
    if channel_axis not in (-1, 2):
        img = torch.movedim(img, channel_axis, -1)
    return img


def quickshift_tree(image, ratio: float = 1.0, kernel_size: float = 5.0,
                    max_dist: float = 10.0, sigma: float = 0.0,
                    convert2lab: bool = True, rng=42, random_seed=None,
                    channel_axis: int = -1, device=None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quickshift -> (root, parent, dist), each (H, W): root and parent as
    int64 linear pixel indices (roots point to themselves), dist float32
    (inf at roots). It runs on ``device``; when None, on a tensor's own
    device, and for an array on the card (raising where there is none;
    ``device="cpu"`` asks for the CPU)."""
    img = _as_float_image(image, channel_axis, device)
    if convert2lab and img.shape[-1] == 3:
        from .color import rgb_to_lab
        img = rgb_to_lab(img)
    if sigma and sigma > 0:
        from .filters import gaussian_filter
        img = gaussian_filter(img, float(sigma))
    H, W, _ = img.shape
    seed = random_seed if random_seed is not None else (
        rng if isinstance(rng, (int, np.integer)) else 42)
    noise = _tie_noise(int(seed), (H, W), img.device)
    # the parent search uses the density window, as skimage does (see the
    # reference's quickshift())
    radius = max(1, int(math.ceil(3.0 * kernel_size)))
    root, _, parent, dist = quickshift_core(
        img, noise, float(kernel_size), float(max_dist), float(ratio),
        radius)
    return root, parent, dist


def quickshift(image, ratio: float = 1.0, kernel_size: float = 5.0,
               max_dist: float = 10.0, sigma: float = 0.0,
               convert2lab: bool = True, rng=42, random_seed=None,
               return_tree: bool = False, channel_axis: int = -1,
               device=None):
    """skimage-compatible entry point, on ``device`` as
    :func:`quickshift_tree` places it (an array: the card unless
    ``device="cpu"``). Returns (H, W) int64 labels compacted from 0 in
    raster (first-occurrence) order; with ``return_tree`` also the parent
    linear indices (int64) and the distance to the parent (float32, inf at
    roots)."""
    root, parent, dist = quickshift_tree(
        image, ratio=ratio, kernel_size=kernel_size, max_dist=max_dist,
        sigma=sigma, convert2lab=convert2lab, rng=rng,
        random_seed=random_seed, channel_axis=channel_axis, device=device)
    labels, _ = _compact_first_occurrence(root, root.numel())
    labels = labels.to(torch.int64)
    if return_tree:
        return labels, parent, dist
    return labels
