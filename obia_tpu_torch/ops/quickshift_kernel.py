"""Quickshift window scans: the hand-written CUDA kernels and their twins.

Two entry points, each with a plain-torch twin of the same signature:

* :func:`quickshift_density` (twin :func:`quickshift_density_reference`),
  which replaces ``obia_tpu/ops/quickshift_pallas.py::_density_kernel``:
  the Parzen density ``1 + sum exp(-d2 / (2 k^2))`` over the (2r+1)^2
  window, self excluded, where
  ``d2 = sum_c (img_c[p] - img_c[q])^2 + dy^2 + dx^2``;
* :func:`quickshift_parent` (twin :func:`quickshift_parent_reference`),
  which replaces ``_parent_kernel``: per pixel, the window neighbour with
  strictly higher ``rho`` and ``d2 <= max_dist^2`` with the least ``d2``,
  ties to the first in row-major (dy, dx) order; returns that ``d2`` (inf
  where there is none) and the linear offset ``dy * W + dx`` (0 there).

Neighbours outside the image and non-finite ``d2`` drop out. ``img`` is the
(C, H, W) float32 image already scaled by the ratio. For a CUDA tensor each
entry point launches its kernel in ``csrc/quickshift.cu`` or raises; for a
CPU tensor it runs its twin. Both sides accumulate in the same row-major
offset order and form ``d2`` in the same operation order, so given the same
``rho`` the parent scans agree bitwise and the densities to the last bits
of ``expf``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

# kernel launches in this process, by kernel; the twins never count
launches = {"qs_density": 0, "qs_parent": 0}

TILE_W = 32                       # tile width: one warp along a row
TILE_HEIGHTS = (16, 8, 4, 2, 1)   # tried in order; the first that fits
SMEM_LIMIT = 232448               # bytes of shared memory a block may use


def window_offsets(radius: int) -> np.ndarray:
    """(n, 2) int32 (dy, dx) of the (2r+1)^2 window in row-major order,
    without (0, 0) (reference ``quickshift._offsets``)."""
    return np.asarray([(dy, dx)
                       for dy in range(-radius, radius + 1)
                       for dx in range(-radius, radius + 1)
                       if not (dy == 0 and dx == 0)], np.int32)


def _f32(x: float) -> float:
    """``x`` rounded once to float32 (the reference's float32 constants)."""
    return float(np.float32(x))


def _fits(planes: int, th: int, radius: int) -> bool:
    """Whether a halo of ``planes`` float32 planes fits in shared memory."""
    return 4 * planes * (th + 2 * radius) * (TILE_W + 2 * radius) \
        <= SMEM_LIMIT


def tile_height(C: int, radius: int, parent: bool) -> int:
    """Tile height for a scan of C channels at this radius: the first of
    ``TILE_HEIGHTS`` whose shared-memory halo (C planes, plus rho for the
    parent scan) fits. Raises ValueError when none does."""
    planes = C + 1 if parent else C
    for th in TILE_HEIGHTS:
        if _fits(planes, th, radius):
            return th
    kind = "parent" if parent else "density"
    raise ValueError(
        f"quickshift {kind} kernel: radius {radius} with {C} channels needs "
        f"a shared-memory halo over {SMEM_LIMIT} bytes even at tile height "
        f"1 (the largest radius for {C} channels is {max_radius(C)})")


def max_radius(C: int) -> int:
    """The largest window radius both kernels take for C channels."""
    r = 0
    while _fits(C + 1, 1, r + 1):
        r += 1
    return r


def _check(img: torch.Tensor) -> Tuple[int, int, int]:
    if img.dim() != 3:
        raise ValueError(f"img: expected (C, H, W), got {tuple(img.shape)}")
    if img.dtype != torch.float32:
        raise TypeError(f"img: dtype {img.dtype}, expected float32")
    if not img.is_contiguous():
        raise ValueError("img must be contiguous")
    return tuple(img.shape)


def _check_radius(radius: int) -> int:
    if int(radius) != radius or radius < 1:
        raise ValueError(f"radius must be a positive integer, got {radius}")
    return int(radius)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def quickshift_density(img: torch.Tensor, radius: int,
                       kernel_size: float) -> torch.Tensor:
    """(H, W) float32 density of the (C, H, W) scaled image."""
    if img.device.type == "cpu":
        return quickshift_density_reference(img, radius, kernel_size)
    if img.device.type != "cuda":
        raise ValueError(f"quickshift_density: unsupported device "
                         f"{img.device}")
    C, H, W = _check(img)
    r = _check_radius(radius)
    th = tile_height(C, r, parent=False)
    rho = torch.empty((H, W), dtype=torch.float32, device=img.device)
    from .. import _build
    lib = _build.load()
    with torch.cuda.device(img.device):
        status = lib.obia_qs_density(
            img.data_ptr(), C, H, W, r, th,
            _f32(1.0 / (2.0 * kernel_size * kernel_size)), rho.data_ptr(),
            _stream(img))
    if status != 0:
        raise RuntimeError(f"quickshift density kernel launch failed: CUDA "
                           f"error {status}")
    launches["qs_density"] += 1
    return rho


def quickshift_parent(img: torch.Tensor, rho: torch.Tensor, radius: int,
                      max_dist: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """((H, W) float32 best d2, (H, W) int32 linear offset) of the parent
    scan over the (C, H, W) scaled image and the noised density."""
    if img.device.type == "cpu":
        return quickshift_parent_reference(img, rho, radius, max_dist)
    if img.device.type != "cuda":
        raise ValueError(f"quickshift_parent: unsupported device "
                         f"{img.device}")
    C, H, W = _check(img)
    if rho.device != img.device:
        raise ValueError(f"rho is on {rho.device}, img on {img.device}")
    if tuple(rho.shape) != (H, W) or rho.dtype != torch.float32 \
            or not rho.is_contiguous():
        raise ValueError(f"rho must be a contiguous float32 {(H, W)} "
                         f"tensor, got {rho.dtype} {tuple(rho.shape)}")
    r = _check_radius(radius)
    th = tile_height(C, r, parent=True)
    best_d2 = torch.empty((H, W), dtype=torch.float32, device=img.device)
    doff = torch.empty((H, W), dtype=torch.int32, device=img.device)
    from .. import _build
    lib = _build.load()
    with torch.cuda.device(img.device):
        status = lib.obia_qs_parent(
            img.data_ptr(), rho.data_ptr(), C, H, W, r, th,
            _f32(max_dist * max_dist), best_d2.data_ptr(), doff.data_ptr(),
            _stream(img))
    if status != 0:
        raise RuntimeError(f"quickshift parent kernel launch failed: CUDA "
                           f"error {status}")
    launches["qs_parent"] += 1
    return best_d2, doff


def _d2(img: torch.Tensor, sh: torch.Tensor, off2: int) -> torch.Tensor:
    """sum_c (img_c - sh_c)^2 + off2, channel by channel in order
    (``_d2_at`` of the Pallas kernels)."""
    t = img[0] - sh[0]
    d2 = t * t
    for c in range(1, img.shape[0]):
        t = img[c] - sh[c]
        d2 = d2 + t * t
    return d2 + float(off2)


def quickshift_density_reference(img: torch.Tensor, radius: int,
                                 kernel_size: float) -> torch.Tensor:
    """Plain-torch twin of the density kernel: one full-raster shifted
    slice of the +inf-padded image per offset, in row-major order."""
    C, H, W = img.shape
    r = _check_radius(radius)
    inv2k2 = _f32(1.0 / (2.0 * kernel_size * kernel_size))
    pad = F.pad(img, (r, r, r, r), value=float("inf"))
    acc = torch.ones((H, W), dtype=torch.float32, device=img.device)
    for dy, dx in window_offsets(r).tolist():
        sh = pad[:, r + dy:r + dy + H, r + dx:r + dx + W]
        d2 = _d2(img, sh, dy * dy + dx * dx)
        acc = acc + torch.where(torch.isfinite(d2), torch.exp(-d2 * inv2k2),
                                0.0)
    return acc


def quickshift_parent_reference(img: torch.Tensor, rho: torch.Tensor,
                                radius: int, max_dist: float
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch twin of the parent kernel: full-raster shifted slices of
    the +inf-padded image and the -inf-padded rho, strict-< updates in
    row-major offset order."""
    C, H, W = img.shape
    r = _check_radius(radius)
    max_d2 = _f32(max_dist * max_dist)
    pad = F.pad(img, (r, r, r, r), value=float("inf"))
    pad_rho = F.pad(rho[None], (r, r, r, r), value=float("-inf"))[0]
    best = torch.full((H, W), float("inf"), dtype=torch.float32,
                      device=img.device)
    doff = torch.zeros((H, W), dtype=torch.int32, device=img.device)
    for dy, dx in window_offsets(r).tolist():
        sh = pad[:, r + dy:r + dy + H, r + dx:r + dx + W]
        d2 = _d2(img, sh, dy * dy + dx * dx)
        nb_rho = pad_rho[r + dy:r + dy + H, r + dx:r + dx + W]
        better = ((nb_rho > rho) & (d2 <= max_d2) & torch.isfinite(d2)
                  & (d2 < best))
        best = torch.where(better, d2, best)
        doff = torch.where(better, dy * W + dx, doff)
    return best, doff
