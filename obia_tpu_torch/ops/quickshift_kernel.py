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

The parent kernel scans only the offsets of the ``max_dist`` disk
(:func:`parent_extents`): ``d2`` is the colour sum (>= 0) plus the exact
``dy^2 + dx^2``, so an offset outside the disk never passes
``d2 <= max_dist^2``. Its halo radius is the disk's, ``rp``, so its tile
shape and radius limit follow ``rp``, the density's follow ``r``
(:func:`tile_shape`, :func:`max_radius`). The twins keep the full window.
"""
from __future__ import annotations

import ctypes
import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import telemetry

STRIP = 5                         # pixels a thread (QS_P in the kernel)
LANES = (32, 16, 8, 4)            # threads along a tile row (blockDim.x)
TILE_HEIGHTS = (16, 8, 4, 2, 1)   # rows of threads (blockDim.y)
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


def _fits(planes: int, lanes: int, th: int, radius: int) -> bool:
    """Whether the halo of a tile of ``th`` rows of ``lanes`` strips, in
    ``planes`` float32 planes, fits in one block's shared memory."""
    return 4 * planes * (th + 2 * radius) * (lanes * STRIP + 2 * radius) \
        <= SMEM_LIMIT


def tile_shape(C: int, radius: int, parent: bool) -> Tuple[int, int]:
    """``(lanes, th)`` of a scan of C channels with a halo of this radius
    (the window's ``r`` for the density, the disk's ``rp`` for the parent):
    a block of ``th`` rows of ``lanes`` threads, each a strip of ``STRIP``
    pixels. Of the shapes whose halo (C planes, plus rho for the parent)
    fits, the one that loads the fewest halo floats an output pixel, the
    wider and then the taller on a tie. Raises ValueError when none fits."""
    planes = C + 1 if parent else C
    best = None
    for lanes in LANES:
        for th in TILE_HEIGHTS:
            if not _fits(planes, lanes, th, radius):
                continue
            w = lanes * STRIP
            cost = (th + 2 * radius) * (w + 2 * radius) / (th * w)
            if best is None or cost < best[0]:
                best = (cost, lanes, th)
    if best is None:
        kind, what = (("parent", "min(radius, floor(max_dist))") if parent
                      else ("density", "radius"))
        raise ValueError(
            f"quickshift {kind} kernel: {what} = {radius} with {C} channels "
            f"needs a shared-memory halo over {SMEM_LIMIT} bytes even in the "
            f"smallest tile (the largest radius for {C} channels is "
            f"{max_radius(C, parent)})")
    return best[1], best[2]


def max_radius(C: int, parent: bool = False) -> int:
    """The largest halo radius the density (``r``) or the parent kernel
    (``rp``) takes for C channels: the smallest tile's."""
    planes = C + 1 if parent else C
    r = 0
    while _fits(planes, LANES[-1], 1, r + 1):
        r += 1
    return r


def parent_extents(radius: int, max_dist: float) -> Tuple[int, List[int]]:
    """``(rp, widths)`` of the parent kernel's scan: ``rp`` is the largest
    ``w <= radius`` with ``w^2 <= max_d2`` (``max_dist^2`` rounded to
    float32), i.e. ``min(radius, floor(max_dist))``, and ``widths[dy + rp]``
    the largest ``w <= rp`` with ``dy^2 + w^2 <= max_d2``, for
    ``dy = -rp .. rp``: the kernel visits ``|dx| <= widths[dy + rp]`` of row
    ``dy``, in integers against the float32 ``max_d2`` as here."""
    r = _check_radius(radius)
    max_d2 = _f32(max_dist * max_dist)
    rp = 0
    while rp < r and (rp + 1) ** 2 <= max_d2:
        rp += 1
    widths = []
    for dy in range(-rp, rp + 1):
        w = rp
        while w > 0 and dy * dy + w * w > max_d2:
            w -= 1
        widths.append(w)
    return rp, widths


def disk_offsets(radius: int, max_dist: float) -> np.ndarray:
    """(n, 2) int32 (dy, dx) that the parent kernel visits, in its row-major
    order, without (0, 0): the window offsets with
    ``dy^2 + dx^2 <= max_dist^2`` (see :func:`parent_extents`)."""
    rp, widths = parent_extents(radius, max_dist)
    return np.asarray([(dy, dx) for dy, w in zip(range(-rp, rp + 1), widths)
                       for dx in range(-w, w + 1) if (dy, dx) != (0, 0)],
                      np.int32).reshape(-1, 2)


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
    """(H, W) float32 density of the (C, H, W) scaled image. On the card a
    NaN ``kernel_size`` raises: the kernel drops a term whose exponent is
    NaN, where the twin, on the CPU, sums it and returns NaN everywhere
    (``quickshift`` cannot pass one: its radius is ceil(3k))."""
    if img.device.type == "cpu":
        return quickshift_density_reference(img, radius, kernel_size)
    if img.device.type != "cuda":
        raise ValueError(f"quickshift_density: unsupported device "
                         f"{img.device}")
    if math.isnan(kernel_size):
        raise ValueError("kernel_size is NaN")
    C, H, W = _check(img)
    r = _check_radius(radius)
    lanes, th = tile_shape(C, r, parent=False)
    rho = torch.empty((H, W), dtype=torch.float32, device=img.device)
    from .. import _build
    lib = _build.load()
    with torch.cuda.device(img.device):
        status = lib.obia_qs_density(
            img.data_ptr(), C, H, W, r, lanes, th,
            _f32(1.0 / (2.0 * kernel_size * kernel_size)), rho.data_ptr(),
            _stream(img))
    if status != 0:
        raise RuntimeError(f"quickshift density kernel launch failed: CUDA "
                           f"error {status}")
    telemetry.count("kernel.qs_density")  # the twin never counts
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
    rp, _ = parent_extents(radius, max_dist)
    lanes, th = tile_shape(C, rp, parent=True)
    best_d2 = torch.empty((H, W), dtype=torch.float32, device=img.device)
    doff = torch.empty((H, W), dtype=torch.int32, device=img.device)
    from .. import _build
    lib = _build.load()
    with torch.cuda.device(img.device):
        status = lib.obia_qs_parent(
            img.data_ptr(), rho.data_ptr(), C, H, W, rp, lanes, th,
            _f32(max_dist * max_dist), best_d2.data_ptr(), doff.data_ptr(),
            _stream(img))
    if status != 0:
        raise RuntimeError(f"quickshift parent kernel launch failed: CUDA "
                           f"error {status}")
    telemetry.count("kernel.qs_parent")
    return best_d2, doff


def kernel_attributes(C: int) -> dict:
    """``{"density": {...}, "parent": {...}}``: each kernel's registers and
    spilled (local) bytes a thread at C channels, and its pixels a thread,
    as the loaded CUDA library reports them (``cudaFuncGetAttributes``)."""
    from .. import _build
    fn = _build.load().obia_qs_attributes
    out = {}
    for parent, kind in ((0, "density"), (1, "parent")):
        vals = (ctypes.c_int * 3)()
        status = fn(parent, C, vals)
        if status != 0:
            raise RuntimeError(f"quickshift {kind} kernel attributes: CUDA "
                               f"error {status}")
        out[kind] = {"registers": vals[0], "local_bytes": vals[1],
                     "strip": vals[2]}
    return out


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
    the +inf-padded image and the -inf-padded rho over the whole window,
    strict-< updates in row-major offset order."""
    return _parent_scan(img, rho, window_offsets(_check_radius(radius)),
                        max_dist)


def _parent_scan(img: torch.Tensor, rho: torch.Tensor, offsets: np.ndarray,
                 max_dist: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The parent twin's scan over ``offsets`` ((n, 2) (dy, dx)), in their
    order."""
    C, H, W = img.shape
    r = int(np.abs(offsets).max()) if len(offsets) else 0
    max_d2 = _f32(max_dist * max_dist)
    pad = F.pad(img, (r, r, r, r), value=float("inf"))
    pad_rho = F.pad(rho[None], (r, r, r, r), value=float("-inf"))[0]
    best = torch.full((H, W), float("inf"), dtype=torch.float32,
                      device=img.device)
    doff = torch.zeros((H, W), dtype=torch.int32, device=img.device)
    for dy, dx in offsets.tolist():
        sh = pad[:, r + dy:r + dy + H, r + dx:r + dx + W]
        d2 = _d2(img, sh, dy * dy + dx * dx)
        nb_rho = pad_rho[r + dy:r + dy + H, r + dx:r + dx + W]
        better = ((nb_rho > rho) & (d2 <= max_d2) & torch.isfinite(d2)
                  & (d2 < best))
        best = torch.where(better, d2, best)
        doff = torch.where(better, dy * W + dx, doff)
    return best, doff
