"""Raster filters in torch (port of ``obia_tpu/ops/filters.py``).

The scipy.ndimage / skimage.rank filters the reference's callers use:
``gaussian_filter``, ``maximum_filter``, ``uniform_filter``, ``sobel``,
``disk_footprint``, ``local_entropy`` and ``laplacian_3x3``. Each runs on
its tensor's device and filters the first two dimensions (trailing
dimensions, such as channels, are filtered independently).

Boundary modes are scipy's names: ``reflect`` (scipy's default, np.pad
``symmetric``: ``d c b a | a b c d``), ``nearest`` (np.pad ``edge``),
``mirror`` (np.pad ``reflect``: ``d c b | a b c d``) and ``constant``
(zeros). Padding is an index gather over the periodic extension, so a
radius larger than the image reflects again, as ``np.pad`` does; torch's
own ``F.pad(mode="reflect")`` is scipy's ``mirror`` and refuses such radii.

Every correlation is a fixed-order float32 sum of shifted slices, one tap
at a time, each product rounded before it is added: no ``conv2d``, so no
cuDNN algorithm choice or TF32 rounding, and the card and the CPU add the
same terms in the same order. The Gaussian taps are computed once on the
host in float32, as the reference computes them.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

_MODES = ("reflect", "nearest", "mirror", "constant")


def _pad_index(n: int, before: int, after: int, mode: str,
               device) -> torch.Tensor:
    """Source index of every position -before..n+after-1 of a padded axis
    of length n; ``n`` itself marks a constant (zero) pixel."""
    i = torch.arange(-before, n + after, device=device)
    if mode == "reflect":            # period 2n: a b c | c b a | a b c
        m = i.remainder(2 * n)
        return torch.where(m < n, m, 2 * n - 1 - m)
    if mode == "mirror":             # period 2n - 2: a b c | b | a b c
        if n == 1:
            return torch.zeros_like(i)
        m = i.remainder(2 * n - 2)
        return torch.where(m < n, m, 2 * n - 2 - m)
    if mode == "nearest":
        return i.clamp(0, n - 1)
    if mode == "constant":
        return torch.where((i >= 0) & (i < n), i, n)
    raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")


def pad2d(x: torch.Tensor, pad_y: Tuple[int, int], pad_x: Tuple[int, int],
          mode: str) -> torch.Tensor:
    """Pad the first two dimensions of ``x`` by (before, after) pixels each,
    with ``np.pad``'s arithmetic for the scipy ``mode``."""
    for dim, (before, after) in ((0, pad_y), (1, pad_x)):
        n = x.shape[dim]
        idx = _pad_index(n, before, after, mode, x.device)
        if mode == "constant":
            zero = torch.zeros_like(x.narrow(dim, 0, 1))
            x = torch.cat([x, zero], dim=dim)
        x = x.index_select(dim, idx)
    return x


def _correlate1d(xp: torch.Tensor, taps: Sequence[float],
                 dim: int) -> torch.Tensor:
    """VALID correlation of ``xp`` with ``taps`` along ``dim``: tap k
    multiplies the slice shifted by k, and the rounded products are added
    in tap order."""
    L = xp.shape[dim] - len(taps) + 1
    acc = xp.narrow(dim, 0, L) * taps[0]
    for k in range(1, len(taps)):
        acc = acc + xp.narrow(dim, k, L) * taps[k]
    return acc


def _correlate2d(xp: torch.Tensor, kernel: np.ndarray,
                 skip_zeros: bool = False) -> torch.Tensor:
    """VALID 2-D correlation, the taps added in row-major order (zero taps
    skipped with ``skip_zeros``, which changes no sum of finite values)."""
    kh, kw = kernel.shape
    H, W = xp.shape[0] - kh + 1, xp.shape[1] - kw + 1
    acc = None
    for dy in range(kh):
        for dx in range(kw):
            w = float(kernel[dy, dx])
            if skip_zeros and w == 0.0:
                continue
            term = xp[dy:dy + H, dx:dx + W] * w
            acc = term if acc is None else acc + term
    return acc if acc is not None else torch.zeros_like(xp[:H, :W])


def _gaussian_taps(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(np.float32(-0.5) * (x / np.float32(sigma)) ** 2)
    return (k / k.sum(dtype=np.float32)).astype(np.float32)


def gaussian_filter(x: torch.Tensor, sigma: float, mode: str = "reflect",
                    truncate: float = 4.0) -> torch.Tensor:
    """scipy.ndimage.gaussian_filter over the first two dimensions (float32
    out; ``sigma == 0`` returns the input as float32)."""
    if sigma < 0:
        raise ValueError(f"sigma must be >= 0, got {sigma}")
    x = x.to(torch.float32)
    if sigma == 0:
        return x
    radius = int(truncate * sigma + 0.5)
    taps = _gaussian_taps(sigma, radius).tolist()
    xp = pad2d(x, (radius, radius), (radius, radius), mode)
    return _correlate1d(_correlate1d(xp, taps, 0), taps, 1)


def maximum_filter(x: torch.Tensor, size: int, mode: str = "reflect"
                   ) -> torch.Tensor:
    """scipy.ndimage.maximum_filter with a square ``size`` window."""
    r = size // 2
    r2 = size - 1 - r
    xp = pad2d(x, (r, r2), (r, r2), mode)
    for dim in (0, 1):
        L = xp.shape[dim] - size + 1
        acc = xp.narrow(dim, 0, L)
        for k in range(1, size):
            acc = torch.maximum(acc, xp.narrow(dim, k, L))
        xp = acc
    return xp


def uniform_filter(x: torch.Tensor, size: int, mode: str = "reflect"
                   ) -> torch.Tensor:
    """scipy.ndimage.uniform_filter: the mean of a square ``size`` window
    (its sum in row-major order, then one division)."""
    r = size // 2
    r2 = size - 1 - r
    xp = pad2d(x.to(torch.float32), (r, r2), (r, r2), mode)
    return _correlate2d(xp, np.ones((size, size), np.float32)) / (size * size)


def sobel(x: torch.Tensor, axis: int = -1, mode: str = "reflect"
          ) -> torch.Tensor:
    """scipy.ndimage.sobel: the derivative [-1, 0, 1] along ``axis`` (0 or
    1, of the first two), the smoothing [1, 2, 1] along the other."""
    deriv, smooth = [-1.0, 0.0, 1.0], [1.0, 2.0, 1.0]
    axis = axis % 2
    xp = pad2d(x.to(torch.float32), (1, 1), (1, 1), mode)
    return _correlate1d(_correlate1d(xp, deriv, axis), smooth, 1 - axis)


def disk_footprint(radius: int) -> np.ndarray:
    """skimage.morphology.disk."""
    y, x = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    return (x * x + y * y <= radius * radius).astype(np.float32)


def local_entropy(image_u8: torch.Tensor, footprint,
                  n_levels: int = 256) -> torch.Tensor:
    """skimage.filters.rank.entropy: the Shannon entropy (bits) of the
    local histogram under ``footprint``, for uint8-valued input. One
    masked footprint sum per level, in level order, as the reference's
    scan adds them."""
    q = image_u8.to(torch.int32)
    fp = np.asarray(footprint, np.float32)
    kh, kw = fp.shape
    ry, rx = kh // 2, kw // 2
    qp = pad2d(q, (ry, ry), (rx, rx), "reflect")
    total = float(fp.sum(dtype=np.float32))
    out = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for level in range(n_levels):
        mask = (qp == level).to(torch.float32)
        p = _correlate2d(mask, fp, skip_zeros=True) / total
        out = out + torch.where(p > 0, -p * torch.log2(p),
                                torch.zeros_like(p))
    return out


def laplacian_3x3(x: torch.Tensor, mode: str = "reflect") -> torch.Tensor:
    """OpenCV ``cv2.Laplacian(ksize=3)``: the kernel [[2, 0, 2], [0, -8, 0],
    [2, 0, 2]] (reference ``laplacian_3x3``)."""
    k = np.array([[2, 0, 2], [0, -8, 0], [2, 0, 2]], np.float32)
    return _correlate2d(pad2d(x.to(torch.float32), (1, 1), (1, 1), mode), k)
