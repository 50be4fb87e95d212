"""Raster filters in torch (port of ``obia_tpu/ops/filters.py``).

The scipy.ndimage / skimage.rank filters the reference's callers use:
``gaussian_filter``, ``maximum_filter``, ``uniform_filter``, ``sobel``,
``disk_footprint``, ``local_entropy`` and ``laplacian_3x3``, with the
reference's ``hypot`` (and the fused multiply-add it is built from) for
gradient magnitudes and distances. Each runs on
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


# Cephes' float32 log polynomial, as XLA's CPU backend emits it
_LOG_P = np.array([7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1,
                   -1.2420140846E-1, 1.4249322787E-1, -1.6668057665E-1,
                   2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1],
                  np.float32)
_LOG_Q1, _LOG_Q2 = np.float32(-2.12194440e-4), np.float32(0.693359375)


def _fma_x(a, b, c) -> np.ndarray:
    """Elementwise a * b + c of float32 arrays, rounded once (see
    :func:`fma`)."""
    return (np.asarray(a, np.float32).astype(np.float64)
            * np.asarray(b, np.float32) + np.asarray(c, np.float32)).astype(
        np.float32)


def _xla_log(x: np.ndarray) -> np.ndarray:
    """float32 natural log of positive normal ``x`` as the reference's
    XLA program computes it on the CPU: Cephes' degree-8 polynomial in the
    mantissa shifted to [sqrt(1/2) - 1, sqrt(2) - 1), its multiply-adds
    fused. It is not correctly rounded (it differs from libm's log by an
    ulp on a few inputs), and the entropy adds those ulps up."""
    m, e = np.frexp(np.asarray(x, np.float32))
    m, e = m.astype(np.float32), e.astype(np.float32)
    low = m < np.float32(0.707106781186547524)
    e = e - low.astype(np.float32)
    x = (m - np.float32(1)) + np.where(low, m, np.float32(0))
    x2 = x * x
    x3 = x2 * x
    p = _LOG_P
    y = _fma_x(x, p[0], p[1])
    y1 = _fma_x(x, p[3], p[4])
    y2 = _fma_x(x, p[6], p[7])
    y = _fma_x(y, x, p[2])
    y1 = _fma_x(y1, x, p[5])
    y2 = _fma_x(y2, x, p[8])
    y = _fma_x(y, x3, y1)
    y = _fma_x(y, x3, y2)
    y = _fma_x(y, x3, _LOG_Q1 * e)
    x = _fma_x(-x2, np.float32(0.5), x) + y
    return _fma_x(_LOG_Q2, e, x)


def _entropy_terms(total: int) -> np.ndarray:
    """-p log2(p) for p = k / total, k = 0..total (0 for k = 0), in the
    reference's float32 arithmetic: log2 is XLA's log times log2(e)."""
    k = np.arange(1, total + 1, dtype=np.float32)
    p = k / np.float32(total)
    log2 = _xla_log(p) * np.float32(1.4426950408889634)
    return np.concatenate([[np.float32(0)], -p * log2]).astype(np.float32)


def local_entropy(image_u8: torch.Tensor, footprint,
                  n_levels: int = 256) -> torch.Tensor:
    """skimage.filters.rank.entropy: the Shannon entropy (bits) of the
    local histogram under the 0/1 ``footprint``, for uint8-valued input.
    Per level, in level order as the reference's scan adds them, the
    footprint count of each pixel's window (an exact integer) indexes the
    table of -p log2 p (:func:`_entropy_terms`), so the card, the CPU and
    the reference add the same float32 terms."""
    q = image_u8.to(torch.int32)
    fp = np.asarray(footprint, np.float32)
    if not np.isin(fp, (0, 1)).all():
        raise ValueError("local_entropy takes a 0/1 footprint")
    kh, kw = fp.shape
    ry, rx = kh // 2, kw // 2
    qp = pad2d(q, (ry, ry), (rx, rx), "reflect")
    terms = torch.as_tensor(_entropy_terms(int(fp.sum())), device=q.device)
    out = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for level in range(n_levels):
        mask = (qp == level).to(torch.float32)
        count = _correlate2d(mask, fp, skip_zeros=True)
        out = out + terms[count.to(torch.int64)]
    return out


def fma(p, q, r) -> torch.Tensor:
    """p * q + r in float32, rounded once: the product of two float32 is
    exact in float64, so this is a fused multiply-add (up to a double
    rounding that needs the float64 sum to land on a float32 tie)."""
    return (p * q.double() + r.double()).float()


def hypot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``jnp.hypot`` as the reference computes it (XLA's CPU backend fuses
    the square into the add): with x1 = max(|u|, |v|) and x2 the min,
    x1 * sqrt(fma(r, r, 1)) for r = x2 / x1, 0 where x1 is 0. libm's
    ``hypot`` (``torch.hypot``) differs from it by an ulp."""
    u, v = u.abs(), v.abs()
    x1, x2 = torch.maximum(u, v), torch.minimum(u, v)
    zero = x1 == 0
    r = x2 / torch.where(zero, torch.ones_like(x1), x1)
    # the float32 root rounded from float64's is correctly rounded, as
    # XLA's is; torch's float32 sqrt on the CPU is not
    root = torch.sqrt(fma(r, r, torch.ones_like(r)).double()).float()
    out = torch.where(zero, x1, x1 * root)
    return torch.where(torch.isinf(x1), torch.full_like(x1, np.inf), out)


def laplacian_3x3(x: torch.Tensor, mode: str = "reflect") -> torch.Tensor:
    """OpenCV ``cv2.Laplacian(ksize=3)``: the kernel [[2, 0, 2], [0, -8, 0],
    [2, 0, 2]] (reference ``laplacian_3x3``)."""
    k = np.array([[2, 0, 2], [0, -8, 0], [2, 0, 2]], np.float32)
    return _correlate2d(pad2d(x.to(torch.float32), (1, 1), (1, 1), mode), k)
