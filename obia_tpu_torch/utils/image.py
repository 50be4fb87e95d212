"""Image enhancement utilities (the port's copy of
``obia_tpu/utils/image.py``): ``rescale_to_8bit``, histogram equalisation,
CLAHE, ``rgb_to_gray``, ``variance_of_laplacian`` and the ``laplacian``
sharpness raster, all numpy on the host.

OpenCV is optional, as in the reference: each function takes cv2's path
when cv2 imports and a numpy path otherwise.
"""
from __future__ import annotations

import numpy as np
from scipy.ndimage import uniform_filter

from ..io.tiff import TiffReader, write_tiff


def _cv2():
    try:
        import cv2
        return cv2
    except ImportError:
        return None


def rescale_to_8bit(image: np.ndarray, min: int = 2, max: int = 98) -> np.ndarray:
    """Percentile-stretch to uint8 [0, 255]; constant inputs map to zeros."""
    p_min, p_max = np.percentile(image, (min, max))
    if p_min == p_max:
        return np.zeros(image.shape, dtype=np.uint8)
    scaled = 255.0 * (image - p_min) / (p_max - p_min)
    return np.clip(scaled, 0, 255).astype(np.uint8)


def _equalize_hist_u8(gray: np.ndarray) -> np.ndarray:
    """cv2.equalizeHist semantics on uint8: cdf-remap ignoring the lowest
    occupied bin, rounded to nearest."""
    hist = np.bincount(gray.reshape(-1), minlength=256)
    cdf = hist.cumsum()
    nonzero = cdf[cdf > 0]
    if nonzero.size == 0 or nonzero[0] == cdf[-1]:
        return gray.copy()
    cdf_min = nonzero[0]
    lut = np.round((cdf - cdf_min) * 255.0 / (cdf[-1] - cdf_min))
    return np.clip(lut, 0, 255).astype(np.uint8)[gray]


def apply_histogram_equalization(image: np.ndarray) -> np.ndarray:
    """Global histogram equalization; always returns a 3-channel stack."""
    cv2 = _cv2()
    if image.ndim == 3:
        if cv2 is not None:
            image_gray = cv2.cvtColor(image, cv2.COLOR_RGB2GRAY)
        else:
            image_gray = np.round(rgb_to_gray(
                image.astype(np.float32))).astype(np.uint8)
    else:
        image_gray = image
    if cv2 is not None:
        equalized = cv2.equalizeHist(image_gray)
    else:
        equalized = _equalize_hist_u8(np.ascontiguousarray(image_gray))
    return np.stack((equalized,) * 3, axis=-1)


def _clahe_u8(gray: np.ndarray, clip_limit: float = 2.0,
              grid: int = 8) -> np.ndarray:
    """Contrast-limited adaptive hist-eq on uint8 (numpy fallback for
    cv2.createCLAHE): per-tile clipped-cdf LUTs, bilinear-blended between
    the four surrounding tile centers."""
    H, W = gray.shape
    th, tw = max(1, H // grid), max(1, W // grid)
    gh, gw = (H + th - 1) // th, (W + tw - 1) // tw
    luts = np.empty((gh, gw, 256), np.float32)
    for i in range(gh):
        for j in range(gw):
            tile = gray[i * th:min((i + 1) * th, H),
                        j * tw:min((j + 1) * tw, W)]
            hist = np.bincount(tile.reshape(-1), minlength=256).astype(
                np.float64)
            limit = max(1.0, clip_limit * tile.size / 256.0)
            excess = np.maximum(hist - limit, 0).sum()
            hist = np.minimum(hist, limit) + excess / 256.0
            cdf = hist.cumsum()
            luts[i, j] = cdf * (255.0 / cdf[-1])
    yy = (np.arange(H, dtype=np.float32) - th / 2.0) / th
    xx = (np.arange(W, dtype=np.float32) - tw / 2.0) / tw
    y0 = np.clip(np.floor(yy).astype(np.int64), 0, gh - 1)
    x0 = np.clip(np.floor(xx).astype(np.int64), 0, gw - 1)
    y1 = np.minimum(y0 + 1, gh - 1)
    x1 = np.minimum(x0 + 1, gw - 1)
    fy = np.clip(yy - np.floor(yy), 0, 1)[:, None]
    fx = np.clip(xx - np.floor(xx), 0, 1)[None, :]
    g = gray.astype(np.int64)
    v00 = luts[y0[:, None], x0[None, :], g]
    v01 = luts[y0[:, None], x1[None, :], g]
    v10 = luts[y1[:, None], x0[None, :], g]
    v11 = luts[y1[:, None], x1[None, :], g]
    out = (v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx
           + v10 * fy * (1 - fx) + v11 * fy * fx)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def apply_clahe(image: np.ndarray) -> np.ndarray:
    """CLAHE (clip 2.0, 8x8 tiles), per-channel for multiband input."""
    cv2 = _cv2()
    if cv2 is not None:
        clahe = cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8))
        if image.ndim == 3:
            channels = cv2.split(image)
            return cv2.merge([clahe.apply(ch) for ch in channels])
        return clahe.apply(image)
    if image.ndim == 3:
        return np.stack([_clahe_u8(image[..., c])
                         for c in range(image.shape[2])], axis=-1)
    return _clahe_u8(image)


def rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """ITU-R 601 grayscale (expects float array, any range)."""
    coeffs = np.array([0.299, 0.587, 0.114], dtype=np.float32)
    return (rgb * coeffs).sum(axis=-1)


def variance_of_laplacian(gray: np.ndarray, win: int) -> np.ndarray:
    """Local variance of the 3x3 Laplacian over a win x win window."""
    cv2 = _cv2()
    if cv2 is not None:
        lap = cv2.Laplacian(gray.astype(np.float32), cv2.CV_32F, ksize=3)
    else:
        # cv2.Laplacian(ksize=3) = sum of 3x3 Sobel second derivatives,
        # i.e. kernel [[2,0,2],[0,-8,0],[2,0,2]] with reflect-101 borders
        from scipy.ndimage import convolve
        kernel = np.array([[2, 0, 2], [0, -8, 0], [2, 0, 2]], np.float32)
        lap = convolve(gray.astype(np.float32), kernel, mode="mirror")
    mean = uniform_filter(lap, size=win)
    mean2 = uniform_filter(lap * lap, size=win)
    return mean2 - mean ** 2


def laplacian(in_path: str, out_path: str, win: int,
              vis_bands=(2, 3, 5)) -> None:
    """Laplacian-variance sharpness raster (reference image.py:103-136):
    read visible bands (1-based), min-max normalise, grayscale,
    Laplacian variance, 2-98 percentile stretch, write float32 GeoTIFF."""
    reader = TiffReader(in_path)
    full = reader.read()
    idx = [b - 1 for b in vis_bands]
    arr = full[:, :, idx].astype(np.float32)

    band_min = arr.min(axis=(0, 1), keepdims=True)
    band_rng = np.ptp(arr, axis=(0, 1)) .reshape(1, 1, -1) + 1e-8
    arr = (arr - band_min) / band_rng

    gray = rgb_to_gray(arr)
    sharp = variance_of_laplacian(gray, win)

    lo, hi = np.percentile(sharp, [2, 98])
    sharp = np.clip((sharp - lo) / (hi - lo + 1e-30), 0, 1)

    write_tiff(out_path, sharp.astype(np.float32),
               transform=reader.transform, crs=reader.crs)
