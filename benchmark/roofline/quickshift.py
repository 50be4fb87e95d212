"""The least time of quickshift's two window scans over a (C, H, W)
float32 image: the density over the (2r+1)^2 - 1 offsets of its window,
the parent over the offsets of the max_dist disk, each counting the
(pixel, offset) pairs whose neighbour lies in the image. The longest of:
3C + 4 float32 operations a pair (the distance, then the weight or the
comparisons) over the float32 peak; the density's one exponential a pair
over the special-function units; the image and rho read and the outputs
(the parent's distance and offset) written once over the HBM."""
import math

import numpy as np

from . import FP32_OPS_PER_MS, HBM_BYTES_PER_MS, SFU_OPS_PER_MS

DENSITY_KERNELS = ("qs_density_kernel",)
PARENT_KERNELS = ("qs_parent_kernel",)


def window_offsets(radius: int) -> np.ndarray:
    """(n, 2) (dy, dx) of the (2r+1)^2 window without (0, 0)."""
    r = np.arange(-radius, radius + 1)
    dy, dx = np.meshgrid(r, r, indexing="ij")
    keep = (dy != 0) | (dx != 0)
    return np.stack([dy[keep], dx[keep]], axis=1)


def disk_offsets(radius: int, max_dist: float) -> np.ndarray:
    """The window offsets with dy^2 + dx^2 <= max_dist^2 (float32)."""
    off = window_offsets(radius)
    max_d2 = float(np.float32(max_dist * max_dist))
    return off[(off ** 2).sum(axis=1) <= max_d2]


def pairs(offsets: np.ndarray, H: int, W: int) -> int:
    """(pixel, offset) pairs whose neighbour lies in the H x W image."""
    a = np.abs(offsets.astype(np.int64))
    return int((np.clip(H - a[:, 0], 0, None)
                * np.clip(W - a[:, 1], 0, None)).sum())


def radius(kernel_size: float) -> int:
    return max(1, int(math.ceil(3.0 * kernel_size)))


def density_bound_ms(C: int, H: int, W: int, r: int) -> float:
    n = pairs(window_offsets(r), H, W)
    return max(n * (3 * C + 4) / FP32_OPS_PER_MS, n / SFU_OPS_PER_MS,
               4 * H * W * (C + 1) / HBM_BYTES_PER_MS)


def parent_bound_ms(C: int, H: int, W: int, r: int,
                    max_dist: float) -> float:
    n = pairs(disk_offsets(r, max_dist), H, W)
    return max(n * (3 * C + 4) / FP32_OPS_PER_MS,
               4 * H * W * (C + 3) / HBM_BYTES_PER_MS)
