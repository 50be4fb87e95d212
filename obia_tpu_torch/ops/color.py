"""sRGB -> CIELAB (D65), port of ``obia_tpu/ops/color.py``.

skimage's slic converts 3-channel input to Lab by default (``convert2lab``),
which the reference inherits for RGB scenes. The 3x3 colour matrix is
applied as explicit multiply-adds, not a matmul, so no TF32 path can touch
it on the card. The chain runs in float64 and rounds once to float32: the
card's and the CPU's ``pow`` differ in the last float32 bits, which moved
SLIC labels; rounded from float64 they agree.
"""
from __future__ import annotations

import torch

# sRGB -> XYZ (D65)
_M = ((0.412453, 0.357580, 0.180423),
      (0.212671, 0.715160, 0.072169),
      (0.019334, 0.119193, 0.950227))
_WHITE = (0.95047, 1.0, 1.08883)


def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) sRGB in [0, 1] -> (..., 3) CIELAB (L in [0, 100])."""
    rgb = torch.clamp(rgb.to(torch.float64), 0.0, 1.0)
    linear = torch.where(rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4,
                         rgb / 12.92)
    r, g, b = linear[..., 0], linear[..., 1], linear[..., 2]
    eps = 0.008856
    kappa = 903.3
    f = []
    for row, white in zip(_M, _WHITE):
        xyz_n = (r * row[0] + g * row[1] + b * row[2]) / white
        f.append(torch.where(xyz_n > eps, torch.pow(xyz_n, 1.0 / 3.0),
                             (kappa * xyz_n + 16.0) / 116.0))
    fx, fy, fz = f
    return torch.stack([116.0 * fy - 16.0, 500.0 * (fx - fy),
                        200.0 * (fy - fz)], dim=-1).to(torch.float32)
