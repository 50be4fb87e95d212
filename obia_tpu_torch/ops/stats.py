"""Per-object spectral moments (port of ``obia_tpu/ops/stats.py``).

One pass over the label raster accumulates counts and sums, a second the
centred 2nd/3rd/4th powers (two-pass centring keeps float32 accurate), and
``scatter_reduce`` gives min and max. The per-pixel terms are float32, as
the reference's; the passes add them in float64, and the caller rounds each
sum to float32 once, after the last reduction. So the order in which the
card's atomics add cannot move a float32 sum unless a float64 sum lies
within rounding of a float32 boundary, and single-device and sharded runs
agree as closely. The passes are separate functions so that the sharded
path (``parallel/sharded.py``) can reduce each one over the mesh before the
next. Definitions are scipy's defaults:
variance is biased (ddof=0), skewness the Fisher-Pearson g1 and kurtosis the
Fisher excess g2, both with bias=True. An empty object gets NaN everywhere;
an object with zero variance gets NaN skewness and kurtosis.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..device import input_device

SPECTRAL_STAT_NAMES = ("mean", "variance", "min", "max", "skewness",
                       "kurtosis")
SPECTRAL_PACK_ORDER = ("count", "mean", "variance", "min", "max",
                       "skewness", "kurtosis")
# pixels whose float64 rows exist at once in a blocked sum: at 8 bands the
# second moment pass holds ~1.6 GB of them, where all of a 100 MP scene's
# would take ~35 GB
SUM_BLOCK = 1 << 22


def segment_sum(values: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """(N, F) rows summed by segment id -> (num_segments, F)."""
    out = torch.zeros((num_segments, values.shape[1]), dtype=values.dtype,
                      device=values.device)
    return out.index_add_(0, seg, values)


def blocked_segment_sum(rows: Callable[[slice], torch.Tensor],
                        seg: torch.Tensor, num_segments: int,
                        width: int) -> torch.Tensor:
    """(num_segments, width) float64 sums by segment id ``seg`` (N,) of
    the float64 rows ``rows(s)`` of each run ``s`` of :data:`SUM_BLOCK`
    pixels, built and added one run at a time in pixel order into one
    total. On the CPU ``index_add_`` adds in row order, so the sums equal
    one ``segment_sum`` of all N rows bit for bit."""
    out = torch.zeros((num_segments, width), dtype=torch.float64,
                      device=seg.device)
    for i in range(0, seg.numel(), SUM_BLOCK):
        s = slice(i, i + SUM_BLOCK)
        out.index_add_(0, seg[s], rows(s))
    return out


def _moments_finalize(cnt1, s1, p2, xmin, xmax, C: int):
    """Reduced moment sums -> {stat: (K, C)} (reference stats.py:208-240)."""
    K = cnt1.shape[0]
    cnt = cnt1[:, None].expand(K, C)
    safe_cnt = torch.clamp(cnt, min=1.0)
    mean = s1 / safe_cnt
    m2 = p2[:, :C] / safe_cnt
    m3 = p2[:, C:2 * C] / safe_cnt
    m4 = p2[:, 2 * C:] / safe_cnt
    nan = torch.full_like(m2, float("nan"))
    zero_var = m2 <= 0
    safe_m2 = torch.where(zero_var, torch.ones_like(m2), m2)
    skew = torch.where(zero_var, nan, m3 / safe_m2 ** 1.5)
    kurt = torch.where(zero_var, nan, m4 / safe_m2 ** 2 - 3.0)
    empty = cnt == 0

    def mask_empty(a):
        return torch.where(empty, nan, a)

    return {
        "count": cnt,
        "mean": mask_empty(mean),
        "variance": mask_empty(m2),
        "min": mask_empty(xmin),
        "max": mask_empty(xmax),
        "skewness": mask_empty(skew),
        "kurtosis": mask_empty(kurt),
    }


def segment_spectral_moments(image: torch.Tensor, labels: torch.Tensor,
                             num_segments: int,
                             valid: Optional[torch.Tensor] = None):
    """{stat: (K, C)} for an (H, W, C) float32 image and (H, W) labels in
    [0, K) (negative = outside every object)."""
    K = int(num_segments)
    pix = moment_pixels(image, labels, K, valid)
    s1c = moment_pass1(pix, K).float()  # float64 sums, rounded once
    cnt1 = s1c[:, 0]
    s1 = s1c[:, 1:]
    mean = s1 / torch.clamp(cnt1[:, None], min=1.0)
    p2 = moment_pass2(pix, mean, K).float()
    xmin, xmax = moment_minmax(pix, K)
    return _moments_finalize(cnt1, s1, p2, xmin, xmax, image.shape[2])


def moment_pixels(image: torch.Tensor, labels: torch.Tensor, K: int,
                  valid: Optional[torch.Tensor] = None):
    """The per-pixel inputs of the moment passes: (x (N, C) float32, lab
    (N,) int64, seg (N,) int64 with K where no object owns the pixel, okf
    (N,) float32 0/1)."""
    C = image.shape[-1]
    x = image.reshape(-1, C).to(torch.float32)
    lab = labels.reshape(-1).long()
    ok = lab >= 0
    if valid is not None:
        ok = ok & valid.reshape(-1)
    seg = torch.where(ok, lab, K)       # row K collects what no object owns
    return x, lab, seg, ok.to(x.dtype)


def moment_pass1(pix, K: int) -> torch.Tensor:
    """(K, 1+C) float64: [count | sum x per channel] (reference
    ``_moment_pass1``), float32 terms added in float64, a block of pixels
    at a time (:func:`blocked_segment_sum`)."""
    x, _, seg, okf = pix

    def rows(s):
        w = okf[s, None]
        return torch.cat([w, x[s] * w], dim=1).double()

    return blocked_segment_sum(rows, seg, K + 1, 1 + x.shape[1])[:K]


def moment_pass2(pix, mean: torch.Tensor, K: int) -> torch.Tensor:
    """(K, 3C) float64 centred 2nd/3rd/4th power sums about the objects'
    float32 means (reference ``_moment_pass2``), float32 terms added in
    float64, a block of pixels at a time (:func:`blocked_segment_sum`)."""
    x, lab, seg, okf = pix

    def rows(s):
        d = (x[s] - mean[lab[s].clamp(0, max(K - 1, 0))]) * okf[s, None]
        d2 = d * d
        return torch.cat([d2, d2 * d, d2 * d2], dim=1).double()

    return blocked_segment_sum(rows, seg, K + 1, 3 * x.shape[1])[:K]


def moment_minmax(pix, K: int):
    """((K, C) min, (K, C) max); an empty object keeps +/- the float32
    maximum (reference ``_moment_minmax``)."""
    x, _, seg, _ = pix
    C = x.shape[1]
    big = torch.finfo(torch.float32).max
    idx = seg[:, None].expand(-1, C)
    xmin = torch.full((K + 1, C), big, dtype=x.dtype, device=x.device)
    xmin.scatter_reduce_(0, idx, x, "amin")
    xmax = torch.full((K + 1, C), -big, dtype=x.dtype, device=x.device)
    xmax.scatter_reduce_(0, idx, x, "amax")
    return xmin[:K], xmax[:K]


def spectral_moments_packed(image: torch.Tensor, labels: torch.Tensor,
                            num_segments: int,
                            valid: Optional[torch.Tensor] = None):
    """All moments with one download: (SPECTRAL_PACK_ORDER,
    (7, K, C) float32 numpy)."""
    out = segment_spectral_moments(image, labels, num_segments, valid)
    packed = torch.stack([out[k] for k in SPECTRAL_PACK_ORDER])
    return SPECTRAL_PACK_ORDER, packed.cpu().numpy()


def spectral_stats_table(image, labels, num_segments: int, valid=None,
                         device=None) -> Dict[str, np.ndarray]:
    """{stat: (K, C) numpy} of :func:`segment_spectral_moments` (``count``
    and :data:`SPECTRAL_STAT_NAMES`) for an (H, W, C) image and (H, W)
    labels, arrays or tensors. It runs on the image's device when that is
    a tensor, else on ``device`` (the card when None), where the labels and
    ``valid`` go too."""
    dev = input_device(image, device)
    out = segment_spectral_moments(
        torch.as_tensor(image, dtype=torch.float32, device=dev),
        torch.as_tensor(labels, dtype=torch.int32, device=dev), num_segments,
        None if valid is None else torch.as_tensor(valid, dtype=torch.bool,
                                                   device=dev))
    return {k: v.cpu().numpy() for k, v in out.items()}
