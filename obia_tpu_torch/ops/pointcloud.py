"""Per-segment point-cloud structural and radiometric statistics (port of
``obia_tpu/ops/pointcloud.py``), on the device of the label raster.

Points (a structured array or a dict with ``X``/``Y``/``Z`` and optional
``Intensity``, in the raster's CRS) are assigned to segments through the
label raster, then reduced per segment:

* **CH** (canopy height): the max of Z (Z is height-normalised);
* **FHD** (foliage height diversity): ``-sum p_i ln p_i`` over the
  segment's returns in ``dz``-sized layers above its lowest return;
* **PAI** (plant area index): ``ln(N_total / N_ground)``, ground being the
  lowest layer; NaN without ground returns or without returns;
* **mean/variance intensity**: the moments of ``Intensity`` (the variance
  in two passes).

Everything is float64. The JAX package reduces with numpy on the host; the
port reduces where the label raster already is, the card on the main path.
Counts, CH and the layer indices are exact there. The intensity sums are
taken in a fixed order (``index_put_`` with ``accumulate``, which sorts the
segment ids on the card, where ``index_add_`` would add with atomics), so
two runs give the same bits; that order may still differ from numpy's
sequential sums in the last bits.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def _field(points, name: str):
    if isinstance(points, np.ndarray) and points.dtype.names:
        return np.asarray(points[name]) if name in points.dtype.names else None
    if isinstance(points, dict):
        v = points.get(name)
        return None if v is None else np.asarray(v)
    return None


def _f64(values, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(values, np.float64)).to(
        device)


def assign_points_to_segments(points, labels: torch.Tensor, transform
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(seg, keep): each kept point's segment id, and which points were
    kept, on ``labels.device``. A point's pixel is ``floor`` of the inverse
    affine in float64, each product and sum rounded on its own as numpy
    rounds them (no fused multiply-add), so a point on a pixel edge lands
    on the reference's pixel. Points outside the raster, with a non-finite
    coordinate, or on unlabelled (< 0) pixels are dropped."""
    x = _field(points, "X")
    y = _field(points, "Y")
    if x is None or y is None:
        raise ValueError("point cloud must provide 'X' and 'Y' fields")
    dev = labels.device
    x, y = _f64(x, dev), _f64(y, dev)
    inv = ~transform
    col = torch.floor(inv.a * x + inv.b * y + inv.c)
    row = torch.floor(inv.d * x + inv.e * y + inv.f)
    H, W = labels.shape
    inside = (row >= 0) & (row < H) & (col >= 0) & (col < W)
    seg = torch.full(x.shape, -1, dtype=torch.int64, device=dev)
    seg[inside] = labels[row[inside].long(), col[inside].long()].long()
    keep = seg >= 0
    return seg[keep], keep


def _counts(seg: torch.Tensor, K: int) -> torch.Tensor:
    return torch.bincount(seg, minlength=K)[:K]


def _sums(seg: torch.Tensor, values: torch.Tensor, K: int) -> torch.Tensor:
    """Per-segment float64 sums, reproducible run to run."""
    return torch.zeros(K, dtype=torch.float64, device=values.device
                       ).index_put_((seg,), values, accumulate=True)


def segment_pointcloud_stats(points, labels: torch.Tensor, transform,
                             num_segments: int,
                             voxel_resolution: Optional[float] = None,
                             calc_pai: bool = True, calc_fhd: bool = True,
                             calc_ch: bool = True,
                             calc_mean_intensity: bool = True,
                             calc_variance_intensity: bool = True
                             ) -> Dict[str, np.ndarray]:
    """Every requested per-segment statistic as a (K,) float64 numpy array
    (NaN: no data), reduced on ``labels.device``.

    ``labels``: (H, W) integer label raster (-1 unlabelled); ``transform``:
    its pixel -> world affine; ``voxel_resolution``: the layer height dz,
    required for PAI and FHD. A NaN Z makes its segment's CH NaN, as
    ``np.maximum.at`` does; PAI counts the segment's returns as not ground
    (its lowest return is NaN), and FHD raises ``IndexError``, as the JAX
    package's ``np.add.at`` does on the NaN layer.
    """
    K = int(num_segments)
    out: Dict[str, np.ndarray] = {}
    if (calc_pai or calc_fhd) and voxel_resolution is None:
        raise ValueError("voxel_resolution is required for PAI/FHD")
    dev = labels.device
    nan = torch.tensor(float("nan"), dtype=torch.float64, device=dev)

    seg, keep = assign_points_to_segments(points, labels, transform)
    n_total = _counts(seg, K).to(torch.float64)
    has = n_total > 0
    per_obj = torch.clamp(n_total, min=1.0)

    if calc_pai or calc_fhd or calc_ch:
        z = _field(points, "Z")
        if z is None:
            raise ValueError("point cloud must provide 'Z' for structural "
                             "statistics")
        z = _f64(z, dev)[keep]
        # a segment with a NaN return: NaN max and min (np.maximum.at and
        # np.minimum.at propagate it; scatter_reduce need not)
        nan_seg = _counts(seg[torch.isnan(z)], K) > 0
        if calc_ch:
            ch = torch.full((K,), -float("inf"), dtype=torch.float64,
                            device=dev).scatter_reduce_(0, seg, z, "amax")
            out["ch"] = torch.where(has & ~nan_seg, ch, nan)
        if calc_pai or calc_fhd:
            zmin = torch.full((K,), float("inf"), dtype=torch.float64,
                              device=dev).scatter_reduce_(0, seg, z, "amin")
            zmin = torch.where(nan_seg, nan, torch.where(has, zmin, 0.0))
            layer = torch.clamp(torch.floor(
                (z - zmin[seg]) / float(voxel_resolution)), min=0.0)
            if calc_pai:
                n_ground = _counts(seg[layer == 0], K)
                pai = torch.log(n_total / n_ground)
                out["pai"] = torch.where(has & (n_ground > 0), pai, nan)
            if calc_fhd:
                if not bool(torch.isfinite(layer).all()):
                    raise IndexError(
                        "a return's height layer is not finite (NaN or "
                        "infinite Z): FHD's layer table cannot index it")
                lay = layer.long()
                nl = int(lay.max()) + 1 if lay.numel() else 1
                hist = torch.bincount(seg * nl + lay, minlength=K * nl)[
                    :K * nl].reshape(K, nl).to(torch.float64)
                p = hist / per_obj[:, None]
                ent = -torch.where(p > 0, p * torch.log(p), 0.0).sum(dim=1)
                out["fhd"] = torch.where(has, ent, nan)

    if calc_mean_intensity or calc_variance_intensity:
        inten = _field(points, "Intensity")
        if inten is None:
            empty = torch.full((K,), float("nan"), dtype=torch.float64)
            if calc_mean_intensity:
                out["mean_intensity"] = empty
            if calc_variance_intensity:
                out["variance_intensity"] = empty.clone()
        else:
            inten = _f64(inten, dev)[keep]
            mean = torch.where(has, _sums(seg, inten, K) / per_obj, nan)
            if calc_mean_intensity:
                out["mean_intensity"] = mean
            if calc_variance_intensity:
                d = inten - torch.nan_to_num(mean, nan=0.0)[seg]
                out["variance_intensity"] = torch.where(
                    has, _sums(seg, d * d, K) / per_obj, nan)
    return {k: v.cpu().numpy() for k, v in out.items()}
