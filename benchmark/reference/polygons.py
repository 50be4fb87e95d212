"""What each object's polygon must measure, from the label raster.

A label's pixels are unit squares, so its polygon (exterior rings minus
holes) has as much area as the label has pixels, as long a boundary as
the label has pixel edges against other labels and the raster's border,
and the label's bounding box. With 1-unit pixels all three are integers,
which the shoelace sums of integer corners give exactly in float64: the
comparison is exact.
"""
from __future__ import annotations

import numpy as np
import torch


def label_measures(labels: torch.Tensor, K: int) -> dict:
    """{"area", "perimeter"} (K,) int64 and "bbox" (K, 4) int64
    [row min, row max, col min, col max] of labels 0..K-1."""
    lab = labels.long()
    H, W = lab.shape
    dev = lab.device
    area = torch.bincount(lab.reshape(-1), minlength=K)
    edges = torch.zeros(K, dtype=torch.int64, device=dev)
    for a, b in ((lab[:, :-1], lab[:, 1:]), (lab[:-1, :], lab[1:, :])):
        diff = a != b
        edges += torch.bincount(a[diff], minlength=K)
        edges += torch.bincount(b[diff], minlength=K)
    for border in (lab[0], lab[-1], lab[:, 0], lab[:, -1]):
        edges += torch.bincount(border, minlength=K)
    rows = torch.arange(H, device=dev)[:, None].expand(H, W).reshape(-1)
    cols = torch.arange(W, device=dev)[None, :].expand(H, W).reshape(-1)
    flat = lab.reshape(-1)
    big = H + W

    def red(v, how, init):
        return torch.full((K,), init, dtype=torch.int64,
                          device=dev).scatter_reduce_(0, flat, v, how)

    bbox = torch.stack([red(rows, "amin", big), red(rows, "amax", -1),
                        red(cols, "amin", big), red(cols, "amax", -1)], 1)
    return {"area": area.cpu().numpy(), "perimeter": edges.cpu().numpy(),
            "bbox": bbox.cpu().numpy()}


def ring_measures(rings: list) -> tuple:
    """(area, boundary length, (xmin, ymin, xmax, ymax)) of one object
    from its rings, each ``(coords (n, 2) float64, is_hole)``, closed."""
    area = 0.0
    length = 0.0
    lo = np.array([np.inf, np.inf])
    hi = np.array([-np.inf, -np.inf])
    for c, hole in rings:
        x, y = c[:-1, 0], c[:-1, 1]
        a = abs(0.5 * float(np.sum(x * c[1:, 1] - c[1:, 0] * y)))
        area += -a if hole else a
        length += float(np.abs(np.diff(c, axis=0)).sum())
        if not hole:
            lo = np.minimum(lo, c.min(axis=0))
            hi = np.maximum(hi, c.max(axis=0))
    return area, length, (lo[0], lo[1], hi[0], hi[1])


def polygon_faults(objects: list, labels: torch.Tensor, K: int,
                   height: int) -> int:
    """Objects whose polygon does not measure as its label does, plus the
    objects missing or in excess. ``objects[k]`` is the rings of object k
    in world coordinates of 1-unit pixels with y = height - row."""
    m = label_measures(labels, K)
    faults = abs(len(objects) - K)
    for k, rings in enumerate(objects[:K]):
        area, length, (x0, y0, x1, y1) = ring_measures(rings)
        r0, r1, c0, c1 = m["bbox"][k]
        want = (c0, height - (r1 + 1), c1 + 1, height - r0)
        if (area != m["area"][k] or length != m["perimeter"][k]
                or (x0, y0, x1, y1) != want):
            faults += 1
    return faults
