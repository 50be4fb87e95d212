"""Label rasters -> polygons (the port's counterpart of
``obia_tpu/geometry/polygonize.py``).

The port's native polygoniser (:mod:`obia_tpu_torch.native`) traces every
label of a row-wise RLE raster into closed rectilinear rings with a
right-turn-first rule (so regions touching only at a corner separate,
matching GDAL 4-connectivity semantics). Here the rings of each label are
grouped: positive signed area in (col, row) space is an exterior, negative
a hole, assigned to the exterior that contains it. A dense raster is
run-length encoded first (:func:`polygonize_labels`); there is no
numpy tracer to fall back on.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .geom import Polygon, affine_transform_coords


def _polygons_with_holes(exteriors: List[np.ndarray],
                         holes: List[np.ndarray]) -> List[Polygon]:
    """One Polygon per exterior; each hole goes to the exterior containing
    its first vertex (single shared implementation — every polygonise
    entry point assembles rings through here). A hole no exterior contains
    (degenerate input) is dropped."""
    if len(exteriors) == 1:
        return [Polygon(exteriors[0], holes)]
    polys = [Polygon(e) for e in exteriors]
    hole_lists: List[List[np.ndarray]] = [[] for _ in exteriors]
    for h in holes:
        px, py = h[0, 0], h[0, 1]
        for i, p in enumerate(polys):
            if p.contains_points(np.array(px), np.array(py)):
                hole_lists[i].append(h)
                break
    return [Polygon(e, hl) for e, hl in zip(exteriors, hole_lists)]


def group_rings_packed(labels: np.ndarray, areas: np.ndarray,
                       offsets: np.ndarray, coords: np.ndarray
                       ) -> Dict[int, List[Polygon]]:
    """Packed-array analog of ``_group_rings``: ring i is
    ``coords[offsets[i]:offsets[i+1]]``; ``areas`` carry the PIXEL-space
    signed area (sign classifies exterior vs hole even when ``coords``
    were already affine-transformed to world space, where a y-flip would
    negate recomputed areas). The single-exterior common case builds its
    Polygon straight from the slice — no per-ring dicts or lists."""
    out: Dict[int, List[Polygon]] = {}
    n = len(labels)
    if n == 0:
        return out
    order = np.argsort(labels, kind="stable")
    lab_s = labels[order]
    starts = np.concatenate([[0], np.flatnonzero(np.diff(lab_s)) + 1, [n]])
    pos = areas > 0
    for gi in range(len(starts) - 1):
        grp = order[starts[gi]:starts[gi + 1]]
        label = int(lab_s[starts[gi]])
        if len(grp) == 1 and pos[grp[0]]:
            i = int(grp[0])
            out[label] = [Polygon(coords[offsets[i]:offsets[i + 1]])]
            continue
        exteriors = []
        holes = []
        for i in grp:
            c = coords[offsets[i]:offsets[i + 1]]
            (exteriors if pos[i] else holes).append(c)
        out[label] = _polygons_with_holes(exteriors, holes)
    return out


def polygonize_labels_rle(values: np.ndarray, lengths: np.ndarray, shape,
                          simplify: bool = True,
                          affine: Optional[Sequence[float]] = None
                          ) -> Dict[int, List[Polygon]]:
    """{label: [Polygon, ...]} of every non-negative label of a row-wise
    RLE raster (runs break at row ends), one Polygon with its holes per
    connected region, in pixel-corner (col, row) coordinates, or through
    the shapely-order ``affine`` when given. ``simplify`` drops collinear
    corners."""
    from .. import native
    rlabels, n_pts, areas, coords = native.polygonize_rings_rle_packed(
        values, lengths, shape, simplify=simplify)
    if affine is not None:
        coords = affine_transform_coords(coords, affine)
    offsets = np.concatenate([[0], np.cumsum(n_pts)])
    return group_rings_packed(rlabels, areas, offsets, coords)


def polygonize_labels(labels, simplify: bool = True
                      ) -> Dict[int, List[Polygon]]:
    """:func:`polygonize_labels_rle` of a dense (H, W) label raster (an
    array, or a tensor, encoded on its device)."""
    import torch

    from ..ops.slic import download_labels_rle
    return polygonize_labels_rle(*download_labels_rle(torch.as_tensor(
        labels)), simplify=simplify)
