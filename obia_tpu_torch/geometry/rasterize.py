"""Scanline polygon rasterisation (the port's copy of
``obia_tpu/geometry/rasterize.py``; rasterio.features.rasterize /
geometry_mask semantics).

Fills pixels whose centers fall inside the polygon (GDAL default
all_touched=False semantics). Pure numpy; operates in world coordinates via
the inverse affine. Each geometry is filled over the window of pixels its
rings span, not the whole raster: outside it no crossing toggles a pixel
(a closed ring crosses each row an even number of times), so the masks are
the reference's.
"""
from __future__ import annotations

from typing import Iterable, Optional

import numpy as np

from .affine import Affine
from .geom import Geometry, MultiPolygon, Polygon, affine_transform


def _ring_crossings(ring: np.ndarray, H: int, W: int):
    """(rows, cols) of every crossing of one ring with the pixel-center
    rows of an H x W raster: a crossing toggles the pixels of its row from
    its column on (center x > the crossing's x). ring is in pixel
    coordinates (x=col, y=row)."""
    xa, ya = ring[:-1, 0], ring[:-1, 1]
    xb, yb = ring[1:, 0], ring[1:, 1]
    edge = ya != yb
    xa, ya, xb, yb = xa[edge], ya[edge], xb[edge], yb[edge]
    # pixel-center rows are at r + 0.5; the edge claims rows with
    # ylo <= yc < yhi (HALF-OPEN: a vertex lying exactly on a center row
    # must toggle once, not once per incident edge — an inclusive upper
    # end double-toggles there and inverts the rest of the row)
    r0 = np.maximum(0, np.ceil(np.minimum(ya, yb) - 0.5).astype(int))
    r1 = np.minimum(H - 1, np.ceil(np.maximum(ya, yb) - 0.5).astype(int) - 1)
    n = np.maximum(r1 - r0 + 1, 0)
    e = np.repeat(np.arange(len(n)), n)
    rows = r0[e] + np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)
    t = (rows + 0.5 - ya[e]) / (yb[e] - ya[e])
    xint = xa[e] + t * (xb[e] - xa[e])
    cols = np.clip(np.ceil(xint - 0.5).astype(int), 0, W)
    return rows, cols


def _geom_mask_window(geom: Geometry, H: int, W: int):
    """(r0, c0, mask): the boolean inside-mask of a geometry already in
    pixel coordinates over the window of the H x W raster its rings span,
    the window's first pixel at (r0, c0). Each pixel's parity is the count
    of its row's crossings at or before its column, over every ring."""
    if isinstance(geom, Polygon):
        rings = [geom.exterior.coords_array] + [h.coords_array
                                                for h in geom.interiors]
    elif isinstance(geom, MultiPolygon):
        rings = []
        for g in geom.geoms:
            rings.extend([g.exterior.coords_array]
                         + [h.coords_array for h in g.interiors])
    else:
        raise TypeError(f"cannot rasterise {type(geom)}")
    rings = [r for r in rings if len(r)]
    if not rings:
        return 0, 0, np.zeros((0, 0), bool)
    pts = np.concatenate(rings)
    r0 = min(H, max(0, int(np.ceil(pts[:, 1].min() - 0.5))))
    r1 = min(H, max(r0, int(np.ceil(pts[:, 1].max() - 0.5))))
    c0 = min(W, max(0, int(np.ceil(pts[:, 0].min() - 0.5))))
    c1 = min(W, max(c0, int(np.ceil(pts[:, 0].max() - 0.5))))
    h, w = r1 - r0, c1 - c0
    rows, cols = zip(*(_ring_crossings(r, H, W) for r in rings))
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    hit = cols < c1
    starts = np.bincount((rows[hit] - r0) * (w + 1)
                         + np.maximum(cols[hit] - c0, 0),
                         minlength=h * (w + 1)).reshape(h, w + 1)
    return r0, c0, (np.cumsum(starts[:, :w], axis=1) & 1).astype(bool)


def _to_pixel(geom: Geometry, transform: Optional[Affine]) -> Geometry:
    if transform is None:
        return geom
    inv = ~transform
    return affine_transform(geom, [inv.a, inv.b, inv.d, inv.e, inv.c, inv.f])


def geometry_mask(geometries: Iterable[Geometry], out_shape, transform=None,
                  invert: bool = False) -> np.ndarray:
    """rasterio.features.geometry_mask compatible: True OUTSIDE the
    geometries by default; ``invert=True`` gives True inside."""
    H, W = out_shape
    inside = np.zeros((H, W), bool)
    for g in geometries:
        if g is None:
            continue
        r0, c0, m = _geom_mask_window(_to_pixel(g, transform), H, W)
        inside[r0:r0 + m.shape[0], c0:c0 + m.shape[1]] |= m
    return inside if invert else ~inside


def rasterize(shapes: Iterable, out_shape, transform=None, fill=0,
              dtype=np.int64, all_touched: bool = False) -> np.ndarray:
    """rasterio.features.rasterize compatible subset: ``shapes`` is an
    iterable of geometries or (geometry, value) pairs; later shapes
    overwrite earlier ones."""
    H, W = out_shape
    out = np.full((H, W), fill, dtype=dtype)
    for item in shapes:
        if isinstance(item, tuple):
            geom, value = item
        else:
            geom, value = item, 1
        if geom is None:
            continue
        r0, c0, m = _geom_mask_window(_to_pixel(geom, transform), H, W)
        out[r0:r0 + m.shape[0], c0:c0 + m.shape[1]][m] = value
    return out
