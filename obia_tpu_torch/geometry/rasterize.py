"""Scanline polygon rasterisation (the port's copy of
``obia_tpu/geometry/rasterize.py``; rasterio.features.rasterize /
geometry_mask semantics).

Fills pixels whose centers fall inside the polygon (GDAL default
all_touched=False semantics). Pure numpy; operates in world coordinates via
the inverse affine.
"""
from __future__ import annotations

from typing import Iterable, Optional

import numpy as np

from .affine import Affine
from .geom import Geometry, MultiPolygon, Polygon, affine_transform


def _fill_ring(ring: np.ndarray, acc: np.ndarray, parity: np.ndarray):
    """Accumulate crossing parity for one ring over the pixel-center grid.
    ring is in pixel coordinates (x=col, y=row)."""
    H, W = parity.shape
    x1, y1 = ring[:-1, 0], ring[:-1, 1]
    x2, y2 = ring[1:, 0], ring[1:, 1]
    for i in range(len(x1)):
        ya, yb = y1[i], y2[i]
        if ya == yb:
            continue
        xa, xb = x1[i], x2[i]
        ylo, yhi = (ya, yb) if ya < yb else (yb, ya)
        # pixel-center rows are at r + 0.5; the edge claims rows with
        # ylo <= yc < yhi (HALF-OPEN: a vertex lying exactly on a center
        # row must toggle once, not once per incident edge — an inclusive
        # upper end double-toggles there and inverts the rest of the row)
        r0 = max(0, int(np.ceil(ylo - 0.5)))
        r1 = min(H - 1, int(np.ceil(yhi - 0.5)) - 1)
        if r1 < r0:
            continue
        rows = np.arange(r0, r1 + 1)
        yc = rows + 0.5
        t = (yc - ya) / (yb - ya)
        xint = xa + t * (xb - xa)
        # crossing toggles all pixels with center x > xint  (col + 0.5 > xint)
        cstart = np.clip(np.ceil(xint - 0.5).astype(int), 0, W)
        for r, c in zip(rows, cstart):
            if c < W:
                parity[r, c:] ^= True


def _geom_mask_pixel(geom: Geometry, H: int, W: int) -> np.ndarray:
    """Boolean inside-mask for a geometry already in pixel coordinates."""
    parity = np.zeros((H, W), bool)
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
    for r in rings:
        _fill_ring(r, None, parity)
    return parity


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
        gp = _to_pixel(g, transform)
        inside |= _geom_mask_pixel(gp, H, W)
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
        gp = _to_pixel(geom, transform)
        m = _geom_mask_pixel(gp, H, W)
        out[m] = value
    return out
