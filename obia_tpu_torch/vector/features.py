"""Pandas-free feature tables: columns as plain lists, one geometry per
row and a CRS, read from and written to GeoPackage, GeoJSON and ESRI
Shapefile.

The canopy path (:mod:`obia_tpu_torch.utils.seeds`,
:mod:`obia_tpu_torch.utils.cost`) reads and writes its vectors through
this module, so it runs where pandas is not installed. The pandas
``GeoDataFrame`` (:mod:`.geodataframe`) reads and writes through it too:
the format is chosen from the file's extension, as the JAX package's
``read_file`` and ``to_file`` choose it (``obia_tpu/vector/
geodataframe.py:120-184``).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..geometry.crs import CRS
from ..geometry.geom import Geometry, MultiPolygon, Point, Polygon
from ..io import gpkg as gpkg_io

PREDICATES = ("intersects", "within", "contains")

DRIVERS = ("GPKG", "GeoJSON", "ESRI Shapefile")


def driver_of(path) -> str:
    """The format a path's extension names: ``.geojson``/``.json`` is
    GeoJSON, ``.shp`` a shapefile, anything else a GeoPackage."""
    low = str(path).lower()
    if low.endswith((".geojson", ".json")):
        return "GeoJSON"
    if low.endswith(".shp"):
        return "ESRI Shapefile"
    return "GPKG"


class Features:
    """A feature table without pandas: ``columns`` maps each name to a list
    of values, ``geometry`` holds one geometry (or None) per row."""

    def __init__(self, columns: Dict[str, list], geometry: List,
                 crs=None):
        self.columns = {k: list(v) for k, v in columns.items()}
        self.geometry = list(geometry)
        self.crs = CRS.from_user_input(crs) if crs is not None else None

    def __len__(self) -> int:
        return len(self.geometry)

    def __getitem__(self, name: str) -> list:
        return self.columns[name]

    @property
    def total_bounds(self) -> np.ndarray:
        bs = np.array([g.bounds for g in self.geometry if g is not None])
        if len(bs) == 0:
            return np.array([np.nan] * 4)
        return np.array([bs[:, 0].min(), bs[:, 1].min(),
                         bs[:, 2].max(), bs[:, 3].max()])

    def to_crs(self, crs) -> "Features":
        """The table with every geometry reprojected to ``crs`` (the
        supported pairs of :mod:`obia_tpu_torch.geometry.transform_crs`)."""
        return Features(self.columns, reproject(self.geometry, self.crs, crs),
                        crs)

    def to_file(self, path: str, driver: Optional[str] = None,
                layer: Optional[str] = None) -> None:
        write_features(path, list(self.columns.items()), self.geometry,
                       self.crs, driver=driver, layer=layer)


def reproject(geometries: Sequence, src, dst) -> List:
    """Every geometry (None stays None) from CRS ``src`` to ``dst``."""
    from ..geometry.transform_crs import Transformer, transform_geom
    if src is None:
        raise ValueError("to_crs: the table has no source CRS")
    src, dst = CRS.from_user_input(src), CRS.from_user_input(dst)
    if src == dst:
        return list(geometries)
    tr = Transformer.from_crs(src, dst, always_xy=True)
    return [transform_geom(g, tr) if g is not None else None
            for g in geometries]


def read_features(path, layer: Optional[str] = None, bbox=None) -> Features:
    """Read a GeoPackage layer, a GeoJSON file or a shapefile. ``bbox``
    (minx, miny, maxx, maxy) keeps the features whose bounds meet it, and
    rows without a geometry, in every format."""
    driver = driver_of(path)
    if driver == "GPKG":
        cols, geoms, crs = gpkg_io.read_gpkg(str(path), layer=layer,
                                             bbox=bbox)
        return Features(cols, geoms, crs)
    if driver == "ESRI Shapefile":
        from ..io.shapefile import read_shapefile
        cols, geoms, crs = read_shapefile(path)
    else:
        from ..io.geojson import read_geojson
        cols, geoms, crs = read_geojson(path)
    if bbox is not None:
        w, s, e, n = bbox
        keep = [i for i, g in enumerate(geoms)
                if g is None or not (
                    g.bounds[2] < w or g.bounds[0] > e
                    or g.bounds[3] < s or g.bounds[1] > n)]
        geoms = [geoms[i] for i in keep]
        cols = {k: [v[i] for i in keep] for k, v in cols.items()}
    return Features(cols, geoms, crs)


def write_features(path, columns: List[Tuple[str, Sequence]],
                   geometries: Sequence[Geometry], crs=None,
                   driver: Optional[str] = None,
                   layer: Optional[str] = None) -> None:
    """Write ``columns`` (a list of (name, values)) and one geometry a row
    in the format ``driver`` names, or else the path's extension: GPKG,
    GeoJSON or ESRI Shapefile. A None geometry raises, in every format."""
    driver = driver or driver_of(path)
    if driver not in DRIVERS:
        raise ValueError(
            "only GPKG, GeoJSON and ESRI Shapefile output are "
            f"supported, got {driver}")
    if len(geometries) and any(g is None for g in geometries):
        raise ValueError(
            "the table has None geometries — refusing to write empty "
            "blobs (an unresolved polygonisation?)")
    crs = CRS.from_user_input(crs) if crs is not None else None
    if driver == "GeoJSON":
        from ..io.geojson import write_geojson
        write_geojson(path, columns, list(geometries), crs=crs)
    elif driver == "ESRI Shapefile":
        from ..io.shapefile import write_shapefile
        write_shapefile(path, columns, list(geometries), crs=crs)
    else:
        gpkg_io.write_features(str(path), columns, geometries,
                               layer or _layer_from_path(path), crs)


def join_pairs(left: Sequence, right: Sequence,
               predicate: str = "intersects") -> List[Tuple[int, int]]:
    """The (left position, right position) pairs of two geometry lists for
    which ``left.predicate(right)`` holds, in left order and, for each
    left row, right order: the pairs of ``sjoin`` (the JAX package's
    ``obia_tpu/vector/geodataframe.py:186-237``). A None geometry joins
    nothing. Polygons against points take a bounding-box prefilter and a
    vectorised point-in-polygon test for ``intersects`` and ``contains``
    (a point on the boundary counts); every other pair, and every
    ``within``, a bounding-box reject and then the geometries'
    predicate."""
    if predicate not in PREDICATES:
        raise NotImplementedError(f"predicate {predicate!r} not supported")
    pairs: List[Tuple[int, int]] = []
    all_points = all(isinstance(g, Point) for g in right if g is not None)
    all_polys = all(isinstance(g, (Polygon, MultiPolygon))
                    for g in left if g is not None)
    if all_points and all_polys and predicate != "within":
        xs = np.array([g.x if g is not None else np.nan for g in right])
        ys = np.array([g.y if g is not None else np.nan for g in right])
        for li, lg in enumerate(left):
            if lg is None:
                continue
            b = lg.bounds
            cand = np.nonzero((xs >= b[0]) & (xs <= b[2])
                              & (ys >= b[1]) & (ys <= b[3]))[0]
            if len(cand) == 0:
                continue
            hit = lg.contains_points(xs[cand], ys[cand])
            pairs.extend((li, int(ri)) for ri in cand[hit])
        return pairs
    rbounds = np.array([g.bounds if g is not None else (np.nan,) * 4
                        for g in right]).reshape(-1, 4)
    for li, lg in enumerate(left):
        if lg is None:
            continue
        b = lg.bounds
        cand = np.nonzero(~((rbounds[:, 2] < b[0]) | (b[2] < rbounds[:, 0])
                            | (rbounds[:, 3] < b[1])
                            | (b[3] < rbounds[:, 1])))[0]
        for ri in cand:
            rg = right[ri]
            if rg is None:
                continue
            ok = (lg.intersects(rg) if predicate == "intersects"
                  else lg.within(rg) if predicate == "within"
                  else rg.within(lg))
            if ok:
                pairs.append((li, int(ri)))
    return pairs


def _layer_from_path(path) -> str:
    return os.path.splitext(os.path.basename(str(path)))[0] or "layer"
