"""GeoJSON (RFC 7946) reader and writer (the port's copy of
``obia_tpu/io/geojson.py``).

The reference reaches GeoJSON through geopandas/fiona's ``read_file`` /
``to_file``; this module gives :func:`obia_tpu_torch.vector.features.
read_features` and ``GeoDataFrame.to_file`` the same route without GDAL.
Geometries map onto the port's planar types (Point, LineString, Polygon and
MultiPolygon); MultiPoint and MultiLineString are not modelled and raise an
error naming the gap.

RFC 7946 removed the ``crs`` member (coordinates are CRS84), but projected
data still round-trips the legacy named-CRS member: it is written when an
EPSG code is known and honoured on read.
"""
from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..geometry.crs import CRS
from ..geometry.geom import (Geometry, LineString, MultiPolygon, Point,
                             Polygon)


def _coords_of(geom: Geometry):
    if isinstance(geom, Point):
        return "Point", [geom.x, geom.y]
    if isinstance(geom, LineString):
        return "LineString", np.asarray(geom.coords, float).tolist()
    if isinstance(geom, Polygon):
        rings = [np.asarray(geom.exterior.coords, float).tolist()]
        rings += [np.asarray(r.coords, float).tolist()
                  for r in geom.interiors]
        return "Polygon", rings
    if isinstance(geom, MultiPolygon):
        polys = []
        for p in geom.geoms:
            rings = [np.asarray(p.exterior.coords, float).tolist()]
            rings += [np.asarray(r.coords, float).tolist()
                      for r in p.interiors]
            polys.append(rings)
        return "MultiPolygon", polys
    raise ValueError(
        f"cannot write {type(geom).__name__} as GeoJSON (supported: "
        "Point, LineString, Polygon, MultiPolygon)")


def _geom_of(obj: dict) -> Optional[Geometry]:
    if obj is None:
        return None
    typ = obj.get("type")
    c = obj.get("coordinates")
    if typ == "Point":
        return Point(float(c[0]), float(c[1]))
    if typ == "LineString":
        return LineString([(float(x), float(y)) for x, y, *_ in c])
    if typ == "Polygon":
        shell = [(float(x), float(y)) for x, y, *_ in c[0]]
        holes = [[(float(x), float(y)) for x, y, *_ in ring]
                 for ring in c[1:]]
        return Polygon(shell, holes)
    if typ == "MultiPolygon":
        polys = []
        for rings in c:
            shell = [(float(x), float(y)) for x, y, *_ in rings[0]]
            holes = [[(float(x), float(y)) for x, y, *_ in ring]
                     for ring in rings[1:]]
            polys.append(Polygon(shell, holes))
        return MultiPolygon(polys)
    raise ValueError(f"unsupported GeoJSON geometry type {typ!r}")


def _json_safe(v):
    if v is None:
        return None
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating, float)):
        f = float(v)
        return None if math.isnan(f) or math.isinf(f) else f
    if isinstance(v, (np.bool_,)):
        return bool(v)
    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    if isinstance(v, np.ndarray):
        return [_json_safe(x) for x in v.tolist()]
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    if isinstance(v, (str, int, bool)):
        return v
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    # datetimes, Timestamps, Decimals, ... — stringify rather than let
    # json.dump raise mid-write and leave a truncated file behind
    iso = getattr(v, "isoformat", None)
    return iso() if callable(iso) else str(v)


def write_geojson(path: Union[str, os.PathLike],
                  cols: Sequence[Tuple[str, Sequence]],
                  geoms: Sequence[Optional[Geometry]],
                  crs: Optional[CRS] = None) -> None:
    """Write columns + geometries as a GeoJSON FeatureCollection."""
    features = []
    for i, geom in enumerate(geoms):
        props = {name: _json_safe(values[i]) for name, values in cols}
        features.append({
            "type": "Feature",
            "properties": props,
            "geometry": None if geom is None else dict(
                zip(("type", "coordinates"), _coords_of(geom))),
        })
    doc: Dict = {"type": "FeatureCollection", "features": features}
    if crs is not None:
        epsg = crs.to_epsg()
        if epsg:
            doc["crs"] = {"type": "name", "properties": {
                "name": f"urn:ogc:def:crs:EPSG::{epsg}"}}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, separators=(",", ":"))


def read_geojson(path: Union[str, os.PathLike]
                 ) -> Tuple[Dict[str, list], List[Optional[Geometry]],
                            Optional[CRS]]:
    """Read a FeatureCollection (or single Feature / bare geometry).

    Returns (columns, geometries, crs) in the same shape as
    :func:`obia_tpu_torch.io.gpkg.read_gpkg`.
    """
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    typ = doc.get("type")
    if typ == "FeatureCollection":
        features = doc.get("features", [])
    elif typ == "Feature":
        features = [doc]
    elif typ in ("Point", "LineString", "Polygon", "MultiPolygon"):
        features = [{"type": "Feature", "properties": {}, "geometry": doc}]
    else:
        raise ValueError(f"{path}: unsupported GeoJSON root type {typ!r}")

    crs = None
    crs_name = (doc.get("crs") or {}).get("properties", {}).get("name", "")
    if "EPSG" in crs_name.upper():
        digits = "".join(ch for ch in crs_name.split(":")[-1]
                         if ch.isdigit())
        if digits:
            crs = CRS.from_epsg(int(digits))
    elif "CRS84" in crs_name:
        crs = CRS.from_epsg(4326)

    geoms: List[Optional[Geometry]] = []
    col_names: List[str] = []
    rows: List[dict] = []
    for feat in features:
        geoms.append(_geom_of(feat.get("geometry")))
        props = feat.get("properties") or {}
        for k in props:
            if k not in col_names:
                col_names.append(k)
        rows.append(props)
    cols = {name: [row.get(name) for row in rows] for name in col_names}
    return cols, geoms, crs
