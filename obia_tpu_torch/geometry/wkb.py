"""Well-Known-Binary encoding (the port's copy of the writer of
``obia_tpu/geometry/wkb.py``): ISO WKB Polygon and MultiPolygon,
little-endian, for GeoPackage feature blobs."""
from __future__ import annotations

import struct

import numpy as np

from .geom import Geometry, MultiPolygon, Polygon

WKB_POLYGON = 3
WKB_MULTIPOLYGON = 6


def dumps(geom: Geometry) -> bytes:
    out = bytearray()
    _write_geom(out, geom)
    return bytes(out)


def _write_geom(out: bytearray, geom: Geometry) -> None:
    out += b"\x01"  # little-endian
    if isinstance(geom, Polygon):
        rings = [geom.exterior.coords_array] + [h.coords_array for h in geom.interiors]
        rings = [r for r in rings if len(r)]
        out += struct.pack("<II", WKB_POLYGON, len(rings))
        for r in rings:
            out += struct.pack("<I", len(r))
            out += np.ascontiguousarray(r, dtype="<f8").tobytes()
    elif isinstance(geom, MultiPolygon):
        out += struct.pack("<II", WKB_MULTIPOLYGON, len(geom.geoms))
        for g in geom.geoms:
            _write_geom(out, g)
    else:
        raise TypeError(f"cannot WKB-encode {type(geom)}")
