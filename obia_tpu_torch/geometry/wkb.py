"""Well-Known-Binary encode/decode (the port's copy of
``obia_tpu/geometry/wkb.py``): ISO WKB Point, LineString, Polygon and
MultiPolygon, little-endian on write, either endianness on read, for
GeoPackage feature blobs."""
from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

from .geom import Geometry, LineString, MultiPolygon, Point, Polygon

WKB_POINT = 1
WKB_LINESTRING = 2
WKB_POLYGON = 3
WKB_MULTIPOLYGON = 6


def dumps(geom: Geometry) -> bytes:
    out = bytearray()
    _write_geom(out, geom)
    return bytes(out)


def _write_geom(out: bytearray, geom: Geometry) -> None:
    out += b"\x01"  # little-endian
    if isinstance(geom, Point):
        out += struct.pack("<I2d", WKB_POINT, geom.x, geom.y)
    elif isinstance(geom, LineString):
        c = geom.coords_array
        out += struct.pack("<II", WKB_LINESTRING, len(c))
        out += np.ascontiguousarray(c, dtype="<f8").tobytes()
    elif isinstance(geom, Polygon):
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


def loads(data: bytes) -> Geometry:
    geom, _ = _read_geom(data, 0)
    return geom


def _read_geom(buf: bytes, pos: int) -> Tuple[Geometry, int]:
    bo = "<" if buf[pos] == 1 else ">"
    pos += 1
    (gtype,) = struct.unpack_from(bo + "I", buf, pos)
    pos += 4
    # EWKB sets high-bit flags (Z=0x80000000, M=0x40000000,
    # SRID=0x20000000 followed by a 4-byte SRID); ISO WKB adds 1000 (Z),
    # 2000 (M) or 3000 (ZM) to the base code. Z/M ordinates are parsed
    # and dropped (the geometry is 2-D), the SRID is skipped.
    ewkb_z = bool(gtype & 0x80000000)
    ewkb_m = bool(gtype & 0x40000000)
    if gtype & 0x20000000:
        pos += 4  # embedded SRID
    code = gtype & 0x1FFFFFFF
    iso_kind = code // 1000  # 0 plain, 1 Z, 2 M, 3 ZM
    base = code % 1000
    dim = (2 + (1 if (ewkb_z or iso_kind in (1, 3)) else 0)
           + (1 if (ewkb_m or iso_kind in (2, 3)) else 0))

    def read_coords(n: int, p: int):
        c = np.frombuffer(buf, dtype=bo + "f8", count=n * dim, offset=p)
        return c.reshape(n, dim)[:, :2].astype(np.float64), p + n * dim * 8

    if base == WKB_POINT:
        c, pos = read_coords(1, pos)
        return Point(c[0, 0], c[0, 1]), pos
    if base == WKB_LINESTRING:
        (n,) = struct.unpack_from(bo + "I", buf, pos)
        pos += 4
        c, pos = read_coords(n, pos)
        return LineString(c), pos
    if base == WKB_POLYGON:
        (nrings,) = struct.unpack_from(bo + "I", buf, pos)
        pos += 4
        rings = []
        for _ in range(nrings):
            (n,) = struct.unpack_from(bo + "I", buf, pos)
            pos += 4
            c, pos = read_coords(n, pos)
            rings.append(c)
        if not rings:
            return Polygon(), pos
        return Polygon(rings[0], rings[1:]), pos
    if base == WKB_MULTIPOLYGON:
        (ngeoms,) = struct.unpack_from(bo + "I", buf, pos)
        pos += 4
        polys = []
        for _ in range(ngeoms):
            g, pos = _read_geom(buf, pos)
            polys.append(g)
        return MultiPolygon(polys), pos
    raise ValueError(f"unsupported WKB geometry type {gtype}")
