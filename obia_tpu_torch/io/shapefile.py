"""ESRI Shapefile codec, .shp/.shx/.dbf/.prj (the port's copy of
``obia_tpu/io/shapefile.py``).

The reference reads vectors through geopandas/fiona, which takes
shapefiles transparently; this module gives :func:`obia_tpu_torch.vector.
features.read_features` and ``GeoDataFrame.to_file`` the same route without
GDAL. It implements the published ESRI white-paper format:

  * shapes: Null, Point(Z/M), PolyLine(Z/M), Polygon(Z/M); Z/M values
    are skipped on read (the geometry is planar); MultiPoint raises (the
    port's geometry has no such type)
  * polygon ring assembly: clockwise rings are shells, counter-clockwise
    rings are holes matched to the innermost containing shell;
    multi-shell records become MultiPolygon
  * attributes: dBase III (.dbf): C (text), N/F (numeric), L (logical),
    D (date, returned as ISO string); Latin-1 text
  * CRS: .prj WKT via :meth:`obia_tpu_torch.geometry.crs.CRS.from_wkt`

The writer emits Point / PolyLine / Polygon records (+ .shx index,
.dbf attributes, .prj when an EPSG/WKT is known).
"""
from __future__ import annotations

import datetime
import math
import os
import struct
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..geometry.crs import CRS
from ..geometry.geom import (Geometry, LineString, MultiPolygon, Point,
                             Polygon)

_SHP_NULL = 0
_SHP_POINT = {1, 11, 21}
_SHP_POLYLINE = {3, 13, 23}
_SHP_POLYGON = {5, 15, 25}
_SHP_MULTIPOINT = {8, 18, 28}


def _ring_signed_area(xy: np.ndarray) -> float:
    x, y = xy[:, 0], xy[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def _assemble_polygon(rings: List[np.ndarray]) -> Geometry:
    """ESRI ring rules: CW shells, CCW holes inside some shell."""
    shells: List[Tuple[np.ndarray, List[np.ndarray]]] = []
    holes: List[np.ndarray] = []
    for r in rings:
        if _ring_signed_area(r) <= 0:  # clockwise → shell
            shells.append((r, []))
        else:
            holes.append(r)
    if not shells:  # degenerate file: treat every ring as a shell
        shells, holes = [(r, []) for r in rings], []
    from ..geometry.geom import _points_in_ring
    for h in holes:
        px, py = float(h[0, 0]), float(h[0, 1])
        target = shells[0][1]
        for shell_ring, shell_holes in shells:
            if bool(_points_in_ring(shell_ring, px, py)):
                target = shell_holes
                break
        target.append(h)
    polys = [Polygon([tuple(p) for p in shell],
                     holes=[[tuple(p) for p in h] for h in hs])
             for shell, hs in shells]
    return polys[0] if len(polys) == 1 else MultiPolygon(polys)


def _read_shp(buf: bytes) -> List[Optional[Geometry]]:
    if len(buf) < 100 or struct.unpack_from(">i", buf, 0)[0] != 9994:
        raise ValueError("not a shapefile (.shp magic 9994 missing)")
    geoms: List[Optional[Geometry]] = []
    pos = 100
    n = len(buf)
    while pos + 8 <= n:
        _recno, clen = struct.unpack_from(">ii", buf, pos)
        pos += 8
        end = pos + 2 * clen
        if end > n:
            break
        stype, = struct.unpack_from("<i", buf, pos)
        if stype == _SHP_NULL:
            geoms.append(None)
        elif stype in _SHP_POINT:
            x, y = struct.unpack_from("<2d", buf, pos + 4)
            geoms.append(Point(x, y))
        elif stype in _SHP_POLYLINE or stype in _SHP_POLYGON:
            nparts, npts = struct.unpack_from("<2i", buf, pos + 36)
            parts = np.frombuffer(buf, "<i4", nparts, pos + 44)
            xy = np.frombuffer(buf, "<f8", 2 * npts,
                               pos + 44 + 4 * nparts).reshape(npts, 2)
            bounds = list(parts) + [npts]
            pieces = [xy[bounds[i]:bounds[i + 1]] for i in range(nparts)
                      if bounds[i + 1] > bounds[i]]
            if stype in _SHP_POLYLINE:
                if len(pieces) != 1:
                    raise ValueError(
                        "multi-part PolyLine is not modelled (geometry "
                        "layer has no MultiLineString)")
                geoms.append(LineString([tuple(p) for p in pieces[0]]))
            else:
                geoms.append(_assemble_polygon(pieces))
        elif stype in _SHP_MULTIPOINT:
            raise ValueError(
                "MultiPoint shapefiles are not modelled by the geometry "
                "layer (obia_tpu_torch.geometry.geom)")
        else:
            raise ValueError(f"unsupported shape type {stype}")
        pos = end
    return geoms


def _read_dbf(buf: bytes) -> Dict[str, list]:
    if len(buf) < 32:
        return {}
    nrec, = struct.unpack_from("<I", buf, 4)
    hsize, rsize = struct.unpack_from("<2H", buf, 8)
    fields = []
    pos = 32
    while pos + 32 <= hsize and buf[pos] != 0x0D:
        name = buf[pos:pos + 11].split(b"\x00", 1)[0].decode(
            "latin-1").strip()
        ftype = chr(buf[pos + 11])
        flen = buf[pos + 16]
        fdec = buf[pos + 17]
        fields.append((name, ftype, flen, fdec))
        pos += 32
    cols: Dict[str, list] = {name: [] for name, *_ in fields}
    pos = hsize
    for _ in range(nrec):
        if pos + rsize > len(buf):
            break
        rec = buf[pos:pos + rsize]
        pos += rsize
        if rec[:1] == b"*":  # deleted record
            continue
        off = 1
        for name, ftype, flen, fdec in fields:
            raw = rec[off:off + flen]
            off += flen
            text = raw.decode("latin-1").strip()
            if ftype in ("N", "F"):
                if not text or text in ("*" * len(text),):
                    cols[name].append(None)
                elif fdec or ftype == "F" or "." in text or "e" in text.lower():
                    cols[name].append(float(text))
                else:
                    cols[name].append(int(text))
            elif ftype == "L":
                cols[name].append(
                    True if text in ("T", "t", "Y", "y") else
                    False if text in ("F", "f", "N", "n") else None)
            elif ftype == "D" and len(text) == 8:
                cols[name].append(f"{text[:4]}-{text[4:6]}-{text[6:]}")
            else:
                cols[name].append(text or None)
    return cols


def read_shapefile(path: Union[str, os.PathLike]
                   ) -> Tuple[Dict[str, list], List[Optional[Geometry]],
                              Optional[CRS]]:
    """Read .shp (+ sibling .dbf attributes, .prj CRS). Returns
    (columns, geometries, crs) in the shape of
    :func:`obia_tpu_torch.io.gpkg.read_gpkg`."""
    base, _ = os.path.splitext(os.fspath(path))
    with open(base + ".shp", "rb") as f:
        geoms = _read_shp(f.read())
    cols: Dict[str, list] = {}
    if os.path.exists(base + ".dbf"):
        with open(base + ".dbf", "rb") as f:
            cols = _read_dbf(f.read())
        for name, values in cols.items():
            if len(values) != len(geoms):
                raise ValueError(
                    f".dbf column {name!r} has {len(values)} records for "
                    f"{len(geoms)} shapes")
    crs = None
    if os.path.exists(base + ".prj"):
        with open(base + ".prj", "r", encoding="utf-8", errors="replace") as f:
            wkt = f.read().strip()
        if wkt:
            crs = CRS.from_wkt(wkt)
    return cols, geoms, crs


# --- writer ------------------------------------------------------------------

def _shape_record(geom: Optional[Geometry]) -> Tuple[int, bytes]:
    """(shape_type, record content bytes incl. the leading type i32)."""
    if geom is None or geom.is_empty:
        return _SHP_NULL, struct.pack("<i", 0)
    if isinstance(geom, Point):
        return 1, struct.pack("<i2d", 1, geom.x, geom.y)
    if isinstance(geom, LineString):
        xy = np.asarray(geom.coords, np.float64)
        parts = [xy]
        stype = 3
    elif isinstance(geom, (Polygon, MultiPolygon)):
        polys = geom.geoms if isinstance(geom, MultiPolygon) else [geom]
        parts = []
        for p in polys:
            shell = np.asarray(p.exterior.coords, np.float64)
            if _ring_signed_area(shell) > 0:  # ESRI shells are CW
                shell = shell[::-1]
            parts.append(shell)
            for h in p.interiors:
                ring = np.asarray(h.coords, np.float64)
                if _ring_signed_area(ring) < 0:  # holes CCW
                    ring = ring[::-1]
                parts.append(ring)
        stype = 5
    else:
        raise ValueError(
            f"cannot write {type(geom).__name__} to a shapefile")
    if stype == 5:  # polygon rings must be closed (first == last)
        parts = [np.vstack([p, p[:1]]) if not np.array_equal(p[0], p[-1])
                 else p for p in parts]
    allxy = np.vstack(parts)
    starts = np.cumsum([0] + [len(p) for p in parts[:-1]])
    content = struct.pack(
        "<i4d2i", stype, allxy[:, 0].min(), allxy[:, 1].min(),
        allxy[:, 0].max(), allxy[:, 1].max(), len(parts), len(allxy))
    content += np.asarray(starts, "<i4").tobytes()
    content += np.ascontiguousarray(allxy, "<f8").tobytes()
    return stype, content


def _dbf_bytes(cols: Sequence[Tuple[str, Sequence]], n: int) -> bytes:
    fields = []
    encoded: List[List[bytes]] = []
    for name, values in cols:
        vals = list(values)
        if all(v is None or isinstance(v, bool) for v in vals) and any(
                isinstance(v, bool) for v in vals):
            ftype, flen, fdec = "L", 1, 0
            cells = [b"?" if v is None else (b"T" if v else b"F")
                     for v in vals]
        elif all(v is None or isinstance(v, (int, np.integer))
                 and not isinstance(v, bool) for v in vals):
            # width sized to the data so wide ints can never overflow
            # their cell and shift every later field (dBase is fixed-width)
            texts = [None if v is None else f"{int(v)}" for v in vals]
            flen = max([len(t) for t in texts if t is not None] + [1])
            ftype, fdec = "N", 0
            cells = [b" " * flen if t is None else t.rjust(flen).encode()
                     for t in texts]
        elif all(v is None or isinstance(
                v, (int, float, np.integer, np.floating))
                and not isinstance(v, bool) for v in vals):
            texts = [None if v is None or (isinstance(v, float)
                                           and math.isnan(v))
                     else f"{float(v):.8f}" for v in vals]
            flen = max([len(t) for t in texts if t is not None] + [1])
            ftype, fdec = "N", 8
            cells = [b" " * flen if t is None else t.rjust(flen).encode()
                     for t in texts]
        else:
            strs = ["" if v is None else str(v) for v in vals]
            flen = min(max([len(s.encode("latin-1", "replace"))
                            for s in strs] + [1]), 254)
            ftype, fdec = "C", 0
            cells = [s.encode("latin-1", "replace")[:flen].ljust(flen)
                     for s in strs]
        if flen > 254:
            raise ValueError(
                f"column {name!r} needs a {flen}-byte dBase cell "
                "(max 254)")
        short = name[:10]
        if any(f[0] == short for f in fields):
            # 10-char truncation can collide (e.g. segment_id_a/_b);
            # dedup the way OGR does rather than emit an unreadable file
            for k in range(1, 100):
                cand = f"{short[:10 - len(str(k)) - 1]}_{k}"
                if not any(f[0] == cand for f in fields):
                    short = cand
                    break
        fields.append((short, ftype, flen, fdec))
        encoded.append(cells)

    hsize = 32 + 32 * len(fields) + 1
    rsize = 1 + sum(f[2] for f in fields)
    today = datetime.date(2026, 1, 1)
    out = bytearray()
    out += struct.pack("<4B I 2H 20x", 3, today.year - 1900, today.month,
                       today.day, n, hsize, rsize)
    for name, ftype, flen, fdec in fields:
        out += struct.pack("<11s c 4x 2B 14x", name.encode("latin-1"),
                           ftype.encode(), flen, fdec)
    out += b"\x0D"
    for i in range(n):
        out += b" "
        for cells in encoded:
            out += cells[i]
    out += b"\x1A"
    return bytes(out)


def write_shapefile(path: Union[str, os.PathLike],
                    cols: Sequence[Tuple[str, Sequence]],
                    geoms: Sequence[Optional[Geometry]],
                    crs: Optional[CRS] = None) -> None:
    """Write .shp + .shx + .dbf (+ .prj when the CRS has WKT/EPSG)."""
    base, _ = os.path.splitext(os.fspath(path))
    records = [_shape_record(g) for g in geoms]
    stypes = {t for t, _ in records if t != _SHP_NULL}
    if len(stypes) > 1:
        raise ValueError(
            f"shapefiles hold ONE shape type per file, got {sorted(stypes)}")
    stype = stypes.pop() if stypes else _SHP_NULL

    shp = bytearray(100)
    shx = bytearray(100)
    for i, (_t, content) in enumerate(records):
        offset_words = len(shp) // 2
        shp += struct.pack(">2i", i + 1, len(content) // 2)
        shp += content
        shx += struct.pack(">2i", offset_words, len(content) // 2)

    if any(g is not None for g in geoms):
        bs = np.array([g.bounds for g in geoms if g is not None])
        bbox = (bs[:, 0].min(), bs[:, 1].min(), bs[:, 2].max(),
                bs[:, 3].max())
    else:
        bbox = (0.0, 0.0, 0.0, 0.0)
    for out in (shp, shx):
        struct.pack_into(">i", out, 0, 9994)
        struct.pack_into(">i", out, 24, len(out) // 2)
        struct.pack_into("<2i", out, 28, 1000, stype)
        struct.pack_into("<4d", out, 36, *bbox)

    with open(base + ".shp", "wb") as f:
        f.write(bytes(shp))
    with open(base + ".shx", "wb") as f:
        f.write(bytes(shx))
    with open(base + ".dbf", "wb") as f:
        f.write(_dbf_bytes(cols, len(geoms)))
    if crs is not None:
        wkt = crs.to_wkt() if hasattr(crs, "to_wkt") else None
        if wkt:
            with open(base + ".prj", "w", encoding="utf-8") as f:
                f.write(wkt)
