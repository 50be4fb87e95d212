"""GeoPackage (OGC GPKG) vector I/O built on the stdlib sqlite3 module
(the port's copy of ``obia_tpu/io/gpkg.py``): gpkg_contents /
gpkg_geometry_columns / gpkg_spatial_ref_sys metadata tables plus the
standard GeoPackage binary geometry blob (GP magic + envelope + WKB).
:func:`write_features` and :func:`read_gpkg` move plain lists, so neither
needs pandas.
"""
from __future__ import annotations

import datetime
import sqlite3
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..geometry import wkb as wkb_mod
from ..geometry.crs import CRS
from ..geometry.geom import Geometry

GPKG_APPLICATION_ID = 0x47504B47  # "GPKG"


def _gp_header(srs_id: int, bounds: Tuple[float, float, float, float]) -> bytes:
    # flags: envelope type 1 (xy), little-endian byte order
    flags = 0b00000011
    return (b"GP" + bytes([0, flags])
            + struct.pack("<i", srs_id)
            + struct.pack("<4d", bounds[0], bounds[2], bounds[1], bounds[3]))


def encode_gpkg_geom(geom: Geometry, srs_id: int) -> bytes:
    return _gp_header(srs_id, geom.bounds) + wkb_mod.dumps(geom)


def decode_gpkg_geom(blob: bytes) -> Geometry:
    if blob[:2] != b"GP":
        # bare WKB fallback
        return wkb_mod.loads(blob)
    flags = blob[3]
    envelope_type = (flags >> 1) & 0b111
    env_len = {0: 0, 1: 32, 2: 48, 3: 48, 4: 64}.get(envelope_type, 0)
    return wkb_mod.loads(blob[8 + env_len:])


def _ensure_meta_tables(conn: sqlite3.Connection) -> None:
    conn.executescript("""
    CREATE TABLE IF NOT EXISTS gpkg_spatial_ref_sys (
      srs_name TEXT NOT NULL, srs_id INTEGER PRIMARY KEY,
      organization TEXT NOT NULL, organization_coordsys_id INTEGER NOT NULL,
      definition TEXT NOT NULL, description TEXT);
    CREATE TABLE IF NOT EXISTS gpkg_contents (
      table_name TEXT PRIMARY KEY, data_type TEXT NOT NULL,
      identifier TEXT UNIQUE, description TEXT DEFAULT '',
      last_change DATETIME NOT NULL DEFAULT (strftime('%Y-%m-%dT%H:%M:%fZ','now')),
      min_x DOUBLE, min_y DOUBLE, max_x DOUBLE, max_y DOUBLE,
      srs_id INTEGER);
    CREATE TABLE IF NOT EXISTS gpkg_geometry_columns (
      table_name TEXT NOT NULL, column_name TEXT NOT NULL,
      geometry_type_name TEXT NOT NULL, srs_id INTEGER NOT NULL,
      z TINYINT NOT NULL, m TINYINT NOT NULL,
      CONSTRAINT pk_geom_cols PRIMARY KEY (table_name, column_name));
    """)
    for srs_id, name, org, code, definition in (
            (-1, "Undefined cartesian SRS", "NONE", -1, "undefined"),
            (0, "Undefined geographic SRS", "NONE", 0, "undefined"),
            (4326, "WGS 84", "EPSG", 4326, CRS.from_epsg(4326).to_wkt())):
        conn.execute(
            "INSERT OR IGNORE INTO gpkg_spatial_ref_sys VALUES (?,?,?,?,?,NULL)",
            (name, srs_id, org, code, definition))


def _register_srs(conn: sqlite3.Connection, crs: Optional[CRS]) -> int:
    if crs is None or crs.to_epsg() is None:
        return 0
    epsg = crs.to_epsg()
    conn.execute(
        "INSERT OR IGNORE INTO gpkg_spatial_ref_sys VALUES (?,?,?,?,?,NULL)",
        (f"EPSG:{epsg}", epsg, "EPSG", epsg, crs.to_wkt()))
    return epsg


_SQL_TYPE = {
    "i": "INTEGER", "u": "INTEGER", "f": "DOUBLE", "b": "BOOLEAN",
    "O": "TEXT", "U": "TEXT", "S": "TEXT", "M": "DATETIME",
}


def _sql_type_of(values: Sequence) -> str:
    arr = np.asarray(values)
    kind = arr.dtype.kind
    if kind == "O":
        # object columns are usually a typed column with missing values
        # (nullable Int64, [1, None, 2], ...): infer from the non-null
        # values so ints keep INTEGER affinity — TEXT affinity would
        # round-trip them back as strings
        kinds = {("b" if isinstance(v, (bool, np.bool_)) else
                  "i" if isinstance(v, (int, np.integer)) else
                  "f" if isinstance(v, (float, np.floating)) else
                  "U" if isinstance(v, str) else "O")
                 for v in arr if not _is_na(v)}
        if kinds == {"i"} or kinds == {"i", "f"}:
            kind = "i" if kinds == {"i"} else "f"
        elif kinds == {"f"}:
            kind = "f"
        elif kinds == {"b"}:
            kind = "b"
    return _SQL_TYPE.get(kind, "TEXT")


def _is_na(v) -> bool:
    if v is None:
        return True
    if type(v).__name__ in ("NAType", "NaTType"):  # pandas NA / NaT
        return True
    if isinstance(v, (float, np.floating)):
        return v != v
    if isinstance(v, np.datetime64):
        return bool(np.isnat(v))
    return False


def _py(v):
    """Convert numpy scalars / NaN / pandas NA to sqlite-friendly Python
    values."""
    if v is None:
        return None
    if type(v).__name__ == "NAType":  # pandas.NA (nullable-dtype missing)
        return None
    if isinstance(v, (np.floating, float)):
        f = float(v)
        return None if f != f else f
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.bool_, bool)):
        return int(v)
    if isinstance(v, (np.str_,)):
        return str(v)
    if isinstance(v, np.datetime64):
        # sqlite has no native datetime: store the ISO-8601 text form the
        # DATETIME column type declared by _SQL_TYPE expects
        return None if np.isnat(v) else np.datetime_as_string(v, unit="s")
    if hasattr(v, "isoformat"):  # pandas Timestamp / datetime.datetime
        if v != v:  # NaT
            return None
        return v.isoformat()
    if isinstance(v, (list, tuple, np.ndarray)):
        import json
        return json.dumps(np.asarray(v).tolist())
    return v


def write_gpkg(path: str,
               columns: List[Tuple[str, Sequence]],
               geometries: Sequence[Geometry],
               layer: str = "layer",
               crs=None,
               geometry_type: str = "GEOMETRY") -> None:
    """Write one feature layer. ``columns`` is a list of (name, values)."""
    crs_obj = CRS.from_user_input(crs) if crs is not None else None
    conn = sqlite3.connect(path)
    try:
        conn.execute(f"PRAGMA application_id = {GPKG_APPLICATION_ID}")
        conn.execute("PRAGMA user_version = 10300")
        _ensure_meta_tables(conn)
        srs_id = _register_srs(conn, crs_obj)

        safe_layer = layer.replace('"', '""')
        # column names are interpolated into SQL: escape embedded quotes
        # exactly like the layer name
        columns = [(str(name).replace('"', '""'), vals)
                   for name, vals in columns]
        col_defs = ", ".join(
            f'"{name}" {_sql_type_of(vals)}' for name, vals in columns)
        if col_defs:
            col_defs = ", " + col_defs
        conn.execute(f'DROP TABLE IF EXISTS "{safe_layer}"')
        conn.execute(
            f'CREATE TABLE "{safe_layer}" '
            f'(fid INTEGER PRIMARY KEY AUTOINCREMENT, geom BLOB{col_defs})')

        n = len(geometries)
        names = [name for name, _ in columns]
        placeholders = ",".join(["?"] * (1 + len(names)))
        quoted = ",".join(['geom'] + [f'"{c}"' for c in names])
        rows = []
        minx = miny = float("inf")
        maxx = maxy = float("-inf")
        for i in range(n):
            g = geometries[i]
            if g is None or g.is_empty:
                blob = None
            else:
                blob = encode_gpkg_geom(g, srs_id)
                b = g.bounds
                minx, miny = min(minx, b[0]), min(miny, b[1])
                maxx, maxy = max(maxx, b[2]), max(maxy, b[3])
            rows.append(tuple([blob] + [_py(vals[i]) for _, vals in columns]))
        conn.executemany(
            f'INSERT INTO "{safe_layer}" ({quoted}) VALUES ({placeholders})', rows)

        if minx > maxx:
            minx = miny = maxx = maxy = None
        now = datetime.datetime.now(datetime.timezone.utc).strftime(
            "%Y-%m-%dT%H:%M:%S.%fZ")
        conn.execute("INSERT OR REPLACE INTO gpkg_contents VALUES (?,?,?,?,?,?,?,?,?,?)",
                     (layer, "features", layer, "", now,
                      minx, miny, maxx, maxy, srs_id))
        conn.execute("INSERT OR REPLACE INTO gpkg_geometry_columns VALUES (?,?,?,?,?,?)",
                     (layer, "geom", geometry_type, srs_id, 0, 0))
        conn.commit()
    finally:
        conn.close()


def write_features(path: str, columns: List[Tuple[str, Sequence]],
                   geometries: Sequence[Geometry], layer: str,
                   crs=None) -> None:
    """One feature layer as ``GeoDataFrame.to_file`` writes it: no None
    geometry, and the geometry type named when there is only one."""
    if len(geometries) and any(g is None for g in geometries):
        raise ValueError("None geometries — refusing to write empty blobs")
    geom_types = {g.geom_type for g in geometries}
    gtype = geom_types.pop() if len(geom_types) == 1 else "GEOMETRY"
    write_gpkg(path, columns, list(geometries), layer=layer, crs=crs,
               geometry_type=gtype.upper())


def list_layers(path: str) -> List[str]:
    conn = sqlite3.connect(path)
    try:
        cur = conn.execute(
            "SELECT table_name FROM gpkg_contents WHERE data_type='features'")
        return [r[0] for r in cur.fetchall()]
    finally:
        conn.close()


def read_gpkg(path: str, layer: Optional[str] = None, bbox=None):
    """Read a feature layer → (column_dict, geometries, crs), the columns
    as plain lists. ``bbox`` (minx, miny, maxx, maxy) keeps only
    intersecting features."""
    conn = sqlite3.connect(path)
    try:
        if layer is None:
            layers = list_layers(path)
            if not layers:
                raise ValueError(f"no feature layers in {path}")
            layer = layers[0]
        cur = conn.execute(
            "SELECT column_name, srs_id FROM gpkg_geometry_columns WHERE table_name=?",
            (layer,))
        row = cur.fetchone()
        geom_col, srs_id = (row if row else ("geom", 0))
        crs = None
        if srs_id and srs_id > 0:
            # srs_id is only an EPSG code when the registry row says so —
            # GDAL/QGIS write custom SRS ids (>= 100000) whose definition
            # lives in gpkg_spatial_ref_sys
            try:
                reg = conn.execute(
                    "SELECT organization, organization_coordsys_id, "
                    "definition FROM gpkg_spatial_ref_sys WHERE srs_id=?",
                    (srs_id,)).fetchone()
            except sqlite3.Error:
                reg = None
            if reg and reg[0] and str(reg[0]).upper() == "EPSG" and reg[1]:
                crs = CRS.from_epsg(int(reg[1]))
            elif reg and reg[2] and reg[2].strip() not in ("", "undefined"):
                crs = CRS.from_wkt(reg[2])
            else:
                crs = CRS.from_epsg(srs_id)

        safe_layer = layer.replace('"', '""')
        cur = conn.execute(f'SELECT * FROM "{safe_layer}"')
        names = [d[0] for d in cur.description]
        geom_idx = names.index(geom_col)
        cols = {name: [] for i, name in enumerate(names)
                if i != geom_idx and name != "fid"}
        geoms = []
        for rec in cur.fetchall():
            blob = rec[geom_idx]
            g = decode_gpkg_geom(blob) if blob is not None else None
            if bbox is not None and g is not None:
                b = g.bounds
                if (b[2] < bbox[0] or bbox[2] < b[0]
                        or b[3] < bbox[1] or bbox[3] < b[1]):
                    continue
            geoms.append(g)
            for i, name in enumerate(names):
                if i != geom_idx and name != "fid":
                    cols[name].append(rec[i])
        return cols, geoms, crs
    finally:
        conn.close()
