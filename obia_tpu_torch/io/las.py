"""LAS point-cloud codec (the port's copy of ``obia_tpu/io/las.py``):
ASPRS LAS 1.2-1.4, point record formats 0-3 and 6-8, uncompressed.

:func:`read_las` returns the ``{"X", "Y", "Z", "Intensity", ...}`` array
dict that ``create_objects(pointcloud=...)`` consumes, so
``create_objects(..., pointcloud="tile.las")`` works directly, and
:func:`write_las` writes the same bytes as the JAX package's writer.

Pure numpy: the fixed-size point records are mapped with a structured
dtype whose ``itemsize`` is the header's record length, so files with
extra bytes decode without copying field by field. LAZ (compressed LAS)
is refused with a clear error.

CRS: the ``LASF_Projection`` GeoKeyDirectory VLR (record 34735) yields an
EPSG code; an OGC WKT VLR (record 2112, mandatory for point formats >= 6)
is parsed through :meth:`obia_tpu_torch.geometry.crs.CRS.from_wkt`.
"""
from __future__ import annotations

import os
import struct
from typing import Dict, Optional, Tuple, Union

import numpy as np

from ..geometry.crs import CRS

_SIGNATURE = b"LASF"
_VLR_HEADER = struct.Struct("<H16sHH32s")

# GeoKey ids shared with the GeoTIFF codec
_GEOKEY_GEOGRAPHIC_TYPE = 2048
_GEOKEY_PROJECTED_TYPE = 3072

# point record formats: (names, formats, offsets, base_size)
_XYZ = [("X", "<i4", 0), ("Y", "<i4", 4), ("Z", "<i4", 8),
        ("intensity", "<u2", 12)]
_LEGACY_TAIL = [("flags", "u1", 14), ("classification", "u1", 15),
                ("scan_angle", "i1", 16), ("user_data", "u1", 17),
                ("point_source_id", "<u2", 18)]
_MODERN_TAIL = [("returns", "u1", 14), ("flags", "u1", 15),
                ("classification", "u1", 16), ("user_data", "u1", 17),
                ("scan_angle", "<i2", 18), ("point_source_id", "<u2", 20),
                ("gps_time", "<f8", 22)]


def _rgb(off):
    return [("red", "<u2", off), ("green", "<u2", off + 2),
            ("blue", "<u2", off + 4)]


_POINT_FORMATS: Dict[int, Tuple[list, int]] = {
    0: (_XYZ + _LEGACY_TAIL, 20),
    1: (_XYZ + _LEGACY_TAIL + [("gps_time", "<f8", 20)], 28),
    2: (_XYZ + _LEGACY_TAIL + _rgb(20), 26),
    3: (_XYZ + _LEGACY_TAIL + [("gps_time", "<f8", 20)] + _rgb(28), 34),
    6: (_XYZ + _MODERN_TAIL, 30),
    7: (_XYZ + _MODERN_TAIL + _rgb(30), 36),
    8: (_XYZ + _MODERN_TAIL + _rgb(30) + [("nir", "<u2", 36)], 38),
}


def _point_dtype(fmt: int, record_length: int) -> np.dtype:
    fields, base = _POINT_FORMATS[fmt]
    if record_length < base:
        raise ValueError(
            f"point record length {record_length} is smaller than point "
            f"format {fmt}'s {base} bytes")
    return np.dtype({"names": [f[0] for f in fields],
                     "formats": [f[1] for f in fields],
                     "offsets": [f[2] for f in fields],
                     "itemsize": record_length})


class LasData(dict):
    """Array dict (the ``create_objects`` point-cloud contract) carrying
    the file metadata as attributes: ``crs``, ``point_format``,
    ``version``, ``scales``, ``offsets``."""

    crs: Optional[CRS] = None
    point_format: int = 0
    version: Tuple[int, int] = (1, 2)
    scales: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    offsets: Tuple[float, float, float] = (0.0, 0.0, 0.0)


def _parse_geokey_vlr(directory: np.ndarray) -> Optional[int]:
    """EPSG code from a GeoKeyDirectory uint16 array (same entry layout
    as the GeoTIFF tag: 4-short header, then (id, loc, cnt, val))."""
    if directory.size < 4:
        return None
    nkeys = int(directory[3])
    keys = {}
    for i in range(nkeys):
        ent = directory[4 + 4 * i: 8 + 4 * i]
        if ent.size < 4:
            break
        kid, loc, _cnt, val = (int(v) for v in ent)
        if loc == 0:
            keys[kid] = val
    for kid in (_GEOKEY_PROJECTED_TYPE, _GEOKEY_GEOGRAPHIC_TYPE):
        code = keys.get(kid)
        if isinstance(code, int) and 1024 <= code < 32767:
            return code
    return None


def _read_vlrs(buf: bytes, pos: int,
               n_vlrs: int) -> Dict[Tuple[str, int], bytes]:
    out = {}
    for _ in range(n_vlrs):
        if pos + _VLR_HEADER.size > len(buf):
            break
        _res, user, rid, length, _desc = _VLR_HEADER.unpack_from(buf, pos)
        pos += _VLR_HEADER.size
        payload = buf[pos:pos + length]
        pos += length
        out[(user.rstrip(b"\x00 ").decode("ascii", "replace"), rid)] = payload
    return out


def read_las(path: Union[str, os.PathLike]) -> LasData:
    """Read a LAS file into the point-cloud dict contract.

    Returns a :class:`LasData` mapping with float64 ``X``/``Y``/``Z``
    (scale and offset applied), ``Intensity``, ``classification``,
    ``return_number``, ``number_of_returns``, ``point_source_id``,
    ``scan_angle``, plus ``gps_time``/``red``/``green``/``blue``/``nir``
    when the point format carries them.
    """
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:4] != _SIGNATURE:
        raise ValueError(f"{path}: not a LAS file (missing LASF signature)")
    ver = (buf[24], buf[25])
    header_size, = struct.unpack_from("<H", buf, 94)
    point_offset, = struct.unpack_from("<I", buf, 96)
    n_vlrs, = struct.unpack_from("<I", buf, 100)
    pdf_byte = buf[104]
    if pdf_byte & 0x80 or pdf_byte & 0x40:
        raise ValueError(
            f"{path}: LAZ-compressed points (format byte 0x{pdf_byte:02x}) "
            "are not supported by the in-repo codec — decompress to .las "
            "(e.g. with laszip) first")
    fmt = pdf_byte & 0x3F
    if fmt not in _POINT_FORMATS:
        raise ValueError(f"{path}: unsupported point record format {fmt}")
    record_length, = struct.unpack_from("<H", buf, 105)
    count, = struct.unpack_from("<I", buf, 107)
    scales = struct.unpack_from("<3d", buf, 131)
    offsets = struct.unpack_from("<3d", buf, 155)
    if ver >= (1, 4) and header_size >= 375:
        count64, = struct.unpack_from("<Q", buf, 247)
        if count64:
            count = count64
    n_possible = (len(buf) - point_offset) // max(record_length, 1)
    count = min(int(count), max(n_possible, 0))

    dtype = _point_dtype(fmt, record_length)
    rec = np.frombuffer(buf, dtype=dtype, count=count, offset=point_offset)

    out = LasData()
    out.version = ver
    out.point_format = fmt
    out.scales = tuple(scales)
    out.offsets = tuple(offsets)
    out["X"] = rec["X"] * scales[0] + offsets[0]
    out["Y"] = rec["Y"] * scales[1] + offsets[1]
    out["Z"] = rec["Z"] * scales[2] + offsets[2]
    out["Intensity"] = rec["intensity"].copy()
    out["classification"] = (rec["classification"] & 0x1F).copy() \
        if fmt < 6 else rec["classification"].copy()
    if fmt < 6:
        out["return_number"] = rec["flags"] & 0x07
        out["number_of_returns"] = (rec["flags"] >> 3) & 0x07
    else:
        out["return_number"] = rec["returns"] & 0x0F
        out["number_of_returns"] = (rec["returns"] >> 4) & 0x0F
    out["scan_angle"] = rec["scan_angle"].copy()
    out["point_source_id"] = rec["point_source_id"].copy()
    for name in ("gps_time", "red", "green", "blue", "nir"):
        if name in dtype.names:
            out[name] = rec[name].copy()

    vlrs = _read_vlrs(buf, header_size, n_vlrs)
    wkt = vlrs.get(("LASF_Projection", 2112))
    geokeys = vlrs.get(("LASF_Projection", 34735))
    if wkt:
        text = wkt.split(b"\x00", 1)[0].decode("utf-8", "replace").strip()
        if text:
            out.crs = CRS.from_wkt(text)
    if out.crs is None and geokeys:
        epsg = _parse_geokey_vlr(np.frombuffer(geokeys, "<u2"))
        if epsg:
            out.crs = CRS.from_epsg(epsg)
    return out


def write_las(path: Union[str, os.PathLike], points, point_format: int = 3,
              scale: Tuple[float, float, float] = (0.001, 0.001, 0.001),
              offset: Optional[Tuple[float, float, float]] = None,
              crs=None) -> None:
    """Write a point dict (``X``/``Y``/``Z`` required; ``Intensity``,
    ``classification``, ``gps_time``, ``red``/``green``/``blue``/``nir``,
    ``return_number``/``number_of_returns``, ``scan_angle``,
    ``point_source_id`` optional) as LAS.

    Formats 0-3 write LAS 1.2; formats 6-8 write LAS 1.4 (with the WKT
    global-encoding bit, as the spec requires). Coordinates are quantised
    to ``scale`` about ``offset`` (default: per-axis minimum).
    """
    if point_format not in _POINT_FORMATS:
        raise ValueError(f"unsupported point format {point_format}")
    modern = point_format >= 6
    n_in = np.asarray(points["X"]).size
    if not modern and n_in > 0xFFFFFFFF:
        raise ValueError(
            f"{n_in} points exceed the legacy u32 record count; "
            "use point_format >= 6 (LAS 1.4 keeps a u64 count)")
    version = (1, 4) if modern else (1, 2)
    header_size = 375 if modern else 227

    def field(name):
        v = points.get(name) if isinstance(points, dict) else (
            points[name] if points.dtype.names and name in points.dtype.names
            else None)
        return None if v is None else np.asarray(v)

    x, y, z = field("X"), field("Y"), field("Z")
    if x is None or y is None or z is None:
        raise ValueError("point cloud must provide X, Y and Z")
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    z = np.asarray(z, np.float64)
    n = x.size
    if offset is None:
        offset = (float(x.min()) if n else 0.0,
                  float(y.min()) if n else 0.0,
                  float(z.min()) if n else 0.0)

    fields, base = _POINT_FORMATS[point_format]
    dtype = _point_dtype(point_format, base)
    rec = np.zeros(n, dtype)
    for name, arr, s, o in (("X", x, scale[0], offset[0]),
                            ("Y", y, scale[1], offset[1]),
                            ("Z", z, scale[2], offset[2])):
        q = np.round((arr - o) / s)
        if n and (q.min() < np.iinfo(np.int32).min
                  or q.max() > np.iinfo(np.int32).max):
            raise ValueError(
                f"{name} does not fit int32 at scale {s} about offset {o}")
        rec[name] = q.astype(np.int32)
    inten = field("Intensity")
    if inten is not None:
        rec["intensity"] = np.clip(np.asarray(inten, np.float64),
                                   0, 65535).astype(np.uint16)
    cls = field("classification")
    if cls is not None:
        cls = np.asarray(cls).astype(np.uint8)
        if not modern:
            # legacy formats keep classification in 5 bits; the upper 3
            # are the synthetic/keypoint/withheld flags — masking stops a
            # >31 class from silently setting them
            if cls.size and cls.max() > 0x1F:
                raise ValueError(
                    f"classification {int(cls.max())} does not fit the "
                    "5-bit legacy field; use point_format >= 6")
            cls = cls & 0x1F
        rec["classification"] = cls
    rn = field("return_number")
    nr = field("number_of_returns")
    rn = np.ones(n, np.uint8) if rn is None else np.asarray(rn, np.uint8)
    nr = np.ones(n, np.uint8) if nr is None else np.asarray(nr, np.uint8)
    if modern:
        rec["returns"] = (rn & 0x0F) | ((nr & 0x0F) << 4)
    else:
        rec["flags"] = (rn & 0x07) | ((nr & 0x07) << 3)
    sa = field("scan_angle")
    if sa is not None:
        rec["scan_angle"] = np.asarray(sa).astype(
            np.int16 if modern else np.int8)
    psid = field("point_source_id")
    if psid is not None:
        rec["point_source_id"] = np.asarray(psid).astype(np.uint16)
    for name in ("gps_time", "red", "green", "blue", "nir"):
        v = field(name)
        if v is not None and name in dtype.names:
            rec[name] = np.asarray(v).astype(dtype[name])

    # VLRs: WKT for modern formats, GeoKeyDirectory otherwise
    vlr_blobs = []
    crs_obj = CRS.from_user_input(crs) if crs is not None else None
    if crs_obj is not None:
        epsg = crs_obj.to_epsg()
        if modern:
            wkt = crs_obj.to_wkt() if hasattr(crs_obj, "to_wkt") else None
            payload = ((wkt or f"EPSG:{epsg}").encode() + b"\x00")
            vlr_blobs.append((b"LASF_Projection", 2112, payload))
        elif epsg:
            geographic = epsg == 4326 or (4000 <= epsg < 5000)
            kid = (_GEOKEY_GEOGRAPHIC_TYPE if geographic
                   else _GEOKEY_PROJECTED_TYPE)
            directory = np.array([1, 1, 0, 1, kid, 0, 1, epsg], "<u2")
            vlr_blobs.append((b"LASF_Projection", 34735, directory.tobytes()))
    vlr_bytes = b"".join(
        _VLR_HEADER.pack(0, user.ljust(16, b"\x00"), rid, len(payload),
                         b"\x00" * 32) + payload
        for user, rid, payload in vlr_blobs)

    point_offset = header_size + len(vlr_bytes)
    by_return = np.bincount(np.clip(rn, 1, 15).astype(np.int64),
                            minlength=16)[1:16] if n else np.zeros(15, int)

    hdr = bytearray(header_size)
    hdr[0:4] = _SIGNATURE
    hdr[24] = version[0]
    hdr[25] = version[1]
    hdr[26:26 + 32] = b"obia_tpu".ljust(32, b"\x00")
    hdr[58:58 + 32] = b"obia_tpu las codec".ljust(32, b"\x00")
    struct.pack_into("<H", hdr, 94, header_size)
    struct.pack_into("<I", hdr, 96, point_offset)
    struct.pack_into("<I", hdr, 100, len(vlr_blobs))
    hdr[104] = point_format
    struct.pack_into("<H", hdr, 105, base)
    # legacy counts are u32 and must be 0 for formats >= 6 (LAS 1.4 spec)
    if not modern and n <= 0xFFFFFFFF:
        struct.pack_into("<I", hdr, 107, n)
        struct.pack_into("<5I", hdr, 111,
                         *(int(min(v, 0xFFFFFFFF)) for v in by_return[:5]))
    struct.pack_into("<3d", hdr, 131, *scale)
    struct.pack_into("<3d", hdr, 155, *offset)
    if n:
        struct.pack_into("<6d", hdr, 179, x.max(), x.min(), y.max(), y.min(),
                         z.max(), z.min())
    if modern:
        struct.pack_into("<H", hdr, 6, 1 << 4)  # global encoding: WKT bit
        struct.pack_into("<Q", hdr, 247, n)
        struct.pack_into("<15Q", hdr, 255, *by_return)

    with open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(vlr_bytes)
        f.write(rec.tobytes())
