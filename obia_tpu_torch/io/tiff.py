"""GeoTIFF reader (the port's copy of the reader of ``obia_tpu/io/tiff.py``;
no GDAL / rasterio / libtiff).

Reads the subset of TIFF 6.0 + the GeoTIFF extension that geospatial
rasters use in practice:

  * classic TIFF and BigTIFF, little- or big-endian
  * striped and tiled layouts, chunky (PlanarConfig=1) and planar (=2)
  * uint8/16/32, int8/16/32, float32/64 samples
  * compression: none (1), LZW (5), deflate (8 / 32946), PackBits (32773)
  * horizontal-differencing predictor (2) and floating-point predictor (3)
  * GeoTIFF tags: ModelPixelScale, ModelTiepoint, ModelTransformation,
    GeoKeyDirectory (EPSG extraction), GDAL_NODATA
"""
from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..geometry.affine import Affine
from ..geometry.crs import CRS

# --- TIFF constants ----------------------------------------------------------

TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
              11: 4, 12: 8, 13: 4, 16: 8, 17: 8, 18: 8}
TYPE_FMT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f", 12: "d",
            16: "Q", 17: "q", 13: "I"}

T_WIDTH, T_LENGTH = 256, 257
T_BITS = 258
T_COMPRESSION = 259
T_PHOTOMETRIC = 262
T_STRIP_OFFSETS = 273
T_SPP = 277
T_ROWS_PER_STRIP = 278
T_STRIP_COUNTS = 279
T_PLANAR = 284
T_PREDICTOR = 317
T_TILE_W, T_TILE_L = 322, 323
T_TILE_OFFSETS, T_TILE_COUNTS = 324, 325
T_EXTRA = 338
T_SAMPLE_FORMAT = 339
T_PIXEL_SCALE = 33550
T_TIEPOINT = 33922
T_TRANSFORM = 34264
T_GEO_KEYS = 34735
T_GEO_DOUBLES = 34736
T_GEO_ASCII = 34737
T_GDAL_META = 42112
T_GDAL_NODATA = 42113

GEOKEY_GEOGRAPHIC_TYPE = 2048
GEOKEY_PROJECTED_TYPE = 3072
GEOKEY_MODEL_TYPE = 1024
GEOKEY_RASTER_TYPE = 1025


def _np_dtype(sample_format: int, bits: int, byteorder: str) -> np.dtype:
    kind = {1: "u", 2: "i", 3: "f"}.get(sample_format, "u")
    if kind == "f" and bits not in (16, 32, 64):
        raise ValueError(f"unsupported float width {bits}")
    return np.dtype(f"{byteorder}{kind}{bits // 8}")


# --- LZW (TIFF variant, MSB-first codes) --------------------------------------

def lzw_decode(data: bytes) -> bytes:
    """TIFF LZW decoder (Adobe variant with early code change)."""
    out = bytearray()
    CLEAR, EOI = 256, 257
    table: List[bytes] = []

    def reset():
        nonlocal table
        table = [bytes([i]) for i in range(256)] + [b"", b""]

    reset()
    bitbuf = 0
    bitcnt = 0
    width = 9
    prev: Optional[bytes] = None
    pos = 0
    n = len(data)
    while True:
        while bitcnt < width:
            if pos >= n:
                return bytes(out)
            bitbuf = (bitbuf << 8) | data[pos]
            pos += 1
            bitcnt += 8
        code = (bitbuf >> (bitcnt - width)) & ((1 << width) - 1)
        bitcnt -= width
        if code == CLEAR:
            reset()
            width = 9
            prev = None
            continue
        if code == EOI:
            return bytes(out)
        if prev is None:
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        else:
            entry = prev + prev[:1]
            table.append(entry)
        out += entry
        prev = entry
        # TIFF "early change": the DECODER bumps when its next free entry
        # reaches 2^w - 1 (one entry before the encoder, whose table runs
        # one entry ahead). Verified against libtiff/PIL output — the
        # previous 2^w - 2 rule desynced at the first 9->10 bit change.
        if len(table) >= (1 << width) - 1 and width < 12:
            width += 1


def packbits_decode(data: bytes) -> bytes:
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        h = data[i]
        i += 1
        if h < 128:
            out += data[i:i + h + 1]
            i += h + 1
        elif h > 128:
            out += data[i:i + 1] * (257 - h)
            i += 1
    return bytes(out)


def _decompress(raw: bytes, compression: int) -> bytes:
    if compression == 1:
        return raw
    if compression in (8, 32946):
        return zlib.decompress(raw)
    if compression == 5:
        return lzw_decode(raw)
    if compression == 32773:
        return packbits_decode(raw)
    raise ValueError(f"unsupported TIFF compression {compression}")


def _undo_predictor(arr: np.ndarray, predictor: int) -> np.ndarray:
    """arr shape (rows, cols, spp); horizontal differencing along cols."""
    if predictor == 2:
        np.cumsum(arr, axis=1, dtype=arr.dtype, out=arr)
    elif predictor == 3:
        # Floating-point predictor: bytes were split into planes of
        # byte-significance and horizontally diffed as uint8.
        rows, cols, spp = arr.shape
        bps = arr.dtype.itemsize
        raw = arr.view(np.uint8).reshape(rows, cols * spp * bps)
        np.cumsum(raw, axis=1, dtype=np.uint8, out=raw)
        # de-interleave: row holds bps planes of (cols*spp) bytes, big-endian order
        shuffled = raw.reshape(rows, bps, cols * spp)
        restored = np.empty((rows, cols * spp, bps), np.uint8)
        for i in range(bps):
            restored[:, :, bps - 1 - i] = shuffled[:, i, :]  # to little-endian
        return np.frombuffer(restored.tobytes(), dtype=arr.dtype.newbyteorder("<")
                             ).reshape(rows, cols, spp)
    return arr


# --- IFD parsing --------------------------------------------------------------

@dataclass
class TiffIFD:
    tags: Dict[int, tuple] = field(default_factory=dict)  # tag -> (type, values)

    def get(self, tag: int, default=None):
        entry = self.tags.get(tag)
        return entry[1] if entry is not None else default

    def scalar(self, tag: int, default=None):
        v = self.get(tag)
        if v is None:
            return default
        return v[0] if isinstance(v, (list, tuple)) else v


def _parse_ifd(buf: bytes, offset: int, bo: str,
               big: bool = False) -> Tuple[TiffIFD, int]:
    """Parse a classic (big=False) or BigTIFF (big=True) IFD."""
    if big:
        (count,) = struct.unpack_from(bo + "Q", buf, offset)
        pos = offset + 8
        entry_size = 20
        inline_size = 8
        off_fmt = "Q"
    else:
        (count,) = struct.unpack_from(bo + "H", buf, offset)
        pos = offset + 2
        entry_size = 12
        inline_size = 4
        off_fmt = "I"
    ifd = TiffIFD()
    for _ in range(count):
        if big:
            tag, typ = struct.unpack_from(bo + "HH", buf, pos)
            (n,) = struct.unpack_from(bo + "Q", buf, pos + 4)
        else:
            tag, typ, n = struct.unpack_from(bo + "HHI", buf, pos)
        size = TYPE_SIZES.get(typ, 1) * n
        if size <= inline_size:
            data_off = pos + entry_size - inline_size
        else:
            (data_off,) = struct.unpack_from(
                bo + off_fmt, buf, pos + entry_size - inline_size)
        if typ == 2:
            values = buf[data_off:data_off + n].split(b"\0")[0].decode("latin-1")
        elif typ in TYPE_FMT:
            values = list(struct.unpack_from(bo + str(n) + TYPE_FMT[typ], buf, data_off))
        elif typ == 5:  # rational
            raw = struct.unpack_from(bo + str(2 * n) + "I", buf, data_off)
            values = [raw[2 * i] / max(raw[2 * i + 1], 1) for i in range(n)]
        elif typ == 10:
            raw = struct.unpack_from(bo + str(2 * n) + "i", buf, data_off)
            values = [raw[2 * i] / (raw[2 * i + 1] or 1) for i in range(n)]
        else:
            values = buf[data_off:data_off + size]
        ifd.tags[tag] = (typ, values)
        pos += entry_size
    (next_off,) = struct.unpack_from(bo + off_fmt, buf, pos)
    return ifd, next_off


def _parse_geokeys(ifd: TiffIFD) -> Dict[int, object]:
    keys_raw = ifd.get(T_GEO_KEYS)
    if not keys_raw:
        return {}
    doubles = ifd.get(T_GEO_DOUBLES, [])
    ascii_params = ifd.get(T_GEO_ASCII, "")
    out: Dict[int, object] = {}
    nkeys = keys_raw[3]
    for i in range(nkeys):
        kid, loc, cnt, val = keys_raw[4 + 4 * i: 8 + 4 * i]
        if loc == 0:
            out[kid] = val
        elif loc == T_GEO_DOUBLES:
            out[kid] = doubles[val] if cnt == 1 else doubles[val:val + cnt]
        elif loc == T_GEO_ASCII:
            out[kid] = ascii_params[val:val + cnt].rstrip("|")
    return out


class TiffReader:
    """Parses a (Geo)TIFF held fully in memory and decodes bands on demand."""

    def __init__(self, path_or_bytes):
        if isinstance(path_or_bytes, (bytes, bytearray)):
            self._buf = bytes(path_or_bytes)
            self.path = None
        else:
            self.path = str(path_or_bytes)
            with open(self.path, "rb") as f:
                self._buf = f.read()
        buf = self._buf
        if buf[:2] == b"II":
            self._bo = "<"
        elif buf[:2] == b"MM":
            self._bo = ">"
        else:
            raise ValueError("not a TIFF file")
        (magic,) = struct.unpack_from(self._bo + "H", buf, 2)
        if magic == 43:  # BigTIFF: 8-byte offsets
            self.big = True
            (off_size, _) = struct.unpack_from(self._bo + "HH", buf, 4)
            if off_size != 8:
                raise ValueError(f"unsupported BigTIFF offset size {off_size}")
            (ifd_off,) = struct.unpack_from(self._bo + "Q", buf, 8)
        elif magic == 42:
            self.big = False
            (ifd_off,) = struct.unpack_from(self._bo + "I", buf, 4)
        else:
            raise ValueError("bad TIFF magic")
        self.ifd, _ = _parse_ifd(buf, ifd_off, self._bo, big=self.big)
        self._init_layout()

    # -- metadata ------------------------------------------------------------
    def _init_layout(self):
        ifd = self.ifd
        self.width = int(ifd.scalar(T_WIDTH))
        self.height = int(ifd.scalar(T_LENGTH))
        self.spp = int(ifd.scalar(T_SPP, 1))
        bits = ifd.get(T_BITS, [8])
        self.bits = int(bits[0])
        fmts = ifd.get(T_SAMPLE_FORMAT, [1])
        self.sample_format = int(fmts[0])
        self.compression = int(ifd.scalar(T_COMPRESSION, 1))
        self.predictor = int(ifd.scalar(T_PREDICTOR, 1))
        self.planar = int(ifd.scalar(T_PLANAR, 1))
        self.dtype = _np_dtype(self.sample_format, self.bits, self._bo)
        self.tiled = T_TILE_OFFSETS in ifd.tags
        if self.tiled:
            self.tile_w = int(ifd.scalar(T_TILE_W))
            self.tile_h = int(ifd.scalar(T_TILE_L))
            self.chunk_offsets = [int(v) for v in ifd.get(T_TILE_OFFSETS)]
            self.chunk_counts = [int(v) for v in ifd.get(T_TILE_COUNTS)]
        else:
            self.rows_per_strip = int(ifd.scalar(T_ROWS_PER_STRIP, self.height))
            self.chunk_offsets = [int(v) for v in ifd.get(T_STRIP_OFFSETS)]
            self.chunk_counts = [int(v) for v in ifd.get(T_STRIP_COUNTS)]

        # georeferencing
        transform = Affine.identity()
        mt = ifd.get(T_TRANSFORM)
        scale = ifd.get(T_PIXEL_SCALE)
        tie = ifd.get(T_TIEPOINT)
        if mt and len(mt) >= 16:
            transform = Affine(mt[0], mt[1], mt[3], mt[4], mt[5], mt[7])
        elif scale and tie and len(tie) >= 6:
            sx, sy = float(scale[0]), float(scale[1])
            i, j, _, x, y, _ = [float(v) for v in tie[:6]]
            transform = Affine(sx, 0.0, x - i * sx, 0.0, -sy, y + j * sy)
        self.transform = transform

        geokeys = _parse_geokeys(ifd)
        epsg = None
        pcs = geokeys.get(GEOKEY_PROJECTED_TYPE)
        gcs = geokeys.get(GEOKEY_GEOGRAPHIC_TYPE)
        if isinstance(pcs, int) and 1024 <= pcs < 32767:
            epsg = pcs
        elif isinstance(gcs, int) and 1024 <= gcs < 32767:
            epsg = gcs
        self.crs = CRS.from_epsg(epsg) if epsg else None

        nod = ifd.get(T_GDAL_NODATA)
        self.nodata = None
        if isinstance(nod, str):
            try:
                self.nodata = float(nod.strip())
            except ValueError:
                pass

    # -- decoding -------------------------------------------------------------
    def _decode_chunk(self, idx: int, rows: int, cols: int, spp: int) -> np.ndarray:
        raw = self._buf[self.chunk_offsets[idx]:
                        self.chunk_offsets[idx] + self.chunk_counts[idx]]
        data = _decompress(raw, self.compression)
        expected = rows * cols * spp * self.dtype.itemsize
        if len(data) < expected:
            data = data + b"\0" * (expected - len(data))
        arr = np.frombuffer(data[:expected], dtype=self.dtype).reshape(rows, cols, spp)
        if self.predictor != 1:
            arr = _undo_predictor(arr.copy(), self.predictor)
        return arr

    def read(self, window: Optional[Tuple[int, int, int, int]] = None) -> np.ndarray:
        """Read the raster as (H, W, C). ``window`` = (row0, col0, h, w);
        windowed reads decode only the intersecting strips/tiles."""
        if window is not None and self.planar == 1:
            return self._read_window(*window)
        H, W, C = self.height, self.width, self.spp
        if self.planar == 2:
            full = self._read_planar()
        elif self.tiled:
            full = self._read_tiled()
        else:
            full = self._read_striped()
        if window is not None:
            r0, c0, h, w = window
            full = full[r0:r0 + h, c0:c0 + w]
        return full

    def _read_window(self, r0: int, c0: int, h: int, w: int) -> np.ndarray:
        """Decode only the chunks intersecting the window."""
        H, W, C = self.height, self.width, self.spp
        r0 = max(0, r0)
        c0 = max(0, c0)
        r1 = min(H, r0 + h)
        c1 = min(W, c0 + w)
        out = np.empty((r1 - r0, c1 - c0, C), self.dtype)
        if self.tiled:
            tw, th = self.tile_w, self.tile_h
            tiles_x = (W + tw - 1) // tw
            for ty in range(r0 // th, (r1 - 1) // th + 1):
                for tx in range(c0 // tw, (c1 - 1) // tw + 1):
                    tile = self._decode_chunk(ty * tiles_x + tx, th, tw, C)
                    tr0, tc0 = ty * th, tx * tw
                    rr0 = max(r0, tr0)
                    rr1 = min(r1, tr0 + th)
                    cc0 = max(c0, tc0)
                    cc1 = min(c1, tc0 + tw)
                    out[rr0 - r0:rr1 - r0, cc0 - c0:cc1 - c0] = \
                        tile[rr0 - tr0:rr1 - tr0, cc0 - tc0:cc1 - tc0]
        else:
            rps = self.rows_per_strip
            for s in range(r0 // rps, (r1 - 1) // rps + 1):
                sr0 = s * rps
                rows = min(rps, H - sr0)
                strip = self._decode_chunk(s, rows, W, C)
                rr0 = max(r0, sr0)
                rr1 = min(r1, sr0 + rows)
                out[rr0 - r0:rr1 - r0, :] = strip[rr0 - sr0:rr1 - sr0, c0:c1]
        return out

    def _read_striped(self) -> np.ndarray:
        H, W, C = self.height, self.width, self.spp
        out = np.empty((H, W, C), self.dtype)
        rps = self.rows_per_strip
        for s, off in enumerate(self.chunk_offsets):
            r0 = s * rps
            rows = min(rps, H - r0)
            out[r0:r0 + rows] = self._decode_chunk(s, rows, W, C)
        return out

    def _read_tiled(self) -> np.ndarray:
        H, W, C = self.height, self.width, self.spp
        tw, th = self.tile_w, self.tile_h
        tiles_x = (W + tw - 1) // tw
        tiles_y = (H + th - 1) // th
        out = np.empty((H, W, C), self.dtype)
        for ty in range(tiles_y):
            for tx in range(tiles_x):
                idx = ty * tiles_x + tx
                tile = self._decode_chunk(idx, th, tw, C)
                r0, c0 = ty * th, tx * tw
                out[r0:min(r0 + th, H), c0:min(c0 + tw, W)] = \
                    tile[:min(th, H - r0), :min(tw, W - c0)]
        return out

    def _read_planar(self) -> np.ndarray:
        H, W, C = self.height, self.width, self.spp
        out = np.empty((H, W, C), self.dtype)
        if self.tiled:
            tw, th = self.tile_w, self.tile_h
            tiles_x = (W + tw - 1) // tw
            tiles_y = (H + th - 1) // th
            per_band = tiles_x * tiles_y
            for b in range(C):
                for ty in range(tiles_y):
                    for tx in range(tiles_x):
                        idx = b * per_band + ty * tiles_x + tx
                        tile = self._decode_chunk(idx, th, tw, 1)
                        r0, c0 = ty * th, tx * tw
                        out[r0:min(r0 + th, H), c0:min(c0 + tw, W), b] = \
                            tile[:min(th, H - r0), :min(tw, W - c0), 0]
        else:
            rps = self.rows_per_strip
            strips_per_band = (H + rps - 1) // rps
            for b in range(C):
                for s in range(strips_per_band):
                    r0 = s * rps
                    rows = min(rps, H - r0)
                    chunk = self._decode_chunk(b * strips_per_band + s, rows, W, 1)
                    out[r0:r0 + rows, :, b] = chunk[:, :, 0]
        return out
