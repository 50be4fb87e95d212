"""GeoTIFF reader and writer (the port's copy of ``obia_tpu/io/tiff.py``;
no GDAL / rasterio / libtiff). ``write_tiff`` writes the classified raster
of ``ClassifiedImage.write_geotiff``.

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

import os
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
            values = bytes(buf[data_off:data_off + size])
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


@dataclass
class TiffInfo:
    """A raster's metadata, as :attr:`TiffReader.info` gives it."""
    width: int
    height: int
    count: int            # samples per pixel (bands)
    dtype: np.dtype
    transform: Affine
    crs: Optional[CRS]
    nodata: Optional[float]
    compression: int
    tiled: bool


class TiffReader:
    """Parses a (Geo)TIFF held fully in memory and decodes bands on demand."""

    def __init__(self, path_or_bytes):
        if isinstance(path_or_bytes, (bytes, bytearray)):
            self._buf = bytearray(path_or_bytes)
            self.path = None
        else:
            self.path = str(path_or_bytes)
            with open(self.path, "rb") as f:
                self._buf = bytearray(os.fstat(f.fileno()).st_size)
                del self._buf[f.readinto(self._buf):]
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

    @property
    def info(self) -> TiffInfo:
        return TiffInfo(self.width, self.height, self.spp, self.dtype,
                        self.transform, self.crs, self.nodata,
                        self.compression, self.tiled)

    # -- decoding -------------------------------------------------------------
    def _decode_chunk(self, idx: int, rows: int, cols: int, spp: int) -> np.ndarray:
        """The chunk as (rows, cols, spp); an uncompressed one is a view of
        the file's bytes."""
        off = self.chunk_offsets[idx]
        data = memoryview(self._buf)[off:off + self.chunk_counts[idx]]
        if self.compression != 1:
            data = _decompress(bytes(data), self.compression)
        expected = rows * cols * spp * self.dtype.itemsize
        if len(data) < expected:
            data = bytes(data) + b"\0" * (expected - len(data))
        arr = np.frombuffer(data, dtype=self.dtype,
                            count=rows * cols * spp).reshape(rows, cols, spp)
        if self.predictor != 1:
            arr = _undo_predictor(arr.copy(), self.predictor)
        return arr

    def read(self, window: Optional[Tuple[int, int, int, int]] = None) -> np.ndarray:
        """Read the raster as (H, W, C). ``window`` = (row0, col0, h, w);
        windowed reads decode only the intersecting strips/tiles. A whole
        raster of uncompressed pixel-interleaved strips stored back to back
        is a view of the reader's buffer, not a copy."""
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

    def _in_place(self) -> bool:
        """The raster lies in the file as it is returned: uncompressed
        strips without a predictor, stored in order with no gap."""
        offs, counts = self.chunk_offsets, self.chunk_counts
        size = self.height * self.width * self.spp * self.dtype.itemsize
        return (bool(offs) and self.compression == 1 and self.predictor == 1
                and sum(counts) == size and offs[0] % self.dtype.itemsize == 0
                and offs[0] + size <= len(self._buf)
                and all(o + c == n for o, c, n in zip(offs, counts, offs[1:])))

    def _read_striped(self) -> np.ndarray:
        H, W, C = self.height, self.width, self.spp
        if self._in_place():
            return np.frombuffer(self._buf, self.dtype, H * W * C,
                                 self.chunk_offsets[0]).reshape(H, W, C)
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


# --- Writer ------------------------------------------------------------------

def lzw_encode(data: bytes) -> bytes:
    """TIFF LZW encoder (early code change)."""
    out = bytearray()
    bitbuf = 0
    bitcnt = 0
    width = 9
    CLEAR, EOI = 256, 257

    def emit(code: int):
        nonlocal bitbuf, bitcnt
        bitbuf = (bitbuf << width) | code
        bitcnt += width
        while bitcnt >= 8:
            out.append((bitbuf >> (bitcnt - 8)) & 0xFF)
            bitcnt -= 8

    table: Dict[bytes, int] = {bytes([i]): i for i in range(256)}
    next_code = 258
    emit(CLEAR)
    w = b""
    for byte in data:
        c = bytes([byte])
        wc = w + c
        if wc in table:
            w = wc
        else:
            emit(table[w])
            table[wc] = next_code
            next_code += 1
            # early change, ENCODER side: bump once the next free code no
            # longer fits the current width (2^w); at 12 bits emit CLEAR
            # instead. Verified against libtiff/PIL (the previous
            # 2^w - 1 rule produced "code not yet in table" in libtiff).
            if next_code == (1 << width):
                if width < 12:
                    width += 1
                else:
                    emit(CLEAR)
                    table = {bytes([i]): i for i in range(256)}
                    next_code = 258
                    width = 9
            w = c
    if w:
        emit(table[w])
    emit(EOI)
    if bitcnt:
        out.append((bitbuf << (8 - bitcnt)) & 0xFF)
    return bytes(out)


def _apply_predictor(arr: np.ndarray, predictor: int) -> np.ndarray:
    if predictor == 2:
        out = arr.copy()
        out[:, 1:, :] = arr[:, 1:, :] - arr[:, :-1, :]
        return out
    return arr


_SAMPLE_FORMAT_OF_KIND = {"u": 1, "i": 2, "f": 3}


def write_tiff(path: str,
               array: np.ndarray,
               transform: Optional[Affine] = None,
               crs=None,
               nodata: Optional[float] = None,
               compression: str = "deflate",
               tiled: bool = False,
               tile_size: int = 256,
               bigtiff: Optional[bool] = None) -> None:
    """Write an (H, W) or (H, W, C) array as a little-endian GeoTIFF.
    ``bigtiff=None`` auto-selects BigTIFF when the raster exceeds classic
    TIFF's 4 GB offset range."""
    if array.ndim == 2:
        array = array[:, :, None]
    if array.ndim != 3:
        raise ValueError("array must be (H, W) or (H, W, C)")
    arr = np.ascontiguousarray(array)
    if arr.dtype.byteorder == ">":
        arr = arr.astype(arr.dtype.newbyteorder("<"))
    H, W, C = arr.shape
    kind = arr.dtype.kind
    if kind not in _SAMPLE_FORMAT_OF_KIND:
        raise ValueError(f"unsupported dtype {arr.dtype}")
    bits = arr.dtype.itemsize * 8
    comp_code = {"none": 1, "deflate": 8, "lzw": 5, "packbits": 32773}[compression]
    # the Predictor tag is only defined for LZW/Deflate; libtiff and GDAL
    # ignore it on PackBits, so differenced PackBits data would be read
    # back raw (silently wrong) by every standard reader
    predictor = 2 if (compression in ("lzw", "deflate") and kind in "ui") else 1

    # -- encode chunks
    chunks: List[bytes] = []
    if tiled:
        ts = tile_size
        tiles_x = (W + ts - 1) // ts
        tiles_y = (H + ts - 1) // ts
        for ty in range(tiles_y):
            for tx in range(tiles_x):
                tile = np.zeros((ts, ts, C), arr.dtype)
                r0, c0 = ty * ts, tx * ts
                sub = arr[r0:r0 + ts, c0:c0 + ts]
                tile[:sub.shape[0], :sub.shape[1]] = sub
                chunks.append(_encode_chunk(tile, comp_code, predictor))
    else:
        rows_per_strip = max(1, min(H, (1 << 20) // max(1, W * C * arr.dtype.itemsize)))
        for r0 in range(0, H, rows_per_strip):
            strip = arr[r0:r0 + rows_per_strip]
            chunks.append(_encode_chunk(strip, comp_code, predictor))

    # -- tags
    tags: List[Tuple[int, int, int, object]] = []  # (tag, type, count, values)
    tags.append((T_WIDTH, 4, 1, [W]))
    tags.append((T_LENGTH, 4, 1, [H]))
    tags.append((T_BITS, 3, C, [bits] * C))
    tags.append((T_COMPRESSION, 3, 1, [comp_code]))
    # tag 3-band uint8 as RGB so standard viewers render it in colour;
    # everything else is BlackIsZero with unspecified extra samples
    rgb = C == 3 and arr.dtype == np.uint8
    tags.append((T_PHOTOMETRIC, 3, 1, [2 if rgb else 1]))
    tags.append((T_SPP, 3, 1, [C]))
    if C > 1 and not rgb:
        tags.append((T_EXTRA, 3, C - 1, [0] * (C - 1)))  # unspecified extras
    tags.append((T_PLANAR, 3, 1, [1]))
    if predictor != 1:
        tags.append((T_PREDICTOR, 3, 1, [predictor]))
    tags.append((T_SAMPLE_FORMAT, 3, C, [_SAMPLE_FORMAT_OF_KIND[kind]] * C))
    if tiled:
        tags.append((T_TILE_W, 3, 1, [tile_size]))
        tags.append((T_TILE_L, 3, 1, [tile_size]))
        off_tag, cnt_tag = T_TILE_OFFSETS, T_TILE_COUNTS
    else:
        tags.append((T_ROWS_PER_STRIP, 4, 1, [rows_per_strip]))
        off_tag, cnt_tag = T_STRIP_OFFSETS, T_STRIP_COUNTS

    if transform is not None:
        t = transform
        if t.b == 0 and t.d == 0:
            tags.append((T_PIXEL_SCALE, 12, 3, [t.a, -t.e, 0.0]))
            tags.append((T_TIEPOINT, 12, 6, [0.0, 0.0, 0.0, t.c, t.f, 0.0]))
        else:
            mt = [t.a, t.b, 0, t.c, t.d, t.e, 0, t.f, 0, 0, 0, 0, 0, 0, 0, 1]
            tags.append((T_TRANSFORM, 12, 16, [float(v) for v in mt]))

    crs_obj = CRS.from_user_input(crs) if crs is not None else None
    if crs_obj is not None and crs_obj.to_epsg():
        epsg = crs_obj.to_epsg()
        is_geographic = crs_obj.is_geographic
        model = 2 if is_geographic else 1
        keys = [(GEOKEY_MODEL_TYPE, 0, 1, model),
                (GEOKEY_RASTER_TYPE, 0, 1, 1)]
        if is_geographic:
            keys.append((GEOKEY_GEOGRAPHIC_TYPE, 0, 1, epsg))
        else:
            keys.append((GEOKEY_PROJECTED_TYPE, 0, 1, epsg))
        kd = [1, 1, 0, len(keys)]
        for k in keys:
            kd.extend(k)
        tags.append((T_GEO_KEYS, 3, len(kd), kd))

    if nodata is not None:
        s = (f"{nodata}").encode() + b"\0"
        tags.append((T_GDAL_NODATA, 2, len(s), s))

    # -- layout: header + IFD + external tag data + chunk data
    total_chunk_bytes = sum(len(c) + (len(c) & 1) for c in chunks)
    if bigtiff is None:
        bigtiff = total_chunk_bytes > (1 << 32) - (1 << 24)
    n_entries = len(tags) + 2  # + offsets/counts tags
    if bigtiff:
        header_size = 16
        entry_size = 20
        inline = 8
        ifd_size = 8 + entry_size * n_entries + 8
        off_type = 16  # LONG8
        off_fmt = "Q"
    else:
        header_size = 8
        entry_size = 12
        inline = 4
        ifd_size = 2 + entry_size * n_entries + 4
        off_type = 4
        off_fmt = "I"
    ifd_offset = header_size
    data_cursor = ifd_offset + ifd_size

    def pack_values(typ: int, values) -> bytes:
        if typ == 2:
            return bytes(values)
        fmt = TYPE_FMT[typ]
        return struct.pack("<" + str(len(values)) + fmt, *values)

    ext_blobs: List[bytes] = []

    all_tags = tags + [
        (off_tag, off_type, len(chunks), None),   # placeholder
        (cnt_tag, off_type, len(chunks), [len(c) for c in chunks]),
    ]
    all_tags.sort(key=lambda t: t[0])

    # first pass: compute external space (placeholder offsets occupy same size)
    ext_size = 0
    for tag, typ, cnt, values in all_tags:
        size = TYPE_SIZES[typ] * cnt
        if size > inline:
            ext_size += size + (size & 1)
    chunk_data_start = data_cursor + ext_size
    chunk_offsets = []
    cur = chunk_data_start
    for c in chunks:
        chunk_offsets.append(cur)
        cur += len(c) + (len(c) & 1)

    ext_cursor = data_cursor
    out = bytearray()
    if bigtiff:
        out += struct.pack("<2sHHHQ", b"II", 43, 8, 0, ifd_offset)
        out += struct.pack("<Q", n_entries)
    else:
        out += struct.pack("<2sHI", b"II", 42, ifd_offset)
        out += struct.pack("<H", n_entries)
    for tag, typ, cnt, values in all_tags:
        if values is None:
            values = chunk_offsets
        blob = pack_values(typ, values)
        size = len(blob)
        if bigtiff:
            out += struct.pack("<HHQ", tag, typ, cnt)
        else:
            out += struct.pack("<HHI", tag, typ, cnt)
        if size <= inline:
            out += blob.ljust(inline, b"\0")
        else:
            out += struct.pack("<" + off_fmt, ext_cursor)
            ext_blobs.append(blob if size % 2 == 0 else blob + b"\0")
            ext_cursor += size + (size & 1)
    out += struct.pack("<" + off_fmt, 0)  # next IFD
    for blob in ext_blobs:
        out += blob
    with open(path, "wb") as f:
        f.write(bytes(out))
        for c in chunks:
            f.write(c)
            if len(c) & 1:
                f.write(b"\0")


def _encode_chunk(chunk: np.ndarray, comp_code: int, predictor: int) -> bytes:
    if predictor == 2:
        chunk = _apply_predictor(chunk, 2)
    raw = np.ascontiguousarray(chunk).tobytes()
    if comp_code == 1:
        return raw
    if comp_code == 8:
        return zlib.compress(raw, 6)
    if comp_code == 5:
        return lzw_encode(raw)
    if comp_code == 32773:
        return _packbits_encode(raw)
    raise ValueError(f"unsupported compression code {comp_code}")


def _packbits_encode(data: bytes) -> bytes:
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        # find run
        run = 1
        while i + run < n and run < 128 and data[i + run] == data[i]:
            run += 1
        if run >= 2:
            out += bytes([257 - run, data[i]])
            i += run
        else:
            # literal run
            start = i
            i += 1
            while i < n and i - start < 128:
                if i + 1 < n and data[i] == data[i + 1]:
                    break
                i += 1
            lit = data[start:i]
            out += bytes([len(lit) - 1]) + lit
    return bytes(out)
