"""Tiled segmentation: checkerboard two-pass with seam handling (port
of ``obia_tpu/utils/tiling.py``, ``bench.py`` config 3).

* PASS 1 segments the "black" tiles ((i//ts + j//ts) % 2 == 0) at native
  tile windows.
* PASS 2 expands each "white" tile window by ``buffer`` px on every side,
  removes two bottom corner squares (side ``buffer/2``) from the tile
  polygon, deletes previously-created segments fully within the reduced
  tile polygon, rasterises the surviving *overlapping* neighbours (plus the
  corner squares) into the mask, and re-segments only the uncovered area:
  seams stitch by construction against frozen neighbours.
* Black + white segments concatenate, ``segment_id`` renumbered 1..N,
  written to ``segments.gpkg``.

Tiles are read through the port's GeoTIFF reader a window at a time, and
each is segmented by ``create_segments`` (SLIC) on ``device``; the
predicates, the rasterisation and the GeoPackage I/O run on the host. Each
tile's polygons stay plain lists, so tiling needs no pandas: the result
is a :class:`SegmentLayer` (``geometry``, ``segment_id``, ``crs``,
``to_file``, ``to_geodataframe``).

As in the reference: ``input_mask`` is optional (the auto ``n_segments``
then counts the whole tile), and in the white pass without an input mask
the rasterised coverage is inverted, so the uncovered area is segmented (the
original obia passes the coverage itself there).
"""
from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np

from .. import telemetry
from ..checkpoint import TileManifest
from ..device import resolve_device
from ..geometry.affine import Affine
from ..geometry.geom import box
from ..geometry.rasterize import rasterize
from ..handlers.geotif import image_from_array
from ..io import gpkg
from ..io.tiff import TiffReader
from ..segmentation.segment_boundaries import SegmentLayer, create_segments


def get_raster_bbox(reader: TiffReader):
    """(min_x, min_y, max_x, max_y) of a raster."""
    t = reader.transform
    min_x, max_y = t.c, t.f
    max_x = min_x + reader.width * t.a
    min_y = max_y + reader.height * t.e
    return (min_x, min_y, max_x, max_y)


def _create_tile(reader: TiffReader, full_data: Optional[np.ndarray],
                 i_offset: int, j_offset: int, w: int, h: int,
                 binary_mask: bool = False):
    """Window a tile out of the raster. ``full_data`` is None on the
    streaming path: the tile decodes through the codec's windowed read, so
    rasters larger than host RAM never materialise."""
    if full_data is None:
        window = reader.read(window=(j_offset, i_offset, h, w))
    else:
        window = full_data[j_offset:j_offset + h, i_offset:i_offset + w]
    if binary_mask:
        return window[:, :, 0].astype(bool)
    t = reader.transform
    tile_transform = Affine(t.a, t.b, t.c + i_offset * t.a,
                            t.d, t.e, t.f + j_offset * t.e)
    return image_from_array(window.astype(np.float32), tile_transform,
                            crs=reader.crs)


def _auto_n_segments(mask: Optional[np.ndarray], h: int, w: int,
                     pixel_area: float, crown_radius: float) -> int:
    crown_area = math.pi * (crown_radius ** 2)
    covered = float(mask.sum()) if mask is not None else float(h * w)
    return max(1, round(covered * pixel_area / crown_area))


# Tiles are padded (with masked-out pixels) up to a multiple of this. In
# the reference the pad only let edge tiles reuse compiled programs, but
# SLIC derives its seed grid from the padded H x W (ops/slic._grid_shape),
# so it decides every tile's seeds and labels: dropping it would change the
# segmentation, and the port keeps it.
_TILE_SHAPE_BUCKET = 64


def _pad_tile_to_bucket(image, mask: Optional[np.ndarray]):
    """Pad a tile Image (+ mask) to the next _TILE_SHAPE_BUCKET multiple.
    Padding pixels are mask=0 (invalid), so segmentation results are
    confined to the real window; the affine origin is unchanged."""
    h, w, c = image.img_data.shape
    hp = -(-h // _TILE_SHAPE_BUCKET) * _TILE_SHAPE_BUCKET
    wp = -(-w // _TILE_SHAPE_BUCKET) * _TILE_SHAPE_BUCKET
    if hp == h and wp == w:
        return image, mask
    data = np.zeros((hp, wp, c), image.img_data.dtype)
    data[:h, :w] = image.img_data
    m = np.zeros((hp, wp), bool)
    m[:h, :w] = True if mask is None else np.asarray(mask, bool)
    padded = image_from_array(data, image.transform, crs=image.crs)
    return padded, m


def create_tiled_segments(input_raster: str, output_dir: str,
                          input_mask: Optional[str] = None,
                          method: str = "slic", tile_size: int = 200,
                          buffer: int = 30, crown_radius: float = 5,
                          resume: bool = False, retries: int = 1,
                          device=None, **kwargs) -> SegmentLayer:
    """Checkerboard two-pass tiled segmentation of the GeoTIFF
    ``input_raster``; writes ``segments.gpkg`` (layer ``segments``), the
    per-tile caches ``tiles/<tile>.gpkg`` and ``manifest.json`` into
    ``output_dir``, and returns the segments (``segment_id`` 1..N).

    Tiles are segmented on ``device``: the card when None (raising at once
    where there is none), the CPU with ``device="cpu"``. A tile that raises
    is retried ``retries`` times in all and then marked ``failed`` in the
    manifest, and the run goes on without it; ``resume=True`` reads every
    tile the manifest marks ``done`` back from its cache instead of
    segmenting it. ``kwargs`` go to ``create_segments`` (``n_segments``
    overrides the per-tile count derived from ``crown_radius``)."""
    if method != "slic":
        raise ValueError(
            "Currently, only the 'slic' method is supported for segmentation.")
    device = resolve_device(device)
    reader = TiffReader(input_raster)
    # stream tiles through the codec's windowed decode (planar=2 files
    # can't window-decode without a full pass, so those pre-read once)
    full = reader.read() if reader.planar == 2 else None
    mask_reader = mask_full = None
    if input_mask is not None:
        mask_reader = TiffReader(input_mask)
        mask_full = mask_reader.read() if mask_reader.planar == 2 else None

    width, height = reader.width, reader.height
    t = reader.transform
    pixel_area = abs(t.a) * abs(t.e)
    os.makedirs(output_dir, exist_ok=True)

    user_n_segments = kwargs.pop("n_segments", None)

    # tile-granular failure detection / resume: each tile's result is
    # durably cached and recorded in a manifest; a re-run with resume=True
    # skips completed tiles and retries failed ones
    tiles_dir = os.path.join(output_dir, "tiles")
    os.makedirs(tiles_dir, exist_ok=True)
    manifest = TileManifest(os.path.join(output_dir, "manifest.json"))

    def run_tile(tile_id, image, mask, n_segments):
        """Segment one tile with retry + manifest bookkeeping; returns its
        geometries (empty when it failed or found none)."""
        cache = os.path.join(tiles_dir, f"{tile_id}.gpkg")
        if resume and manifest.is_done(tile_id) and os.path.exists(cache):
            return gpkg.read_gpkg(cache)[1]
        last_err = None
        for _ in range(max(1, retries)):
            try:
                layer = create_segments(image=image, mask=mask,
                                        n_segments=n_segments,
                                        method="slic", device=device,
                                        **kwargs)
                geoms = list(layer.geometry)
                if geoms:
                    with telemetry.stage("tiling.write", host_only=True):
                        gpkg.write_features(
                            cache, [("segment_id", layer.segment_id)],
                            geoms, "tile", layer.crs)
                manifest.mark(tile_id, "done", n_segments=len(geoms))
                return geoms
            except Exception as e:  # every failure retries — genuinely
                last_err = e       # empty tiles are skipped BEFORE this
        manifest.mark(tile_id, "failed", error=str(last_err))
        print(f"tile FAILED after {max(1, retries)} attempts: "
              f"{tile_id} ({last_err!r})")
        return []

    # ---- PASS 1: black tiles ------------------------------------------------
    black = []
    with telemetry.stage("tiling.black", width * height / 2e6):
        for j in range(0, height, tile_size):
            for i in range(0, width, tile_size):
                if (i // tile_size + j // tile_size) % 2 != 0:
                    continue
                w = min(tile_size, width - i)
                h = min(tile_size, height - j)
                if w == 0 or h == 0:
                    continue
                image = _create_tile(reader, full, i, j, w, h)
                mask = (None if mask_reader is None
                        else _create_tile(mask_reader, mask_full, i, j, w, h,
                                          True))
                if mask is not None and not mask.any():
                    # genuinely empty tile (fully masked): record and move
                    # on — failures inside run_tile always mean real errors
                    manifest.mark(f"black_{j}_{i}", "done", n_segments=0)
                    continue
                n_segments = user_n_segments or _auto_n_segments(
                    mask, h, w, pixel_area, crown_radius)
                image, mask = _pad_tile_to_bucket(image, mask)
                black.extend(run_tile(f"black_{j}_{i}", image, mask,
                                      n_segments))

    # ---- PASS 2: white tiles with buffered windows --------------------------
    white_frames = []
    with telemetry.stage("tiling.white", width * height / 2e6):
        for j in range(0, height, tile_size):
            for i in range(0, width, tile_size):
                if (i // tile_size + j // tile_size) % 2 == 0:
                    continue
                i_offset = max(0, i - buffer)
                right_edge = min(width, i + tile_size + buffer)
                w = right_edge - i_offset
                j_offset = max(0, j - buffer)
                bottom_edge = min(height, j + tile_size + buffer)
                h = bottom_edge - j_offset
                if w <= 0 or h <= 0:
                    continue

                image = _create_tile(reader, full, i_offset, j_offset, w, h)
                mask = (None if mask_reader is None
                        else _create_tile(mask_reader, mask_full, i_offset,
                                          j_offset, w, h, True))

                tt = image.transform
                left, top = tt * (0, 0)
                right, bottom = tt * (w, h)
                tile_polygon = box(left, bottom, right, top)

                corner = buffer / 2 * abs(tt.a)
                minx, miny, maxx, maxy = tile_polygon.bounds
                bl_square = box(minx, miny, minx + corner, miny + corner)
                br_square = box(maxx - corner, miny, maxx, miny + corner)

                def reduced_predicates(geoms):
                    """within/frozen selection against the tile polygon
                    MINUS the two bottom corner squares: a segment fully
                    inside the box but poking into a corner square must be
                    FROZEN, not deleted — its corner-square pixels are
                    masked out of re-segmentation, so deleting it would
                    leave them permanently uncovered on edge tiles no later
                    diagonal tile re-covers."""
                    with telemetry.stage("tiling.predicates",
                                         host_only=True):
                        within_box = np.array(
                            [g.within(tile_polygon) for g in geoms], bool)
                        pokes = np.array(
                            [g.intersects(bl_square)
                             or g.intersects(br_square) for g in geoms],
                            bool)
                        overlaps = np.array(
                            [g.overlaps(tile_polygon) for g in geoms], bool)
                    within = within_box & ~pokes
                    frozen = (overlaps | (within_box & pokes)) & ~within
                    return within, frozen

                # delete fully-within previous segments (re-segmented now)
                # and freeze the overlapping ones; earlier white frames are
                # visited PER FRAME, which keeps pass 2 linear in tiles
                frozen_geoms = []
                if black:
                    within, frozen = reduced_predicates(black)
                    frozen_geoms.extend(g for g, f in zip(black, frozen) if f)
                    black = [g for g, w_ in zip(black, within) if not w_]
                for k, f in enumerate(white_frames):
                    if not f:
                        continue
                    within, frozen = reduced_predicates(f)
                    frozen_geoms.extend(g for g, fz in zip(f, frozen) if fz)
                    white_frames[k] = [g for g, w_ in zip(f, within)
                                       if not w_]

                if frozen_geoms:
                    shapes = [(g, 1) for g in frozen_geoms]
                    shapes += [(bl_square, 1), (br_square, 1)]
                    with telemetry.stage("tiling.rasterize", host_only=True):
                        covered = rasterize(shapes, (h, w), transform=tt,
                                            fill=0, dtype=np.uint8)
                    if mask is not None:
                        mask = mask.copy()
                        mask[covered == 1] = False
                    else:
                        mask = covered == 0  # the uncovered area
                else:
                    # no frozen neighbours: the mask is left as it is
                    print(f"No overlapping black segments found for tile "
                          f"({i}, {j}).")
                    if mask is None:
                        mask = np.ones((h, w), bool)

                if not mask.any():
                    manifest.mark(f"white_{j}_{i}", "done", n_segments=0)
                    continue
                n_segments = user_n_segments or _auto_n_segments(
                    mask, h, w, pixel_area, crown_radius)
                image, mask = _pad_tile_to_bucket(image, mask)
                geoms = run_tile(f"white_{j}_{i}", image,
                                 mask.astype(np.uint8), n_segments)
                if geoms:
                    white_frames.append(geoms)

    geometry = black + [g for f in white_frames for g in f]
    out = SegmentLayer(len(geometry), geometry, reader.crs, t,
                       [t.a, t.b, t.d, t.e, t.c, t.f], None, None)
    with telemetry.stage("tiling.write", host_only=True):
        out.to_file(os.path.join(output_dir, "segments.gpkg"),
                    layer="segments")
    return out
