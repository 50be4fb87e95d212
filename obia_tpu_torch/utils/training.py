"""Detection tile preprocessor: geo-tiling + annotation generation (the
port's counterpart of ``obia_tpu/utils/training.py``).

``generate_tiles`` (reference training.py:16-33) steps through raster
bounds in geo-units with overlap; ``tile_and_process`` (:35-338) cuts each
tile: band select (1-based), 8-bit rescale (percentile or min-max),
optional CLAHE, optional canopy-mask background treatment (Gaussian blur +
darken + hard or distance-transform-feathered blend), and writes JPEG
tiles plus ``annotations.json`` (pixel bboxes from polygon bounds) and
``transforms.json`` (per-tile affine + CRS).

It is host code: the port's GeoTIFF reader, the pandas-free
:func:`obia_tpu_torch.vector.features.read_features` for the boxes, PIL
for the JPEG tiles (imported inside ``tile_and_process``), and OpenCV for
the blur and distance transform where it imports, scipy otherwise, as the
reference does.
"""
from __future__ import annotations

import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from ..geometry.affine import Affine
from ..geometry.geom import box
from ..io.tiff import TiffReader
from ..vector.features import read_features
from .image import _cv2, apply_clahe, rescale_to_8bit


def _gaussian_blur(img: np.ndarray, ksize: Tuple[int, int]) -> np.ndarray:
    """cv2.GaussianBlur(img, ksize, 0) with cv2 optional: sigma derived
    from the kernel size the way OpenCV does (0.3*((k-1)*0.5 - 1) + 0.8)."""
    cv2 = _cv2()
    if cv2 is not None:
        return cv2.GaussianBlur(img, ksize, 0)
    from scipy.ndimage import gaussian_filter
    sigmas = [0.3 * ((k - 1) * 0.5 - 1) + 0.8 for k in ksize]
    out = np.empty_like(img)
    if img.ndim == 3:
        for c in range(img.shape[2]):
            out[..., c] = gaussian_filter(
                img[..., c], sigma=sigmas, mode="mirror")
    else:
        out[...] = gaussian_filter(img, sigma=sigmas, mode="mirror")
    return out


def _distance_transform_l2(binary_u8: np.ndarray) -> np.ndarray:
    """cv2.distanceTransform(x, DIST_L2, 3) equivalent: distance from each
    nonzero pixel to the nearest zero pixel."""
    cv2 = _cv2()
    if cv2 is not None:
        return cv2.distanceTransform(binary_u8, cv2.DIST_L2, 3)
    from scipy.ndimage import distance_transform_edt
    return distance_transform_edt(binary_u8 != 0).astype(np.float32)


def generate_tiles(bounds, step: float, tile_size: float):
    """Yield (minx, miny, maxx, maxy) tiles over ``bounds`` with the given
    stride (reference training.py:16-33)."""
    minx, miny, maxx, maxy = bounds
    y = miny
    while y < maxy:
        x = minx
        tile_top = y + tile_size
        while x < maxx:
            tile_right = x + tile_size
            yield (x, y, min(tile_right, maxx), min(tile_top, maxy))
            x += step
        y += step


def _geom_bounds(geometries) -> Tuple[np.ndarray, ...]:
    """Each geometry's bounds as four columns (NaN for a missing
    geometry, which then meets no tile): the tile loop's bbox prefilter
    (the reference's spatial-index ``gdf.cx[...]``, training.py:141)."""
    b = np.array([g.bounds if g is not None else (np.nan,) * 4
                  for g in geometries], float).reshape(len(geometries), 4)
    return b[:, 0], b[:, 1], b[:, 2], b[:, 3]


def _window_from_bounds(minx, miny, maxx, maxy, transform: Affine,
                        H: int, W: int):
    inv = ~transform
    c0, r0 = inv * (minx, maxy)
    c1, r1 = inv * (maxx, miny)
    row0 = max(0, int(round(min(r0, r1))))
    row1 = min(H, int(round(max(r0, r1))))
    col0 = max(0, int(round(min(c0, c1))))
    col1 = min(W, int(round(max(c0, c1))))
    return row0, row1, col0, col1


def tile_and_process(raster_path: str,
                     mask_path: Optional[str] = None,
                     boxes_gpkg_path: Optional[str] = None,
                     output_dir: str = "output_tiles",
                     tile_size: float = 150.0,
                     overlap: float = 50.0,
                     selected_bands: Sequence[int] = (4, 2, 1),
                     feather_radius: float = 0.0,
                     blur_kernel=5,
                     darken_factor: float = 0.8,
                     apply_clahe_flag: bool = True,
                     rescale: bool = True) -> None:
    """Tile a raster (+mask) into JPEG training tiles with annotations and
    per-tile transforms (reference training.py:35-338). A mask (nonzero =
    canopy, 0/1 or 0/255) keeps canopy pixels and blurs and darkens the
    rest; ``feather_radius`` > 0 blends the two over that many pixels."""
    from PIL import Image as PILImage

    os.makedirs(output_dir, exist_ok=True)
    step = tile_size - overlap
    if step <= 0:
        raise ValueError(
            f"overlap ({overlap}) must be smaller than tile_size "
            f"({tile_size}) — a non-positive step would never advance")

    boxes = read_features(boxes_gpkg_path) if boxes_gpkg_path else None

    reader = TiffReader(raster_path)
    if boxes is not None:
        # reproject the boxes to the raster CRS (the reference's
        # gdf.to_crs(src.crs), training.py:117); unsupported CRS pairs
        # raise instead of silently mis-registering tiles
        from ..geometry.transform_crs import to_raster_crs
        boxes = to_raster_crs(boxes, reader.crs)
        bx0, by0, bx1, by1 = _geom_bounds(boxes.geometry)
    # per-tile windows through the codec's windowed decode (the reference
    # reads per window too, training.py:141-160); planar=2 files cannot
    # window-decode, so they are read whole once
    full = reader.read() if reader.planar == 2 else None
    H, W = reader.height, reader.width
    t = reader.transform
    bounds = (t.c, t.f + H * t.e, t.c + W * t.a, t.f)

    mask_reader = mask_full = None
    if mask_path:
        mask_reader = TiffReader(mask_path)
        if mask_reader.planar == 2:
            mask_full = mask_reader.read()[:, :, 0]

    all_annotations = {}
    transforms_dict = {}
    tile_index = 0

    n_bands = reader.spp
    for b in selected_bands:
        if not 1 <= b <= n_bands:
            raise IndexError(
                f"selected_bands are 1-based (rasterio convention, like "
                f"the reference): {b} out of range 1..{n_bands}")
    band_idx = [b - 1 for b in selected_bands]

    for tbox in generate_tiles(bounds, step, tile_size):
        tile_index += 1
        minx, miny, maxx, maxy = tbox

        tile_geoms = []
        if boxes is not None and len(boxes):
            tile_poly = box(minx, miny, maxx, maxy)
            # bbox prefilter, then the exact within test
            cand = np.flatnonzero((bx1 >= minx) & (bx0 <= maxx)
                                  & (by1 >= miny) & (by0 <= maxy))
            tile_geoms = [boxes.geometry[i] for i in cand
                          if boxes.geometry[i].within(tile_poly)]

        row0, row1, col0, col1 = _window_from_bounds(minx, miny, maxx, maxy,
                                                     t, H, W)
        if row1 <= row0 or col1 <= col0:
            continue
        if full is not None:
            data = full[row0:row1, col0:col1][:, :, band_idx]
        else:
            data = reader.read(window=(row0, col0, row1 - row0,
                                       col1 - col0))[:, :, band_idx]
        tile_img = data.astype(np.float32)

        if rescale:
            tile_img_8bit = rescale_to_8bit(tile_img)
        else:
            tmin, tmax = tile_img.min(), tile_img.max()
            if tmin == tmax:
                tile_img_8bit = np.zeros_like(tile_img, dtype=np.uint8)
            else:
                tile_img_8bit = np.clip(
                    255 * (tile_img - tmin) / (tmax - tmin), 0, 255
                ).astype(np.uint8)

        if apply_clahe_flag:
            # apply_clahe handles multiband input itself (split/merge)
            tile_img_final = apply_clahe(tile_img_8bit)
        else:
            tile_img_final = tile_img_8bit

        if mask_reader is not None:
            if mask_full is not None:
                mwin = mask_full[row0:row1, col0:col1]
            else:
                mwin = mask_reader.read(window=(row0, col0, row1 - row0,
                                                col1 - col0))[:, :, 0]
            # normalise to {0, 1}: masks are commonly 0/255-encoded, and
            # raw 255 values wrap the uint8 blend arithmetic below
            mask_data = (mwin > 0).astype(np.uint8)
            bk = blur_kernel
            if isinstance(bk, int):
                bk = None if bk == 0 else (bk, bk)
            elif bk == (0, 0):
                bk = None
            blurred = (tile_img_final if bk is None
                       else _gaussian_blur(tile_img_final, bk))
            darkened = (blurred if darken_factor == 0
                        else (blurred * darken_factor).astype(np.uint8))
            if feather_radius > 0:
                mask_8u = (mask_data * 255).astype(np.uint8)
                dist = _distance_transform_l2(255 - mask_8u)
                alpha = np.clip(1.0 - dist / feather_radius, 0.0, 1.0)
                alpha3 = np.dstack([alpha] * tile_img_final.shape[2])
                out_img = np.clip(
                    alpha3 * tile_img_final.astype(np.float32)
                    + (1 - alpha3) * darkened.astype(np.float32),
                    0, 255).astype(np.uint8)
            else:
                mask3 = np.stack([mask_data] * tile_img_final.shape[2],
                                 axis=-1)
                out_img = (tile_img_final * mask3
                           + darkened * (1 - mask3)).astype(np.uint8)
        else:
            out_img = tile_img_final

        out_h, out_w = out_img.shape[:2]
        tile_transform = t * Affine.translation(col0, row0)

        tile_name = f"img_{tile_index:03d}.jpg"
        PILImage.fromarray(out_img[:, :, :3] if out_img.shape[2] >= 3
                           else out_img[:, :, 0]).save(
            os.path.join(output_dir, tile_name), quality=95)

        transforms_dict[tile_name] = {
            "transform": [tile_transform.a, tile_transform.b,
                          tile_transform.c, tile_transform.d,
                          tile_transform.e, tile_transform.f],
            "crs": str(reader.crs) if reader.crs else "",
        }

        if tile_geoms:
            inv = ~t
            boxes_array = []
            labels_array = []
            for geom in tile_geoms:
                pxmin, pymin, pxmax, pymax = geom.bounds
                col_tl, row_tl = inv * (pxmin, pymax)
                col_br, row_br = inv * (pxmax, pymin)
                x_min = max(0, min(int(col_tl) - col0, out_w - 1))
                x_max = max(0, min(int(col_br) - col0, out_w - 1))
                y_min = max(0, min(int(row_tl) - row0, out_h - 1))
                y_max = max(0, min(int(row_br) - row0, out_h - 1))
                if x_min >= x_max or y_min >= y_max:
                    continue
                boxes_array.append([x_min, y_min, x_max, y_max])
                labels_array.append(1)
            all_annotations[f"img_{tile_index:03d}"] = {
                "file_name": tile_name,
                "boxes": boxes_array,
                "labels": labels_array,
            }

    if boxes is not None:
        with open(os.path.join(output_dir, "annotations.json"), "w") as f:
            json.dump(all_annotations, f, indent=2)
        print(f"Annotations JSON written to: "
              f"{os.path.join(output_dir, 'annotations.json')}")
    with open(os.path.join(output_dir, "transforms.json"), "w") as ft:
        json.dump(transforms_dict, ft, indent=2)
    print(f"Transforms JSON written to: "
          f"{os.path.join(output_dir, 'transforms.json')}")
    print("Done! Tiles written to:", output_dir)
