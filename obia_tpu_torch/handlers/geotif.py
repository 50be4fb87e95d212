"""Raster container and GeoTIFF I/O (port of ``obia_tpu/handlers/geotif.py``).

``Image.img_data`` is an (H, W, C) float32 numpy array, as in the
reference; ``device_tensor(device)`` uploads it once per device and caches
it. Files are read with the port's own GeoTIFF reader
(:mod:`obia_tpu_torch.io.tiff`), which ``Image.reader`` (alias
``rasterio_obj``, the reference's name) holds. The port's entry points also
take any container with ``img_data``, ``crs``, ``transform`` and
``affine_transformation``, such as the JAX package's ``Image``.
``open_binary_geotiff_as_mask`` returns the reference's 4-tuple
(mask, bbox, transform, profile). PIL is imported only by the functions
that build a PIL image (``Image.to_image``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..geometry.affine import Affine
from ..geometry.crs import CRS
from ..io.tiff import TiffReader, write_tiff


class Image:
    """Geo-referenced raster: (H, W, C) float32 data + CRS + affine."""

    def __init__(self, img_data: np.ndarray, crs, affine_transformation,
                 transform, reader=None, nodata: Optional[float] = None,
                 raw_data: Optional[np.ndarray] = None, rasterio_obj=None):
        self.img_data = img_data
        self.crs = crs
        self.affine_transformation = affine_transformation
        self.transform = transform
        self.reader = reader if reader is not None else rasterio_obj
        self.nodata = nodata
        self._raw = raw_data  # source-dtype copy for cheap uploads
        self._device_cache = {}

    def device_tensor(self, device) -> torch.Tensor:
        """The raster as a float32 (H, W, C) tensor on ``device``, uploaded
        once and cached. A narrow source dtype (uint8, uint16) crosses to
        the device in its own dtype and is cast there."""
        device = torch.device(device)
        t = self._device_cache.get(device)
        if t is None or tuple(t.shape) != self.img_data.shape:
            src = (self._raw if self._raw is not None
                   and self._raw.dtype.itemsize < 4
                   and self._raw.shape == self.img_data.shape
                   else self.img_data)
            t = torch.from_numpy(np.ascontiguousarray(src)).to(device)
            t = t.to(torch.float32)
            self._device_cache[device] = t
        return t

    @property
    def rasterio_obj(self):
        """The reference's name for :attr:`reader`."""
        return self.reader

    @rasterio_obj.setter
    def rasterio_obj(self, value):
        self.reader = value

    @property
    def shape(self):
        return self.img_data.shape

    @property
    def height(self) -> int:
        return self.img_data.shape[0]

    @property
    def width(self) -> int:
        return self.img_data.shape[1]

    @property
    def count(self) -> int:
        return self.img_data.shape[2]

    def to_image(self, bands: Sequence[int], p_min: int = 2, p_max: int = 98,
                 stretch_type: Optional[str] = None):
        """Three bands as a stretched RGB PIL image: a ``p_min``-``p_max``
        percentile stretch to 8 bits, then ``"histogram_equalization"`` or
        ``"clahe"`` when ``stretch_type`` names one (imports PIL)."""
        from PIL.Image import fromarray

        from ..utils.image import (apply_clahe, apply_histogram_equalization,
                                   rescale_to_8bit)
        if not isinstance(bands, (list, tuple)) or len(bands) != 3:
            raise ValueError("'bands' should be a list or tuple of exactly "
                             "three elements")
        num_bands = self.img_data.shape[2]
        for band in bands:
            if band >= num_bands or band < 0:
                raise IndexError(f"Band index {band} out of range. Available "
                                 f"bands indices: 0 to {num_bands - 1}.")
        rgb = np.ascontiguousarray(self.img_data[:, :, list(bands)],
                                   dtype=np.float32)
        rgb8 = rescale_to_8bit(rgb, min=p_min, max=p_max)
        if stretch_type == "histogram_equalization":
            rgb8 = apply_histogram_equalization(rgb8)
        elif stretch_type == "clahe":
            rgb8 = apply_clahe(rgb8)
        elif stretch_type is not None:
            raise ValueError(f"Unknown stretch_type: {stretch_type}")
        return fromarray(rgb8.astype(np.uint8))


def as_image(image) -> Image:
    """The port's ``Image`` for ``image``: returned as it is when it already
    is one, else rebuilt from a duck-typed container such as the JAX
    package's ``Image`` (its array is shared, not copied)."""
    if isinstance(image, Image):
        return image
    return Image(np.asarray(image.img_data, np.float32), _as_crs(image.crs),
                 list(image.affine_transformation), image.transform,
                 nodata=getattr(image, "nodata", None))


def _as_crs(crs) -> Optional[CRS]:
    """The port's :class:`CRS` for ``crs``, which may be another package's
    CRS object (anything with ``to_epsg`` and ``to_wkt``)."""
    if crs is None or isinstance(crs, CRS):
        return crs
    if hasattr(crs, "to_epsg"):
        epsg = crs.to_epsg()
        return CRS.from_epsg(epsg) if epsg is not None else CRS.from_wkt(
            crs.to_wkt())
    return CRS.from_user_input(crs)


def open_geotiff(image_path: str, bands: Optional[List[int]] = None) -> Image:
    """Open a GeoTIFF; ``bands`` are 1-based indices."""
    reader = TiffReader(image_path)
    full = reader.read()
    if bands is None:
        bands = list(range(1, reader.spp + 1))
    for b in bands:
        if not 1 <= b <= reader.spp:
            raise IndexError(f"band index {b} out of range: bands are "
                             f"1-based, 1..{reader.spp}")
    raw = np.ascontiguousarray(full[:, :, [b - 1 for b in bands]])
    t = reader.transform
    return Image(raw.astype(np.float32), reader.crs,
                 [t.a, t.b, t.d, t.e, t.c, t.f], t, reader,
                 nodata=reader.nodata, raw_data=raw)


def _write_geotiff(pil_image, output_path: str, crs, transform) -> None:
    """Write a PIL image or an array as a uint8 GeoTIFF. A band-first
    array (at most 4 bands first, a last axis longer than 4) is written
    band-last; a PIL image is always (H, W[, C])."""
    from_pil = not isinstance(pil_image, np.ndarray)
    data = np.array(pil_image).astype(np.uint8)
    if (not from_pil and data.ndim == 3 and data.shape[0] <= 4
            and data.shape[0] < data.shape[2] and data.shape[2] > 4):
        data = np.transpose(data, (1, 2, 0))
    write_tiff(output_path, data, transform=transform, crs=crs)
    print(f"Done Writing GeoTIFF at {output_path}")


def open_binary_geotiff_as_mask(mask_path: str):
    """Band 1 of a GeoTIFF as a boolean mask: the reference's 4-tuple
    (mask, bbox (left, bottom, right, top), transform, profile)."""
    reader = TiffReader(mask_path)
    mask_array = reader.read()[:, :, 0].astype(bool)
    transform = reader.transform
    width, height = reader.width, reader.height
    left, top = transform * (0, 0)
    right, bottom = transform * (width, height)
    profile = {"width": width, "height": height, "count": reader.spp,
               "dtype": reader.dtype, "crs": reader.crs,
               "transform": transform, "nodata": reader.nodata}
    return mask_array, (left, bottom, right, top), transform, profile


def image_from_array(img_data: np.ndarray, transform: Affine, crs=None,
                     nodata: Optional[float] = None) -> Image:
    """An in-memory :class:`Image` (no file backing)."""
    if img_data.ndim == 2:
        img_data = img_data[:, :, None]
    raw = (np.ascontiguousarray(img_data)
           if np.asarray(img_data).dtype.itemsize < 4 else None)
    crs_obj = _as_crs(crs)
    t = transform
    return Image(np.asarray(img_data, dtype=np.float32), crs_obj,
                 [t.a, t.b, t.d, t.e, t.c, t.f], t, nodata=nodata,
                 raw_data=raw)
