"""Raster container (port of the ``Image`` of ``obia_tpu/handlers/geotif.py``).

``Image.img_data`` is an (H, W, C) float32 numpy array, as in the
reference; ``device_tensor(device)`` uploads it once per device and caches
it. Files are read with the port's own GeoTIFF reader
(:mod:`obia_tpu_torch.io.tiff`). The port's entry points also take any
container with ``img_data``, ``crs``, ``transform`` and
``affine_transformation``, such as the JAX package's ``Image``.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..geometry.affine import Affine
from ..geometry.crs import CRS
from ..io.tiff import TiffReader


class Image:
    """Geo-referenced raster: (H, W, C) float32 data + CRS + affine."""

    def __init__(self, img_data: np.ndarray, crs, affine_transformation,
                 transform, reader=None, nodata: Optional[float] = None,
                 raw_data: Optional[np.ndarray] = None):
        self.img_data = img_data
        self.crs = crs
        self.affine_transformation = affine_transformation
        self.transform = transform
        self.reader = reader
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
