"""Segment boundaries: raster -> dense label raster -> polygons (port of
``obia_tpu/segmentation/segment_boundaries.py``).

SLIC, connectivity and the small-segment merge run on the chosen device;
the labels cross to the host once, as row-wise runs, and the shared native
polygoniser (``obia_tpu.native``) traces every object from those runs,
optionally in a background thread that overlaps the device featurisation.
The result is a pandas-free :class:`SegmentLayer`.
"""
from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor
from typing import List, Sequence

import numpy as np
import torch

from obia_tpu.geometry.crs import CRS

from .. import telemetry
from ..handlers.geotif import as_image

_SLIC_KWARGS = {
    "n_segments", "compactness", "max_num_iter", "sigma", "spacing",
    "convert2lab", "enforce_connectivity", "min_size_factor",
    "max_size_factor", "slic_zero", "start_label", "mask", "channel_axis",
}


def _normalize_select(dev: torch.Tensor, bands: Sequence[int]
                      ) -> torch.Tensor:
    """Per-band min-max normalisation to [0, 1] of the selected bands
    (constant bands map to 0)."""
    sel = dev[:, :, list(bands)]
    bmin = sel.amin(dim=(0, 1), keepdim=True)
    brange = sel.amax(dim=(0, 1), keepdim=True) - bmin
    pos = brange > 0
    return torch.where(pos, (sel - bmin) / torch.where(
        pos, brange, torch.ones_like(brange)), torch.zeros_like(sel))


class SegmentLayer:
    """The polygon layer: segment ids 1..K (row k holds label k - 1), one
    geometry per segment, the CRS and transform, and the label raster on
    the host (row-wise runs, decoded on demand) and on the device."""

    def __init__(self, n: int, geometry, crs, transform, affine,
                 label_raster, labels_dev: torch.Tensor):
        self.n = int(n)
        self._geometry = geometry  # list, or a Future of one
        self.crs = crs
        self.transform = transform
        self.affine_transformation = affine
        self.label_raster = label_raster
        self.labels_dev = labels_dev

    def __len__(self) -> int:
        return self.n

    @property
    def segment_id(self) -> np.ndarray:
        return np.arange(1, self.n + 1)

    @property
    def geometry(self) -> List:
        """One geometry per segment; joins a pending polygonisation."""
        if isinstance(self._geometry, Future):
            self._geometry = self._geometry.result()
        return self._geometry


def _polygonize(label_raster, n_labels: int, affine) -> List:
    """World-space geometry per label 0..n-1 (Polygon, or MultiPolygon for a
    region pinched at a corner) from the RLE label raster."""
    from obia_tpu import native
    from obia_tpu.geometry.geom import (MultiPolygon, affine_transform,
                                        affine_transform_coords)
    from obia_tpu.geometry.polygonize import (group_rings_packed,
                                              polygonize_labels)

    packed = native.polygonize_rings_rle_packed(
        label_raster.values, label_raster.lengths, label_raster.shape)
    if packed is not None:
        rlabels, n_pts, areas, coords = packed
        coords = affine_transform_coords(coords, affine)
        offsets = np.concatenate([[0], np.cumsum(n_pts)])
        polys = group_rings_packed(rlabels, areas, offsets, coords)
        world = True
    else:  # no C++ compiler: the numpy polygoniser, pixel space
        polys = polygonize_labels(np.asarray(label_raster))
        world = False
    out = []
    for label in range(n_labels):
        plist = polys.get(label, [])
        geom = plist[0] if len(plist) == 1 else MultiPolygon(plist)
        out.append(geom if world else affine_transform(geom, affine))
    return out


def create_segments(image, segmentation_bands=None, method: str = "slic",
                    device=None, _async_polygonize: bool = False,
                    **kwargs) -> SegmentLayer:
    """Segment an image into a :class:`SegmentLayer` (segment_id 1..N).

    ``device`` is where segmentation runs; None runs it where the image's
    numpy data lives, the CPU. Only ``method="slic"`` is ported. With
    ``_async_polygonize`` the host polygonisation runs in a background
    thread (the native tracer releases the GIL) and ``geometry`` joins it.
    """
    from ..ops.slic import LazyRLERaster, download_labels_rle, slic_dense

    if method != "slic":
        raise NotImplementedError(
            f"method={method!r}: only slic is ported to obia_tpu_torch")
    unknown = set(kwargs) - _SLIC_KWARGS
    if unknown:
        raise TypeError(f"slic got unexpected arguments: {sorted(unknown)}")
    image = as_image(image)
    device = torch.device("cpu" if device is None else device)
    H, W, num_bands = image.img_data.shape
    bands = (list(range(num_bands)) if segmentation_bands is None
             else list(segmentation_bands))
    for band in bands:
        if band >= num_bands or band < 0:
            raise IndexError(f"Band index {band} out of range. Available "
                             f"bands indices: 0 to {num_bands - 1}.")
    mp = H * W / 1e6
    enforce = kwargs.get("enforce_connectivity", True)
    dense_kwargs = {k: v for k, v in kwargs.items()
                    if k not in ("start_label", "enforce_connectivity")}
    with telemetry.stage("segment.kernel", mp):
        img = _normalize_select(image.device_tensor(device), bands)
        labels, n_labels = slic_dense(img, enforce_connectivity=enforce,
                                      **dense_kwargs)
        if not enforce:
            # one label per connected region, without the merge
            from ..ops.connectivity import ccl_dense_labels
            labels, n_labels = ccl_dense_labels(labels)
    with telemetry.stage("slic.download"):
        label_raster = LazyRLERaster(*download_labels_rle(labels))

    def polygonize():
        with telemetry.stage("segment.polygonize", mp, host_only=True):
            return _polygonize(label_raster, n_labels,
                               image.affine_transformation)

    if _async_polygonize:
        ex = ThreadPoolExecutor(max_workers=1)
        geometry = ex.submit(polygonize)
        ex.shutdown(wait=False)
    else:
        geometry = polygonize()
    crs = CRS.from_user_input(image.crs) if image.crs is not None else None
    return SegmentLayer(n_labels, geometry, crs, image.transform,
                        image.affine_transformation, label_raster, labels)
