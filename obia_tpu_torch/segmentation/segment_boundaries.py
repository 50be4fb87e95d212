"""Segment boundaries: raster -> dense label raster -> polygons (port of
``obia_tpu/segmentation/segment_boundaries.py``).

SLIC (with connectivity and the small-segment merge) or quickshift (with
connected components of its root raster) runs on the chosen device; the
labels cross to the host once, as row-wise runs, and the port's native
polygoniser (:mod:`obia_tpu_torch.native`) traces every object from those
runs, optionally in a background thread that overlaps the device
featurisation. The result is a pandas-free :class:`SegmentLayer`.
"""
from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor
from typing import List, Sequence

import numpy as np
import torch

from .. import telemetry
from ..device import resolve_device
from ..geometry.crs import CRS
from ..handlers.geotif import as_image

_SLIC_KWARGS = {
    "n_segments", "compactness", "max_num_iter", "sigma", "spacing",
    "convert2lab", "enforce_connectivity", "min_size_factor",
    "max_size_factor", "slic_zero", "start_label", "mask", "channel_axis",
}
_QUICKSHIFT_KWARGS = {
    "ratio", "kernel_size", "max_dist", "sigma", "convert2lab", "rng",
    "random_seed", "channel_axis",
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
    the host (row-wise runs, decoded on demand) and on the device. A layer
    from the mosaic also keeps the labels in their mesh blocks (``shards``,
    a :class:`obia_tpu_torch.parallel.mesh.ShardedRaster`), and its
    features are then reduced over the mesh."""

    def __init__(self, n: int, geometry, crs, transform, affine,
                 label_raster, labels_dev: torch.Tensor, shards=None):
        self.n = int(n)
        self._geometry = geometry  # list, or a Future of one
        self.crs = crs
        self.transform = transform
        self.affine_transformation = affine
        self.label_raster = label_raster
        self.labels_dev = labels_dev
        self.shards = shards

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
    from .. import native
    from ..geometry.geom import MultiPolygon, affine_transform_coords
    from ..geometry.polygonize import group_rings_packed

    rlabels, n_pts, areas, coords = native.polygonize_rings_rle_packed(
        label_raster.values, label_raster.lengths, label_raster.shape)
    coords = affine_transform_coords(coords, affine)
    offsets = np.concatenate([[0], np.cumsum(n_pts)])
    polys = group_rings_packed(rlabels, areas, offsets, coords)
    out = []
    for label in range(n_labels):
        plist = polys.get(label, [])
        out.append(plist[0] if len(plist) == 1 else MultiPolygon(plist))
    return out


def create_segments(image, segmentation_bands=None, method: str = "slic",
                    device=None, _async_polygonize: bool = False,
                    **kwargs) -> SegmentLayer:
    """Segment an image into a :class:`SegmentLayer` (segment_id 1..N).

    ``method`` is ``"slic"`` or ``"quickshift"``; ``device`` is where
    segmentation runs: the card (``"cuda"``) when None, which raises where
    there is none; ``device="cpu"`` runs it on the CPU. Quickshift's roots go straight to connected components, which
    number them in raster order: the reference's host compaction followed
    by ``relabel_connected`` gives the same labels. With
    ``_async_polygonize`` the host polygonisation runs in a background
    thread (the native tracer releases the GIL) and ``geometry`` joins it.
    """
    from ..ops.connectivity import ccl_dense_labels
    from ..ops.slic import slic_dense

    if method == "slic":
        unknown = set(kwargs) - _SLIC_KWARGS
        if unknown:
            raise TypeError(f"slic got unexpected arguments: "
                            f"{sorted(unknown)}")
    elif method == "quickshift":
        unknown = set(kwargs) - _QUICKSHIFT_KWARGS
        if unknown:
            raise TypeError(
                f"quickshift got unexpected arguments: {sorted(unknown)} "
                "(note: quickshift takes no 'mask' — reference quirk #12)")
    else:
        raise Exception("An unknown segmentation method was requested.")
    image = as_image(image)
    device = resolve_device(device)
    H, W, num_bands = image.img_data.shape
    bands = (list(range(num_bands)) if segmentation_bands is None
             else list(segmentation_bands))
    for band in bands:
        if band >= num_bands or band < 0:
            raise IndexError(f"Band index {band} out of range. Available "
                             f"bands indices: 0 to {num_bands - 1}.")
    mp = H * W / 1e6
    with telemetry.stage("segment.kernel", mp):
        img = _normalize_select(image.device_tensor(device), bands)
        if method == "quickshift":
            from ..ops.quickshift import quickshift_tree
            root = quickshift_tree(img, **kwargs)[0]
            with telemetry.stage("segment.ccl", mp):
                labels, n_labels = ccl_dense_labels(root)
        else:
            enforce = kwargs.get("enforce_connectivity", True)
            dense_kwargs = {k: v for k, v in kwargs.items()
                            if k not in ("start_label",
                                         "enforce_connectivity")}
            labels, n_labels = slic_dense(img, enforce_connectivity=enforce,
                                          **dense_kwargs)
            if not enforce:
                # one label per connected region, without the merge
                labels, n_labels = ccl_dense_labels(labels)
    return layer_from_labels(labels, n_labels, image, "segment",
                             _async_polygonize)


def layer_from_labels(labels: torch.Tensor, n_labels: int, image,
                      stage: str, async_polygonize: bool = False,
                      shards=None) -> SegmentLayer:
    """Download dense (H, W) labels as row-wise runs, polygonise them (in a
    background thread with ``async_polygonize``) and wrap the result in a
    :class:`SegmentLayer`; ``stage`` prefixes the telemetry stages."""
    from ..ops.slic import LazyRLERaster, download_labels_rle

    mp = labels.shape[0] * labels.shape[1] / 1e6
    with telemetry.stage(f"{stage}.download"):
        label_raster = LazyRLERaster(*download_labels_rle(labels))

    def polygonize():
        with telemetry.stage(f"{stage}.polygonize", mp, host_only=True):
            return _polygonize(label_raster, n_labels,
                               image.affine_transformation)

    if async_polygonize:
        ex = ThreadPoolExecutor(max_workers=1)
        geometry = ex.submit(polygonize)
        ex.shutdown(wait=False)
    else:
        geometry = polygonize()
    crs = CRS.from_user_input(image.crs) if image.crs is not None else None
    return SegmentLayer(n_labels, geometry, crs, image.transform,
                        image.affine_transformation, label_raster, labels,
                        shards=shards)
