"""Segmentation facade: ``segment()`` + ``Segments`` (port of
``obia_tpu/segmentation/segment.py``). ``Segments.to_segmented_image``
draws the label raster's boundaries on a PIL image (imports PIL)."""
from __future__ import annotations

import numpy as np

from ..handlers.geotif import as_image
from .segment_boundaries import SegmentLayer, create_segments
from .segment_statistics import ObjectTable, create_objects


def boundary_mask(labels: np.ndarray) -> np.ndarray:
    """True on pixels whose 4-neighbourhood crosses a label boundary."""
    labels = np.asarray(labels)
    b = np.zeros(labels.shape, bool)
    b[:, 1:] |= labels[:, 1:] != labels[:, :-1]
    b[:, :-1] |= labels[:, 1:] != labels[:, :-1]
    b[1:, :] |= labels[1:, :] != labels[:-1, :]
    b[:-1, :] |= labels[1:, :] != labels[:-1, :]
    return b


class Segments:
    """The polygon layer (``layer``), the per-object feature table
    (``table``), the method and the parameters used. ``segments`` and
    ``objects`` are the feature table as an
    :class:`obia_tpu_torch.vector.geodataframe.GeoDataFrame` (pandas is
    imported on first access); ``segments`` is the name the reference
    uses."""

    def __init__(self, layer: SegmentLayer, table: ObjectTable, method,
                 **kwargs):
        self.layer = layer
        self.table = table
        self.method = method
        self.params = dict(kwargs)
        self._gdf = None

    @property
    def objects(self):
        if self._gdf is None:
            self._gdf = self.table.to_geodataframe()
        return self._gdf

    segments = objects

    @property
    def label_raster(self) -> np.ndarray:
        """The 0-based dense label raster (segment_id - 1), on the host."""
        return np.asarray(self.layer.label_raster)

    def to_segmented_image(self, image):
        """The PIL image ``image`` with the segment boundaries drawn in
        yellow, like skimage's ``mark_boundaries`` defaults."""
        from PIL.Image import Image as PILImage
        from PIL.Image import fromarray
        if not isinstance(image, PILImage):
            raise TypeError("Input must be a PIL Image")
        out = np.array(image).astype(np.float32)
        if out.ndim == 2:
            out = np.stack([out] * 3, axis=-1)
        out[boundary_mask(self.label_raster)] = np.array([255.0, 255.0, 0.0])
        return fromarray(np.clip(out, 0, 255).astype(np.uint8))

    def write_segments(self, file_path: str) -> None:
        self.objects.to_file(file_path)


def segment(image, segmentation_bands=None, statistics_bands=None,
            method: str = "slic",
            calc_mean=True, calc_variance=True, calc_min=True, calc_max=True,
            calc_skewness=True, calc_kurtosis=True,
            calc_contrast=True, calc_dissimilarity=True,
            calc_homogeneity=True, calc_ASM=True, calc_energy=True,
            calc_correlation=True, device=None, **kwargs) -> Segments:
    """Segment + featurise in one call. ``device`` is where both run: the
    card when None (raises where there is none), the CPU only with
    ``device="cpu"``. The host polygonisation overlaps the
    featurisation."""
    image = as_image(image)
    layer = create_segments(image, segmentation_bands=segmentation_bands,
                            method=method, device=device,
                            _async_polygonize=True, **kwargs)
    table = create_objects(
        layer, image, spectral_bands=statistics_bands,
        calc_mean=calc_mean, calc_variance=calc_variance,
        calc_min=calc_min, calc_max=calc_max,
        calc_skewness=calc_skewness, calc_kurtosis=calc_kurtosis,
        calc_contrast=calc_contrast, calc_dissimilarity=calc_dissimilarity,
        calc_homogeneity=calc_homogeneity, calc_ASM=calc_ASM,
        calc_energy=calc_energy, calc_correlation=calc_correlation)
    return Segments(layer, table, method, **kwargs)
