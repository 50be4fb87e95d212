"""Segmentation facade: ``segment()`` + ``Segments`` (port of
``obia_tpu/segmentation/segment.py``)."""
from __future__ import annotations

import numpy as np

from ..handlers.geotif import as_image
from .segment_boundaries import SegmentLayer, create_segments
from .segment_statistics import ObjectTable, create_objects


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
