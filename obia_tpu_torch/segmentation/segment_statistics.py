"""Per-object feature table (port of ``create_objects`` in
``obia_tpu/segmentation/segment_statistics.py``).

The spectral family (mean, variance, min, max, skewness, kurtosis) and the
textural family (GLCM contrast, dissimilarity, homogeneity, ASM, energy,
correlation) are reduced over the device-resident label raster of a
:class:`SegmentLayer`. The columns keep the reference's ``b{band}_{stat}``
names and order, and the point-cloud slots stay as NaN columns. The result
is a pandas-free :class:`ObjectTable` of numpy columns plus the geometries.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .. import telemetry
from ..handlers.geotif import as_image
from .segment_boundaries import SegmentLayer

# schema constants of obia_tpu.segmentation.segment_statistics (copied: that
# module imports jax)
SPECTRAL_STATS = ("mean", "variance", "min", "max", "skewness", "kurtosis")
TEXTURAL_STATS = ("contrast", "dissimilarity", "homogeneity", "ASM",
                  "energy", "correlation")
POINTCLOUD_STATS = ("pai", "fhd", "ch", "mean_intensity",
                    "variance_intensity")


def _create_empty_stats_columns(spectral_bands, textural_bands,
                                spectral_flags, textural_flags,
                                pc_flags) -> List[str]:
    """Column list with the reference's naming and ordering."""
    columns = ["segment_id"]
    for b in spectral_bands:
        columns += [f"b{b}_{s}" for s, on in spectral_flags.items() if on]
    for b in textural_bands:
        columns += [f"b{b}_{s}" for s, on in textural_flags.items() if on]
    columns += [s for s, on in pc_flags.items() if on]
    columns.append("geometry")
    return columns


class ObjectTable:
    """Columnar feature table: ``columns`` maps each column except
    ``geometry`` to a numpy array of one value per object, in schema order;
    ``geometry`` joins the segment layer's polygonisation on first read.
    ``rows`` (None: every segment, in order) are the layer rows of the
    table's objects, as :meth:`take` leaves them."""

    def __init__(self, columns: Dict[str, np.ndarray], layer: SegmentLayer,
                 rows: Optional[np.ndarray] = None):
        self.columns = columns
        self.layer = layer
        self.rows = rows

    def __len__(self) -> int:
        return len(self.layer) if self.rows is None else len(self.rows)

    def __getitem__(self, name: str):
        return self.geometry if name == "geometry" else self.columns[name]

    @property
    def geometry(self) -> List:
        g = self.layer.geometry
        return g if self.rows is None else [g[i] for i in self.rows]

    @property
    def crs(self):
        return self.layer.crs

    def take(self, positions) -> "ObjectTable":
        """The objects at ``positions`` (integer positions, or a boolean
        mask), in that order."""
        pos = np.arange(len(self))[np.asarray(positions)]
        rows = pos if self.rows is None else self.rows[pos]
        return ObjectTable({c: v[pos] for c, v in self.columns.items()},
                           self.layer, rows)

    def with_columns(self, **columns) -> "ObjectTable":
        """A table with ``columns`` (one value per object each) added after
        the others, or replacing a column of the same name."""
        for name, v in columns.items():
            if len(v) != len(self):
                raise ValueError(f"column {name!r} has {len(v)} values for "
                                 f"{len(self)} objects")
        return ObjectTable({**self.columns, **{
            c: np.asarray(v) for c, v in columns.items()}}, self.layer,
            self.rows)

    def to_geodataframe(self):
        """:class:`obia_tpu_torch.vector.geodataframe.GeoDataFrame` of
        every column (imports pandas)."""
        from ..vector.geodataframe import GeoDataFrame
        return GeoDataFrame(dict(self.columns), geometry=self.geometry,
                            crs=self.crs)


def create_objects(segments: SegmentLayer, image, spectral_bands=None,
                   textural_bands=None, calculate_spectral=True,
                   calculate_textural=True,
                   calc_mean=True, calc_variance=True, calc_min=True,
                   calc_max=True, calc_skewness=True, calc_kurtosis=True,
                   calc_contrast=True, calc_dissimilarity=True,
                   calc_homogeneity=True, calc_ASM=True, calc_energy=True,
                   calc_correlation=True,
                   calc_pai=True, calc_fhd=True, calc_ch=True,
                   calc_mean_intensity=True, calc_variance_intensity=True,
                   glcm_levels: int = 256, glcm_distance: int = 2,
                   glcm_angles=None) -> ObjectTable:
    """Per-object features of ``segments`` over ``image``, on the device
    that holds ``segments.labels_dev``. Spectral stats run whenever
    ``spectral_bands`` is non-empty (the reference ignores
    ``calculate_spectral``); columns of a family that is off stay NaN.

    A layer from the mosaic (``segments.shards`` set) takes both families
    from the sharded reductions over its mesh (the JAX package's ``_exec``
    hook); any other layer from the single-device programs."""
    from ..ops.glcm import DEFAULT_ANGLES, segment_glcm_props_packed
    from ..ops.stats import spectral_moments_packed
    from ..parallel.glcm_sharded import sharded_glcm_props
    from ..parallel.mesh import shard_raster
    from ..parallel.sharded import sharded_spectral_moments

    if not (calculate_spectral or calculate_textural):
        raise ValueError("At least one of 'calculate_spectral' or "
                         "'calculate_textural' must be True.")
    if not isinstance(segments, SegmentLayer):
        raise TypeError("create_objects takes the SegmentLayer of "
                        "create_segments")
    image = as_image(image)
    num_bands = image.img_data.shape[2]
    if spectral_bands is None:
        spectral_bands = list(range(num_bands))
    if textural_bands is None:
        textural_bands = list(range(num_bands))
    spectral_flags = dict(zip(SPECTRAL_STATS, (
        calc_mean, calc_variance, calc_min, calc_max, calc_skewness,
        calc_kurtosis)))
    textural_flags = dict(zip(TEXTURAL_STATS, (
        calc_contrast, calc_dissimilarity, calc_homogeneity, calc_ASM,
        calc_energy, calc_correlation)))
    pc_flags = dict(zip(POINTCLOUD_STATS, (
        calc_pai, calc_fhd, calc_ch, calc_mean_intensity,
        calc_variance_intensity)))
    columns = _create_empty_stats_columns(spectral_bands, textural_bands,
                                          spectral_flags, textural_flags,
                                          pc_flags)
    K = len(segments)
    labels = segments.labels_dev
    img = image.device_tensor(labels.device)
    H, W = labels.shape
    mp = H * W / 1e6
    data = {"segment_id": segments.segment_id}
    shards = segments.shards
    if shards is not None:
        mesh = shards.mesh
        img_sh = shard_raster(mesh, img)[0]

        def spectral():
            return sharded_spectral_moments(mesh, img_sh, shards, K,
                                            packed=True)

        def glcm(**kw):
            return sharded_glcm_props(mesh, img_sh, shards, K, packed=True,
                                      **kw)
    else:
        def spectral():
            return spectral_moments_packed(img, labels, K)

        def glcm(**kw):
            return segment_glcm_props_packed(img, labels, K, **kw)

    if spectral_bands:
        with telemetry.stage("objects.spectral", mp):
            names, packed = spectral()
        sp = dict(zip(names, packed))
        for stat, on in spectral_flags.items():
            if on:
                for b in spectral_bands:
                    data[f"b{b}_{stat}"] = sp[stat][:, b].astype(float)

    if calculate_textural and textural_bands:
        with telemetry.stage("objects.glcm", mp):
            names, packed = glcm(
                levels=int(glcm_levels),
                distance=int(glcm_distance),
                angles=(tuple(glcm_angles) if glcm_angles is not None
                        else DEFAULT_ANGLES),
                compute_asm=calc_ASM or calc_energy,
                bands=tuple(textural_bands))
        props = dict(zip(names, packed))
        for stat, on in textural_flags.items():
            if on:
                for j, b in enumerate(textural_bands):
                    data[f"b{b}_{stat}"] = props[stat][:, j].astype(float)

    return ObjectTable({c: data.get(c, np.full(K, np.nan))
                        for c in columns if c != "geometry"}, segments)
