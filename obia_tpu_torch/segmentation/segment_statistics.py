"""Per-object feature table (port of ``create_objects`` in
``obia_tpu/segmentation/segment_statistics.py``).

The spectral family (mean, variance, min, max, skewness, kurtosis) and the
textural family (GLCM contrast, dissimilarity, homogeneity, ASM, energy,
correlation) are reduced over a device-resident label raster; the
structural (PAI, FHD, CH) and radiometric (intensity mean and variance)
families over a point cloud assigned to the objects through the same
raster (:mod:`obia_tpu_torch.ops.pointcloud`). The columns keep the
reference's ``b{band}_{stat}`` names and order. The result is a
pandas-free :class:`ObjectTable` of numpy columns plus the geometries.

``create_objects`` takes any polygon table: the :class:`SegmentLayer` of
``create_segments``, an :class:`ObjectTable` (filtered or reordered), a
:class:`obia_tpu_torch.vector.features.Features` or a pandas
``GeoDataFrame``. It uses the label raster attached to the input while the
rows still map onto it positionally; otherwise it rasterises row i to
label i over the image's grid, as the JAX package's ``_label_raster_for``
does.
"""
from __future__ import annotations

import os
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import telemetry
from ..device import resolve_device
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
    ``geometry`` to a numpy array of one value per object, in schema order.

    The objects are rows of a source that holds one geometry per raster
    label: a :class:`SegmentLayer` (``layer``), or, without one, the
    table's own ``geometry``, ``crs``, ``transform`` and label raster
    (host ``label_raster``, device ``labels_dev``), as ``create_objects``
    leaves a table it rasterised. ``rows`` (None: every source row, in
    order) are the source rows of the table's objects, as :meth:`take`
    leaves them; source row k holds raster label k."""

    def __init__(self, columns: Dict[str, np.ndarray],
                 layer: Optional[SegmentLayer] = None,
                 rows: Optional[np.ndarray] = None, *, geometry=None,
                 crs=None, transform=None, label_raster=None,
                 labels_dev: Optional[torch.Tensor] = None):
        self.columns = columns
        self.layer = layer
        self.rows = rows
        self._own = dict(geometry=geometry, crs=crs, transform=transform,
                         label_raster=label_raster, labels_dev=labels_dev)

    def _source(self, name: str):
        return (getattr(self.layer, name) if self.layer is not None
                else self._own[name])

    def _n_source(self) -> int:
        return (len(self.layer) if self.layer is not None
                else len(self._own["geometry"]))

    def __len__(self) -> int:
        return self._n_source() if self.rows is None else len(self.rows)

    def __getitem__(self, name: str):
        return self.geometry if name == "geometry" else self.columns[name]

    @property
    def geometry(self) -> List:
        g = self._source("geometry")
        return g if self.rows is None else [g[i] for i in self.rows]

    @property
    def crs(self):
        return self._source("crs")

    @property
    def transform(self):
        return self._source("transform")

    @property
    def label_raster(self):
        """The source's label raster on the host (label k is source row k),
        or None."""
        return self._source("label_raster")

    @property
    def labels_dev(self) -> Optional[torch.Tensor]:
        return self._source("labels_dev")

    @property
    def label_rows(self) -> np.ndarray:
        """The raster label of each object."""
        return (np.arange(self._n_source()) if self.rows is None
                else np.asarray(self.rows))

    def _with(self, columns, rows) -> "ObjectTable":
        return ObjectTable(columns, self.layer, rows, **self._own)

    def take(self, positions) -> "ObjectTable":
        """The objects at ``positions`` (integer positions, or a boolean
        mask), in that order."""
        pos = np.arange(len(self))[np.asarray(positions)]
        rows = pos if self.rows is None else self.rows[pos]
        return self._with({c: v[pos] for c, v in self.columns.items()}, rows)

    def with_columns(self, **columns) -> "ObjectTable":
        """A table with ``columns`` (one value per object each) added after
        the others, or replacing a column of the same name."""
        for name, v in columns.items():
            if len(v) != len(self):
                raise ValueError(f"column {name!r} has {len(v)} values for "
                                 f"{len(self)} objects")
        return self._with({**self.columns, **{
            c: np.asarray(v) for c, v in columns.items()}}, self.rows)

    def to_geodataframe(self):
        """:class:`obia_tpu_torch.vector.geodataframe.GeoDataFrame` of
        every column (imports pandas)."""
        from ..vector.geodataframe import GeoDataFrame
        return GeoDataFrame(dict(self.columns), geometry=self.geometry,
                            crs=self.crs)


# --- single-object helpers ---------------------------------------------------

def calculate_spectral_stats(image, statistics_bands,
                             calc_mean=True, calc_variance=True,
                             calc_min=True, calc_max=True,
                             calc_skewness=True, calc_kurtosis=True):
    """One object's spectral stats: ``image`` is a band-first (C, H, W)
    array with NaN outside the object (numpy and scipy on the host)."""
    arr = np.asarray(image, np.float32)
    flags = dict(zip(SPECTRAL_STATS, (calc_mean, calc_variance, calc_min,
                                      calc_max, calc_skewness,
                                      calc_kurtosis)))
    stats = {}
    for b in statistics_bands:
        band = arr[b]
        vals = band[~np.isnan(band)]
        if vals.size == 0:
            values = dict.fromkeys(SPECTRAL_STATS, np.nan)
        else:
            from scipy import stats as sps
            values = {"mean": np.mean(vals), "variance": np.var(vals),
                      "min": np.min(vals), "max": np.max(vals),
                      "skewness": sps.skew(vals),
                      "kurtosis": sps.kurtosis(vals)}
        for stat, on in flags.items():
            if on:
                stats[f"b{b}_{stat}"] = values[stat]
    return stats


def calculate_textural_stats(image, textural_bands,
                             calc_contrast=True, calc_dissimilarity=True,
                             calc_homogeneity=True, calc_ASM=True,
                             calc_energy=True, calc_correlation=True,
                             device=None):
    """One object's GLCM stats: ``image`` is band-first (C, H, W) with NaN
    outside the object. Each band goes through ``segment_glcm_props_packed``
    (the ``glcm_sums`` kernel) on ``device``: the card when None, which
    raises where there is none; ``"cpu"`` asks for the CPU."""
    from ..ops.glcm import segment_glcm_props_packed

    arr = np.asarray(image, np.float32)
    dev = resolve_device(device)
    flags = dict(zip(TEXTURAL_STATS, (calc_contrast, calc_dissimilarity,
                                      calc_homogeneity, calc_ASM,
                                      calc_energy, calc_correlation)))
    stats = {}
    for b in textural_bands:
        band = arr[b]
        valid = ~np.isnan(band)
        if not valid.any():
            props = dict.fromkeys(TEXTURAL_STATS, np.nan)
        else:
            labels = torch.as_tensor(np.where(valid, 0, -1).astype(np.int32))
            clean = torch.as_tensor(np.where(valid, band, 0.0).astype(
                np.float32))[:, :, None]
            names, packed = segment_glcm_props_packed(
                clean.to(dev), labels.to(dev), 1,
                compute_asm=calc_ASM or calc_energy)
            props = {n: float(packed[i, 0, 0]) for i, n in enumerate(names)}
        for stat, on in flags.items():
            if on:
                stats[f"b{b}_{stat}"] = props[stat]
    return stats


def _strict_reference_textural_stats(masked_chw, textural_bands, flags):
    """Bug-compatible texture of one object (the ``strict_reference_glcm``
    hatch), the reference's recipe step for step: ``image[:, :, band]`` on
    the band-first (C, Hc, Wc) masked crop (a (C, Hc) slab at column
    ``band``), background zeros, the slab's own min-max uint8 truncation
    and the crop's GLCM over those zeros. Only for reconciling outputs with
    the reference's GeoPackages."""
    from ..ops.glcm import graycomatrix_reference, graycoprops_reference

    arr = np.asarray(masked_chw, np.float64)
    stats = {}
    for b in textural_bands:
        values = None
        # a bbox narrower than the band index: the reference raises
        # IndexError; NaN keeps the run going
        if arr.shape[2] > b:
            band_data = arr[:, :, b]  # the reference's wrong-axis slice
            valid = ~np.isnan(band_data)
            if valid.any():
                band_clean = band_data.copy()
                band_clean[~valid] = 0
                mn, mx = band_clean.min(), band_clean.max()
                if mx == mn:
                    q = np.zeros(band_clean.shape, np.uint8)
                else:
                    q = ((band_clean - mn) / (mx - mn) * 255).astype(
                        np.uint8)
                glcm = graycomatrix_reference(q, distance=2, levels=256)
                values = {s: float(np.mean(graycoprops_reference(glcm, s)))
                          for s, on in flags.items() if on}
        for stat, on in flags.items():
            if on:
                stats[f"b{b}_{stat}"] = (np.nan if values is None
                                         else values[stat])
    return stats


def _strict_reference_columns(img_np: np.ndarray, lab_np: np.ndarray,
                              label_rows: np.ndarray, textural_bands,
                              flags) -> Dict[str, np.ndarray]:
    """The hatch's columns: each object's bbox crop, NaN outside it, through
    :func:`_strict_reference_textural_stats` (a host loop)."""
    cols = {f"b{b}_{s}": np.full(len(label_rows), np.nan)
            for b in textural_bands for s in TEXTURAL_STATS}
    for row, lab_id in enumerate(label_rows):
        m = lab_np == lab_id
        rows_any = m.any(axis=1)
        if not rows_any.any():
            continue
        r0, r1 = np.flatnonzero(rows_any)[[0, -1]]
        c0, c1 = np.flatnonzero(m.any(axis=0))[[0, -1]]
        crop = img_np[r0:r1 + 1, c0:c1 + 1, :]
        masked = np.where(m[r0:r1 + 1, c0:c1 + 1][None, :, :],
                          np.moveaxis(crop, 2, 0), np.nan)
        for name, val in _strict_reference_textural_stats(
                masked, textural_bands, flags).items():
            cols[name][row] = val
    return cols


def calculate_structural_stats(pointcloud, voxel_resolution,
                               calc_pai=True, calc_fhd=True, calc_ch=True):
    """One object's point-cloud structure (numpy on the host): CH = max Z,
    FHD = Shannon entropy of the returns in ``voxel_resolution`` layers,
    PAI = ``ln(N_total / N_ground)``, ground being the lowest layer."""
    from ..ops.pointcloud import _field
    z = _field(pointcloud, "Z")
    if z is None:
        raise ValueError("point cloud must provide a 'Z' field")
    z = np.asarray(z, np.float64)
    if z.size == 0:
        return {n: np.nan for n, on in (("pai", calc_pai), ("fhd", calc_fhd),
                                        ("ch", calc_ch)) if on}
    if (calc_pai or calc_fhd) and voxel_resolution is None:
        raise ValueError("voxel_resolution is required for PAI/FHD")
    stats = {}
    if calc_ch:
        stats["ch"] = float(z.max())
    if calc_pai or calc_fhd:
        layer = np.clip(np.floor((z - z.min()) / float(voxel_resolution)),
                        0, None).astype(np.int64)
        if calc_pai:
            stats["pai"] = float(np.log(z.size / int((layer == 0).sum())))
        if calc_fhd:
            p = np.bincount(layer).astype(np.float64) / z.size
            with np.errstate(divide="ignore", invalid="ignore"):
                stats["fhd"] = float(
                    -np.where(p > 0, p * np.log(p), 0.0).sum())
    return stats


def calculate_radiometric_stats(pointcloud, calc_mean_intensity=True,
                                calc_variance_intensity=True):
    """One object's intensity mean and variance; NaN without intensities."""
    from ..ops.pointcloud import _field
    intensities = _field(pointcloud, "Intensity")
    empty = intensities is None or np.size(intensities) == 0
    stats = {}
    if calc_mean_intensity:
        stats["mean_intensity"] = (np.nan if empty
                                   else float(np.mean(intensities)))
    if calc_variance_intensity:
        stats["variance_intensity"] = (np.nan if empty
                                       else float(np.var(intensities)))
    return stats


# --- the table's label raster ------------------------------------------------

def _polygon_table(segments):
    """(segment_id, geometries, crs) of a polygon table that carries no
    label raster: a ``Features`` or a pandas ``GeoDataFrame``."""
    from ..vector.features import Features
    if isinstance(segments, Features):
        n = len(segments)
        sid = segments.columns.get("segment_id")
        return (np.arange(1, n + 1) if sid is None else np.asarray(sid),
                segments.geometry, segments.crs)
    if hasattr(segments, "geometry") and hasattr(segments, "columns"):
        sid = (segments["segment_id"].to_numpy()
               if "segment_id" in segments.columns
               else np.arange(1, len(segments) + 1))
        return sid, list(segments.geometry), getattr(segments, "crs", None)
    raise TypeError(
        "create_objects takes a SegmentLayer, an ObjectTable, a Features "
        f"table or a GeoDataFrame, not {type(segments).__name__}")


def _attached(table: ObjectTable, sid: np.ndarray) -> bool:
    """True while ``table``'s rows still map positionally onto its source's
    label raster: every source row, in order, with the source's ids."""
    n = table._n_source()
    return (table.labels_dev is not None and len(table) == n
            and np.array_equal(table.label_rows, np.arange(n))
            and np.array_equal(sid, np.arange(1, n + 1)))


def _device_for(device, tensor: Optional[torch.Tensor]) -> torch.device:
    """Where the features run: the input's label tensor's device when it
    has one (``device``, when given, must name the same), else
    ``resolve_device(device)``."""
    if tensor is None:
        return resolve_device(device)
    if device is not None:
        want = torch.device(device)
        if want.type != tensor.device.type or (
                want.index is not None and want.index != tensor.device.index):
            raise ValueError(f"device={device!r}, but the input's labels "
                             f"live on {tensor.device}")
    return tensor.device


def _read_pointcloud(path, image):
    """``read_las(path)``, warning when its CRS is not the image's."""
    from ..geometry.crs import CRS
    from ..io.las import read_las
    pc = read_las(path)
    pc_epsg = pc.crs.to_epsg() if pc.crs else None
    img_crs = CRS.from_user_input(image.crs) if image.crs is not None \
        else None
    img_epsg = img_crs.to_epsg() if img_crs is not None else None
    if pc_epsg and img_epsg and pc_epsg != img_epsg:
        warnings.warn(
            f"point cloud CRS EPSG:{pc_epsg} != image CRS EPSG:{img_epsg}; "
            "points are joined to the label raster in image coordinates, "
            "so the structural/radiometric statistics will be wrong — "
            "reproject the cloud first", stacklevel=3)
    return pc


def create_objects(segments, image, ept=None, ept_srs=None,
                   spectral_bands=None, textural_bands=None,
                   voxel_resolution=None,
                   calculate_spectral=True, calculate_textural=True,
                   calculate_structural=False, calculate_radiometric=False,
                   calc_mean=True, calc_variance=True, calc_min=True,
                   calc_max=True, calc_skewness=True, calc_kurtosis=True,
                   calc_contrast=True, calc_dissimilarity=True,
                   calc_homogeneity=True, calc_ASM=True, calc_energy=True,
                   calc_correlation=True,
                   calc_pai=True, calc_fhd=True, calc_ch=True,
                   calc_mean_intensity=True, calc_variance_intensity=True,
                   glcm_levels: int = 256, glcm_distance: int = 2,
                   glcm_angles=None, pointcloud=None,
                   strict_reference_glcm: bool = False,
                   device=None) -> ObjectTable:
    """Per-object features of the polygon table ``segments`` over
    ``image``. Spectral stats run whenever ``spectral_bands`` is non-empty
    (the reference ignores ``calculate_spectral``); columns of a family
    that is off stay NaN.

    ``segments``: a :class:`SegmentLayer`, an :class:`ObjectTable`, a
    ``Features`` table or a pandas ``GeoDataFrame``. The attached label
    raster is used while the rows map onto it (every row, in order, with
    the source's ``segment_id`` 1..N); otherwise row i is rasterised to
    label i over the image's grid (pixel centres) and uploaded once.
    ``device``: where a table without a label tensor runs, the card when
    None (raising where there is none), the CPU only with ``"cpu"``; an
    input with a label tensor runs on that tensor's device. A mosaic layer
    (``shards`` set) whose rows still match reduces over its mesh;
    otherwise the single-device reductions run.

    ``pointcloud``: a structured array or dict with ``X``, ``Y``, ``Z``
    (and ``Intensity``) in the image's CRS, or the path of a ``.las`` file
    (:func:`obia_tpu_torch.io.las.read_las`); with
    ``calculate_structural``/``calculate_radiometric`` it fills PAI, FHD,
    CH and the intensity moments (``voxel_resolution``: the layer height
    of PAI and FHD). ``ept``/``ept_srs`` raise ``NotImplementedError``, as
    the reference does. ``strict_reference_glcm``: the reference's
    bug-compatible texture, a host loop over the objects."""
    from ..ops.glcm import DEFAULT_ANGLES, segment_glcm_props_packed
    from ..ops.stats import spectral_moments_packed

    image = as_image(image)
    if isinstance(pointcloud, (str, os.PathLike)):
        pointcloud = _read_pointcloud(pointcloud, image)
    if not (calculate_spectral or calculate_textural or calculate_structural
            or calculate_radiometric):
        raise ValueError(
            "At least one of 'calculate_spectral', 'calculate_textural', "
            "'calculate_structural', or 'calculate_radiometric' must be "
            "True.")
    if ept is not None or ((calculate_structural or calculate_radiometric)
                           and pointcloud is None):
        raise NotImplementedError(
            "Point-cloud workflows are temporarily disabled. "
            "Use spectral/textural statistics only for now.")
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
    H, W = image.img_data.shape[:2]
    mp = H * W / 1e6

    if isinstance(segments, SegmentLayer):
        segments = ObjectTable({}, segments)
    if isinstance(segments, ObjectTable):
        sid = (np.asarray(segments.columns["segment_id"])
               if "segment_id" in segments.columns
               else np.arange(1, len(segments) + 1))
        dev = _device_for(device, segments.labels_dev)
        attached = _attached(segments, sid)
    else:
        sid, geoms, crs = _polygon_table(segments)
        dev, attached = resolve_device(device), False

    if attached:
        source, labels = segments, segments.labels_dev
        shards = (segments.layer.shards if segments.layer is not None
                  else None)
    else:
        # rasterise row i -> label i; a mosaic layer's mesh blocks are stale
        # then, and the single-device reductions run on this raster
        from ..geometry.rasterize import rasterize
        if isinstance(segments, ObjectTable):
            geoms, crs = segments.geometry, segments.crs
        with telemetry.stage("objects.rasterize", mp):
            lab = rasterize([(g, i) for i, g in enumerate(geoms)], (H, W),
                            transform=image.transform, fill=-1,
                            dtype=np.int32)
            labels = torch.from_numpy(lab).to(dev)
        source = ObjectTable({}, None, geometry=list(geoms), crs=crs,
                             transform=image.transform, label_raster=lab,
                             labels_dev=labels)
        shards = None
    K = len(sid)
    img = image.device_tensor(labels.device)
    data = {"segment_id": sid}

    if shards is not None:
        from ..parallel.glcm_sharded import sharded_glcm_props
        from ..parallel.mesh import shard_raster
        from ..parallel.sharded import sharded_spectral_moments
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

    if calculate_textural and textural_bands and strict_reference_glcm:
        with telemetry.stage("objects.glcm_strict", mp):
            props = _strict_reference_columns(
                np.asarray(image.img_data, np.float32),
                np.asarray(source.label_raster), source.label_rows,
                textural_bands, textural_flags)
        for stat, on in textural_flags.items():
            if on:
                for b in textural_bands:
                    data[f"b{b}_{stat}"] = props[f"b{b}_{stat}"]
    elif calculate_textural and textural_bands:
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

    if pointcloud is not None and (calculate_structural
                                   or calculate_radiometric):
        from ..ops.pointcloud import segment_pointcloud_stats
        with telemetry.stage("objects.pointcloud"):
            data.update(segment_pointcloud_stats(
                pointcloud, labels, image.transform, K,
                voxel_resolution=voxel_resolution,
                calc_pai=calculate_structural and calc_pai,
                calc_fhd=calculate_structural and calc_fhd,
                calc_ch=calculate_structural and calc_ch,
                calc_mean_intensity=(calculate_radiometric
                                     and calc_mean_intensity),
                calc_variance_intensity=(calculate_radiometric
                                         and calc_variance_intensity)))

    return source._with({c: data.get(c, np.full(K, np.nan))
                         for c in columns if c != "geometry"}, None)
