"""The sharded multi-tile mosaic (port of ``obia_tpu/parallel/mosaic.py``,
``bench.py`` config 5).

The raster is split over a logical mesh (:mod:`.mesh`), and every device
stage runs shard by shard: SLIC with replicated centres, connectivity and
the small-segment merge with the equivalences across seams taken from
one-pixel boundary strips, and the spectral and GLCM features reduced over
the mesh. Seams never exist during clustering, since every pixel sees the
same global centres. The label raster is gathered once, for the download
that feeds the native polygoniser. :func:`seam_overhead` measures how far
the sharded boundaries sit from a single-device run's.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import telemetry
from ..handlers.geotif import as_image
from ..ops.slic import _grid_shape
from .mesh import Mesh, shard_raster
from .sharded import (sharded_ccl_merge, sharded_merge_small,
                      sharded_slic_assign)


def _edge_extend(img: torch.Tensor, Hp: int, Wp: int) -> torch.Tensor:
    """(H, W, C) -> (Hp, Wp, C) by repeating the last row and column."""
    H, W = img.shape[:2]
    if Hp > H:
        img = torch.cat([img, img[H - 1:H].expand(Hp - H, -1, -1)], dim=0)
    if Wp > W:
        img = torch.cat([img, img[:, W - 1:W].expand(-1, Wp - W, -1)], dim=1)
    return img


def _one_process(mesh: Mesh) -> None:
    """The mosaic gathers whole rasters into one process, as the JAX
    package's gathers them to one host, so its mesh must not span ranks."""
    if mesh.spans_ranks:
        raise ValueError("the mosaic gathers whole rasters into one "
                         "process: it does not run on a mesh that spans "
                         "ranks")


def segment_mosaic_device(image_data, n_segments: int = 1000,
                          compactness: float = 10.0, max_num_iter: int = 10,
                          *, mesh: Mesh, min_size_factor: float = 0.5,
                          max_size_factor: float = 3.0):
    """Segment an (H, W, C) raster (normalised bands recommended; numpy or
    a tensor) over ``mesh``, keeping the labels in their blocks end to end.
    The mesh alone places the shards; a tensor on an accelerator given a
    mesh on the CPU raises rather than leave the card.

    Returns (mesh, int32 dense labels 0..K-1 / -1 on pads per block, K,
    (H, W))."""
    _one_process(mesh)
    img = torch.as_tensor(image_data)
    if img.device.type != "cpu" and mesh.home.type == "cpu":
        raise ValueError(f"the image is on {img.device} and the mesh on the "
                         f"CPU: build the mesh on the image's device, e.g. "
                         f"make_mesh(8, [{str(img.device)!r}])")
    img = img.to(mesh.home).to(torch.float32)
    H, W, _ = img.shape
    Hp = -(-H // mesh.ty) * mesh.ty
    Wp = -(-W // mesh.tx) * mesh.tx
    # edge-extended pads join the clustering; CCL marks them -1
    img_sh, _ = shard_raster(mesh, _edge_extend(img, Hp, Wp))
    mp = H * W / 1e6
    with telemetry.stage("mosaic.slic", mp):
        labels, _ = sharded_slic_assign(mesh, img_sh, n_segments,
                                        compactness=compactness,
                                        max_num_iter=max_num_iter)
    with telemetry.stage("mosaic.ccl", mp):
        lab, K = sharded_ccl_merge(mesh, labels, (H, W),
                                   n_segments=n_segments)
    with telemetry.stage("mosaic.merge", mp):
        gh, gw = _grid_shape(Hp, Wp, n_segments)
        seg_size = Hp * Wp / (gh * gw)
        min_size = max(1, int(min_size_factor * seg_size))
        max_size = max(min_size + 1, int(max_size_factor * seg_size))
        lab, K = sharded_merge_small(mesh, lab, K, min_size, max_size)
    return mesh, lab, K, (H, W)


def segment_mosaic(image_data, n_segments: int = 1000,
                   compactness: float = 10.0, max_num_iter: int = 10,
                   *, mesh: Mesh, min_size_factor: float = 0.5,
                   max_size_factor: float = 3.0) -> Tuple[np.ndarray, int]:
    """Host-array form of :func:`segment_mosaic_device`: ((H, W) int32
    labels 0..K-1, K)."""
    _, lab, K, (H, W) = segment_mosaic_device(
        image_data, n_segments=n_segments, compactness=compactness,
        max_num_iter=max_num_iter, mesh=mesh,
        min_size_factor=min_size_factor, max_size_factor=max_size_factor)
    return lab.gather()[:H, :W].cpu().numpy(), K


def mosaic_pipeline(image, n_segments: int = 1000, compactness: float = 10.0,
                    *, mesh: Mesh, output_gpkg: Optional[str] = None,
                    training_classes=None,
                    classify_kwargs: Optional[dict] = None,
                    objects_kwargs: Optional[dict] = None, **mosaic_kwargs):
    """Config 5: the bands normalised on the mesh's home device, sharded
    segmentation, the sharded spectral and GLCM features of the original
    bands, optionally classification and a GeoPackage. Returns the
    ``ObjectTable`` of ``segmentation/segment_statistics.py`` over a
    ``SegmentLayer`` whose ``shards`` keep the labels in their mesh blocks;
    with ``training_classes``, the table that
    ``classification.classify.classify(objects, training_classes,
    **classify_kwargs)`` returns (``predicted_class`` and
    ``prediction_margin`` added), classified on the mesh's home device
    unless ``classify_kwargs`` names a ``device``.

    ``image``: an ``Image`` of this package or of ``obia_tpu``; ``mesh``
    places the shards (``make_mesh(8, ["cuda:0"])`` on one card).
    ``output_gpkg`` writes the table's GeoDataFrame, which imports pandas.
    """
    from ..segmentation.segment_boundaries import (_normalize_select,
                                                   layer_from_labels)
    from ..segmentation.segment_statistics import create_objects

    _one_process(mesh)
    image = as_image(image)
    H, W, C = image.shape
    with telemetry.stage("mosaic.normalize", H * W / 1e6):
        norm = _normalize_select(image.device_tensor(mesh.home),
                                 list(range(C)))
    mesh, lab_sh, n_labels, (H, W) = segment_mosaic_device(
        norm, n_segments=n_segments, compactness=compactness, mesh=mesh,
        **mosaic_kwargs)
    labels = lab_sh.gather()[:H, :W].contiguous()
    layer = layer_from_labels(labels, n_labels, image, "mosaic",
                              async_polygonize=True, shards=lab_sh)
    objects = create_objects(layer, image, **(objects_kwargs or {}))
    if training_classes is not None:
        from ..classification.classify import classify
        result = classify(objects, training_classes,
                          **{"device": mesh.home, **(classify_kwargs or {})})
        objects = result.table
        if output_gpkg:
            result.classified.to_file(output_gpkg, layer="segments")
    elif output_gpkg:
        objects.to_geodataframe().to_file(output_gpkg, layer="segments")
    return objects


def boundary_map(labels: np.ndarray) -> np.ndarray:
    b = np.zeros(labels.shape, bool)
    b[:, 1:] |= labels[:, 1:] != labels[:, :-1]
    b[1:, :] |= labels[1:, :] != labels[:-1, :]
    return b


def seam_overhead(labels_sharded: np.ndarray, labels_single: np.ndarray,
                  tolerance_px: int = 1) -> float:
    """Seam-merge overhead %: the share of the sharded run's boundary pixels
    with no single-device boundary within ``tolerance_px`` (0: the
    boundaries agree)."""
    b_sh = boundary_map(np.asarray(labels_sharded))
    b_si = boundary_map(np.asarray(labels_single))
    if tolerance_px > 0:
        t = int(tolerance_px)
        dil = F.max_pool2d(torch.as_tensor(b_si, dtype=torch.float32)[None],
                           2 * t + 1, stride=1, padding=t)[0].numpy() > 0
    else:
        dil = b_si
    n_b = b_sh.sum()
    if n_b == 0:
        return 0.0
    return 100.0 * float((b_sh & ~dil).sum()) / float(n_b)
