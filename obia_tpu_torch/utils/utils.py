"""Training-label join, window and mask helpers, and the detection
prediction export (the port's copy of ``obia_tpu/utils/utils.py``).

``label_segments`` creates the ``feature_class`` column up front, so an
empty spatial join returns an empty frame instead of raising ``KeyError``.
It works on the port's pandas ``GeoDataFrame`` and imports pandas inside;
``save_deepforest_predictions_to_gpkg`` takes a pandas frame of boxes.
``crop_image_to_bbox`` reads from the in-memory array (no live file
handle is needed).
"""
from __future__ import annotations

import json
from typing import List, Tuple

import numpy as np

from ..geometry.affine import Affine
from ..geometry.geom import Polygon
from ..geometry.rasterize import geometry_mask
from ..vector.features import write_features


def label_segments(segments, labelled_points) -> Tuple[object, List]:
    """Join labelled points (a ``GeoDataFrame`` with a ``class`` column)
    onto segments (a ``GeoDataFrame`` with ``segment_id``): a segment whose
    points agree on one class gets that ``feature_class``; mixed-class
    segments are left out and their ids returned. Returns
    ``(labelled_segments, mixed_segment_ids)``."""
    import pandas as pd

    from ..vector.geodataframe import sjoin
    mixed_segments = []
    labelled = segments.copy()
    if "feature_class" not in labelled.columns:
        # dtype=object, not float64: strict pandas setitem refuses to put
        # a string class into a NaN-initialised float column
        labelled["feature_class"] = pd.Series(np.nan, index=labelled.index,
                                              dtype=object)
    inter = sjoin(labelled, labelled_points, how="inner",
                  predicate="intersects")
    if len(inter):
        for polygon_id, group in inter.groupby(inter.index):
            classes = group["class"].unique()
            if len(classes) == 1:
                labelled.loc[polygon_id, "feature_class"] = classes[0]
            else:
                mixed_segments.append(group["segment_id"].values[0])
    labelled = labelled[labelled["feature_class"].notna()]
    # restore the natural dtype (int/float classes back from object) so
    # sklearn's label checks see a proper multiclass target
    labelled["feature_class"] = labelled["feature_class"].infer_objects()
    return labelled, mixed_segments


def crop_image_to_bbox(image, geom):
    """Crop the in-memory raster to a geometry's bounding box: band-first
    (C, h, w) data and the cropped transform."""
    xmin, ymin, xmax, ymax = geom.bounds
    inv = ~image.transform
    c0f, r0f = inv * (xmin, ymax)
    c1f, r1f = inv * (xmax, ymin)
    r0, r1 = sorted((r0f, r1f))
    c0, c1 = sorted((c0f, c1f))
    H, W, _ = image.img_data.shape
    r0i = max(0, int(np.floor(r0 + 1e-9)))
    c0i = max(0, int(np.floor(c0 + 1e-9)))
    r1i = min(H, int(np.ceil(r1 - 1e-9)))
    c1i = min(W, int(np.ceil(c1 - 1e-9)))
    crop = image.img_data[r0i:r1i, c0i:c1i]
    cropped = np.transpose(crop, (2, 0, 1))  # (C, h, w) band-first
    cropped_transform = image.transform * Affine.translation(c0i, r0i)
    return cropped, cropped_transform


def mask_image_with_polygon(cropped_img_data, polygon, cropped_transform):
    """NaN outside the polygon; input and output band-first (C, h, w)."""
    C, h, w = cropped_img_data.shape
    inside = geometry_mask([polygon], (h, w), transform=cropped_transform,
                           invert=True)
    return np.where(inside[None, :, :], cropped_img_data, np.nan)


def save_deepforest_predictions_to_gpkg(df, tile_name, transforms_json,
                                        output_gpkg):
    """Pixel boxes (a frame with ``xmin``, ``ymin``, ``xmax``, ``ymax`` and
    optional ``label``, ``score``) → georeferenced polygons in a GPKG,
    through the tile's affine stored in transforms.json."""
    with open(transforms_json, "r") as f:
        transforms_dict = json.load(f)
    if tile_name not in transforms_dict:
        print(f"Tile '{tile_name}' not found in transforms.json. Skipping.")
        return
    tinfo = transforms_dict[tile_name]
    tile_affine = Affine(*tinfo["transform"])
    labels, scores, geoms = [], [], []
    for _, row in df.iterrows():
        corners_px = [(row["xmin"], row["ymin"]), (row["xmax"], row["ymin"]),
                      (row["xmax"], row["ymax"]), (row["xmin"], row["ymax"])]
        world = [tile_affine * p for p in corners_px]
        geoms.append(Polygon(world + [world[0]]))
        labels.append(row.get("label", "Tree"))
        scores.append(row.get("score", None))
    if not geoms:
        print(f"No predictions to save for tile {tile_name}")
        return
    write_features(output_gpkg, [("label", labels), ("score", scores)],
                   geoms, tinfo["crs"], driver="GPKG")
