"""Training-label join (the port's copy of ``label_segments`` from
``obia_tpu/utils/utils.py``).

``label_segments`` creates the ``feature_class`` column up front, so an
empty spatial join returns an empty frame instead of raising ``KeyError``.
It works on the port's pandas ``GeoDataFrame`` and imports pandas inside.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


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
