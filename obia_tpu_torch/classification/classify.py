"""Object classification (port of ``obia_tpu/classification/classify.py``).

``classify`` splits the labelled objects into train and test rows, scales
the features, fits a random forest (``method="rf"``) or an MLP
(``method="mlp"``), optionally explains the fit with SHAP and reports on the
test rows, then predicts every object in one batched pass on the device, with
optional spatial class constraints and a top-2 ``prediction_margin``.

The split and the scaler are numpy copies of sklearn's ``train_test_split``
(without stratification, ``random_state=42``) and ``StandardScaler``, so the
MLP route runs where neither pandas nor sklearn is installed, on the port's
pandas-free :class:`ObjectTable`. pandas and sklearn stay at the API edge:
frames in and out, the forest fit (sklearn's), and ``compute_reports``.

Behaviour kept from the JAX package:
* one scaler is fitted on the training split and applied to the test and
  prediction rows (``strict_reference_scaling=True`` fits one per table);
* ``predicted_class`` keeps the label dtype (Int64 only for integer labels);
* the input table is not changed;
* all-NaN feature columns (the point-cloud slots) are dropped before fitting;
* SHAP: the forest is explained with the native TreeSHAP, the MLP with
  Kernel SHAP, whose model evaluations run on the device. A failed build of
  the native library raises; nothing falls back to Kernel SHAP.
"""
from __future__ import annotations

import math
import numbers
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..segmentation.segment_statistics import ObjectTable

_DROP_COLS = ("feature_class", "geometry", "segment_id")


# --- the split and the scaler (numpy copies of sklearn's) ----------------------

def train_test_split_indices(n: int, test_size=0.2, random_state: int = 42
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """(train, test) row indices as sklearn's ``train_test_split(...,
    test_size, random_state)`` without ``stratify`` picks them (its
    ``ShuffleSplit``): ``ceil(test_size * n)`` test rows for a fraction, or
    ``test_size`` rows for an int, from one ``RandomState`` permutation."""
    if isinstance(test_size, numbers.Integral):
        if not 0 < test_size < n:
            raise ValueError(f"test_size={test_size} should be positive and "
                             f"smaller than the number of samples {n}")
        n_test = int(test_size)
    else:
        if not 0.0 < test_size < 1.0:
            raise ValueError(f"test_size={test_size} should be a float in "
                             "the (0, 1) range or an int")
        n_test = math.ceil(test_size * n)
    n_train = n - n_test
    if n_train <= 0:
        raise ValueError(f"With n_samples={n}, test_size={test_size}, the "
                         "resulting train set will be empty")
    perm = np.random.RandomState(random_state).permutation(n)
    return perm[n_test:n_test + n_train], perm[:n_test]


class StandardScaler:
    """sklearn's ``StandardScaler().fit(X)`` in float64 numpy, with its
    arithmetic step for step (column sums over a column-major copy, the
    corrected two-pass variance, NaNs ignored, near-constant columns scaled
    by 1), so ``transform`` gives sklearn's values bit for bit."""

    def __init__(self, X: np.ndarray):
        X = np.asarray(X, np.float64, order="F")
        nan = np.isnan(X)
        sum_op = np.nansum if nan.any() else np.sum
        count = X.shape[0] - sum_op(nan.astype(np.float64), axis=0)
        total = sum_op(X, axis=0)
        self.mean_ = total / count
        temp = X - total / count
        correction = sum_op(temp, axis=0)
        temp **= 2
        var = sum_op(temp, axis=0)
        var -= correction ** 2 / count
        self.var_ = var / count
        n_seen = count[0] if count.max() == count.min() else count
        eps = np.finfo(np.float64).eps
        constant = self.var_ <= (n_seen * eps * self.var_
                                 + (n_seen * self.mean_ * eps) ** 2)
        self.scale_ = np.sqrt(self.var_)
        self.scale_[constant] = 1.0

    def transform(self, X: np.ndarray) -> np.ndarray:
        X = np.array(X, np.float64, order="F")
        X -= self.mean_
        X /= self.scale_
        return X


# --- tables: the port's ObjectTable, or a pandas frame at the edge -------------

def _column(table, name: str) -> np.ndarray:
    if isinstance(table, ObjectTable):
        return np.asarray(table[name])
    return table[name].to_numpy()


def _floats(table, name: str) -> np.ndarray:
    if isinstance(table, ObjectTable):
        return np.asarray(table[name], np.float64)
    return table[name].to_numpy(dtype=np.float64, na_value=np.nan)


def _matrix(table, names: List[str]) -> np.ndarray:
    """(rows, len(names)) float64, column-major."""
    out = np.empty((len(table), len(names)), np.float64, order="F")
    for j, c in enumerate(names):
        out[:, j] = _floats(table, c)
    return out


def _features(table) -> Tuple[List[str], np.ndarray]:
    """The feature columns of ``table`` (without ``feature_class``,
    ``geometry``, ``segment_id`` and all-NaN columns) and their float64
    values."""
    names = [c for c in table.columns if c not in _DROP_COLS
             and not np.isnan(_floats(table, c)).all()]
    return names, _matrix(table, names)


def _factorize(values) -> np.ndarray:
    """Codes 0..U-1 in order of first appearance (``pd.factorize``'s
    order; ``np.unique`` would sort them)."""
    _, first, inverse = np.unique(np.asarray(values), return_index=True,
                                  return_inverse=True)
    rank = np.empty(len(first), np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(len(first))
    return rank[inverse.reshape(-1)]


def _coerce_dtypes(out, integer_labels: bool):
    """Integer columns become Int64, floats float; string labels stay."""
    import pandas as pd
    for col in out.columns:
        if col != "geometry":
            if pd.api.types.is_integer_dtype(out[col].dtype):
                out[col] = out[col].astype(pd.Int64Dtype())
            elif pd.api.types.is_float_dtype(out[col].dtype):
                out[col] = out[col].astype(float)
    if integer_labels:
        out["predicted_class"] = out["predicted_class"].astype(
            pd.Int64Dtype())
    return out


def _classified_frame(table: ObjectTable):
    """The GeoDataFrame of a classified table: its columns, the geometry,
    then ``predicted_class`` and ``prediction_margin``."""
    from ..vector.geodataframe import GeoDataFrame
    added = ("predicted_class", "prediction_margin")
    out = GeoDataFrame({c: v for c, v in table.columns.items()
                        if c not in added}, geometry=table.geometry,
                       crs=table.crs)
    for c in added:
        out[c] = table.columns[c]
    return _coerce_dtypes(out, np.issubdtype(
        table.columns["predicted_class"].dtype, np.integer))


class ClassifiedImage:
    """The classified objects and the fit's quality artefacts.

    ``table`` is the input table with ``predicted_class`` and
    ``prediction_margin`` added: an :class:`ObjectTable` when the input was
    one (``classified`` builds its GeoDataFrame on first access, importing
    pandas), else the classified frame. ``classifier`` is the fitted model,
    ``proba`` the (objects, classes) probabilities of the batched predict
    before any class mask, and ``shap_inputs`` the scaled rows SHAP explained
    and its background, or None."""

    def __init__(self, table, confusion_matrix, report, shap_values,
                 transform, crs, params, label_raster=None, classifier=None,
                 proba=None, shap_inputs=None):
        self.table = table
        self.confusion_matrix = confusion_matrix
        self.report = report
        self.shap_values = shap_values
        self.transform = transform
        self.crs = crs
        self.params = params
        self.classifier = classifier
        self.proba = proba
        self.shap_inputs = shap_inputs
        self._label_raster = label_raster
        self._frame = None if isinstance(table, ObjectTable) else table

    @property
    def classified(self):
        if self._frame is None:
            self._frame = _classified_frame(self.table)
        return self._frame

    def write_geotiff(self, output_path: str) -> None:
        """Render ``predicted_class`` per object onto the label raster (codes
        1.. in order of first appearance, 0 for background and for segments
        not in the table) and write an int32 GeoTIFF with nodata 0."""
        if self._label_raster is None or self.transform is None:
            raise ValueError(
                "No label raster / transform available; classify() must "
                "receive the Segments or ObjectTable of this package's "
                "segment()/create_objects() to enable raster export.")
        from ..io.tiff import write_tiff
        # only an ObjectTable input carries a label raster
        sids = np.asarray(self.table["segment_id"], np.int64)
        codes = _factorize(self.table["predicted_class"])
        lab = np.asarray(self._label_raster)
        # the LUT spans every raster label, so segments not in the table
        # (rows filtered before classify) render as background 0
        lut = np.zeros(max(int(sids.max()), int(lab.max()) + 1) + 1,
                       np.int32)
        lut[sids] = codes + 1
        out = np.where(lab >= 0, lut[lab + 1], 0)
        write_tiff(output_path, out.astype(np.int32),
                   transform=self.transform, crs=self.crs, nodata=0)


def _allowed(geometry, acceptable_classes_gdf, classes: np.ndarray,
             shape) -> np.ndarray:
    """(objects, classes) mask: an object whose geometry meets a row of
    ``acceptable_classes_gdf`` may take only that row's
    ``acceptable_classes`` (the first row it meets; no mask when none of
    them was trained)."""
    allowed = np.ones(shape, dtype=bool)
    if acceptable_classes_gdf is None:
        return allowed
    class_pos: Dict = {c: i for i, c in enumerate(classes)}
    for pos, geom in enumerate(geometry):
        hits = acceptable_classes_gdf[acceptable_classes_gdf.intersects(geom)]
        if len(hits) == 0:
            continue
        row = np.zeros(len(classes), bool)
        for c in hits.iloc[0]["acceptable_classes"]:
            if c in class_pos:
                row[class_pos[c]] = True
        if row.any():
            allowed[pos] = row
    return allowed


def classify(segments, training_classes, acceptable_classes_gdf=None,
             method: str = "rf", test_size: float = 0.2,
             compute_reports: bool = False, compute_shap: bool = False,
             sample_shap: bool = False,
             strict_reference_scaling: bool = False, device=None,
             **kwargs) -> ClassifiedImage:
    """Train on labelled objects and predict every object in one batched
    pass on ``device`` (the card when None, which raises where there is
    none; ``"cpu"`` asks for the CPU).

    ``segments``: the :class:`Segments` of ``segment()``, an
    :class:`ObjectTable`, or a pandas (Geo)DataFrame of the same columns.
    ``training_classes``: an ``ObjectTable`` or frame of labelled objects
    with a ``feature_class`` column. ``method="rf"`` fits sklearn's
    ``RandomForestClassifier(**kwargs)`` on the host (it raises
    ``ImportError`` where sklearn is not installed) and predicts on the
    device; ``method="mlp"`` fits and predicts ``TorchMLPClassifier(
    **kwargs)`` on the device. ``compute_shap`` explains the scaled training
    rows: TreeSHAP for the forest, Kernel SHAP for the MLP (against at most
    500 background rows with ``sample_shap``). ``compute_reports`` imports
    sklearn for the confusion matrix and report of the test rows.
    """
    from .. import telemetry
    from ..segmentation.segment import Segments
    from .forest import TorchForestClassifier
    from .mlp import TorchMLPClassifier

    dev = resolve_device(device)
    if isinstance(segments, Segments):
        segments = segments.table

    feature_cols, x = _features(training_classes)
    y = np.asarray(_column(training_classes, "feature_class"))
    train, test = train_test_split_indices(len(x), test_size, 42)
    x_train, x_test = x[train], x[test]
    y_train, y_test = y[train], y[test]

    scaler = StandardScaler(x_train)
    x_train_s = scaler.transform(x_train)
    x_test_s = (StandardScaler(x_test) if strict_reference_scaling
                else scaler).transform(x_test)

    if method == "rf":
        classifier = TorchForestClassifier(device=dev, **kwargs)
    elif method == "mlp":
        classifier = TorchMLPClassifier(device=dev, **kwargs)
    else:
        raise ValueError("An unsupported classification algorithm was requested")

    with telemetry.stage("classify.fit"):
        classifier.fit(x_train_s, y_train)

    shap_values = shap_inputs = None
    if compute_shap:
        with telemetry.stage("classify.shap"):
            if method == "rf":
                from .. import native
                shap_values = native.tree_shap_forest(
                    classifier.sklearn_model, x_train_s)
                shap_inputs = (x_train_s, None)
            else:
                from .kernel_shap import kernel_shap
                if sample_shap and len(x_train_s) > 500:
                    sel = np.random.default_rng(42).choice(
                        len(x_train_s), 500, replace=False)
                    bg = x_train_s[sel]
                else:
                    bg = x_train_s
                # the MLP reads float32: casting the rows first gives the
                # same synthetic rows as casting each one
                shap_values = kernel_shap(
                    classifier.proba_tensor, torch.as_tensor(
                        x_train_s, dtype=torch.float32, device=dev), bg)
                shap_inputs = (x_train_s, bg)

    report = cm = None
    if compute_reports:
        from sklearn.metrics import classification_report, confusion_matrix
        y_pred = classifier.predict(x_test_s)
        cm = confusion_matrix(y_test, y_pred)
        report = classification_report(y_test, y_pred)

    # ---- batched prediction over every object -------------------------------
    present = set(segments.columns) - set(_DROP_COLS)
    missing = [c for c in feature_cols if c not in present]
    if missing:
        # NaN <= t is always False in the tree traversal: a missing column
        # would make every prediction confidently wrong instead of failing
        raise ValueError(
            f"segments table is missing training feature columns "
            f"{missing}; recompute objects with the same statistics the "
            "training table was built with")
    x_pred = _matrix(segments, feature_cols)
    x_pred_s = (StandardScaler(x_pred) if strict_reference_scaling
                else scaler).transform(x_pred)

    with telemetry.stage("classify.predict"):
        proba = classifier.predict_proba(x_pred_s)      # (objects, C)
    classes = np.asarray(classifier.classes_)

    geometry = (segments.geometry if acceptable_classes_gdf is not None
                else None)
    allowed = _allowed(geometry, acceptable_classes_gdf, classes,
                       proba.shape)
    masked = np.where(allowed, proba, -np.inf)
    y_pred_all = classes[masked.argmax(axis=1)]
    # top-2 margin within the allowed set; single-class training has no
    # runner-up, so the margin is the top probability
    if proba.shape[1] < 2:
        prediction_margin = proba[:, 0]
    else:
        part = np.sort(masked, axis=1)[:, -2:]
        second = np.where(np.isfinite(part[:, 0]), part[:, 0], 0.0)
        prediction_margin = part[:, 1] - second
    prediction_margin = prediction_margin.astype(float)

    if isinstance(segments, ObjectTable):
        out = segments.with_columns(predicted_class=y_pred_all,
                                    prediction_margin=prediction_margin)
        crs = segments.crs
        transform = segments.layer.transform
        label_raster = segments.layer.label_raster
    else:
        out = segments.copy()  # the input frame is not changed
        out["predicted_class"] = y_pred_all
        out["prediction_margin"] = prediction_margin
        out = _coerce_dtypes(out, np.issubdtype(y_pred_all.dtype,
                                                np.integer))
        crs = getattr(segments, "crs", None)
        transform = label_raster = None
    return ClassifiedImage(out, cm, report, shap_values, transform, crs,
                           classifier.get_params(), label_raster=label_raster,
                           classifier=classifier, proba=proba,
                           shap_inputs=shap_inputs)
