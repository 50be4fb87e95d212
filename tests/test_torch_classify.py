"""obia_tpu_torch's ``classify`` and ``label_segments`` against the JAX
package's, on the CPU.

Bars: the split's indices and the scaler's values bitwise sklearn's; the
forest route (sklearn fits the same forest on both sides) with
``predicted_class``, the confusion matrix, the report, the TreeSHAP values,
the column names and dtypes and the CRS equal to JAX's, and
``prediction_margin`` within atol 1e-6 (the port averages the trees'
float32 leaf distributions in another order: 6e-8 measured); the MLP route,
with JAX's fitted Flax parameters carried across by ``mlp_from_flax``, with
equal predictions, margins within 1e-6 and Kernel SHAP values within 1e-5
of JAX's (measured: 9e-8 and 7e-8); the port's own MLP fit at JAX's
accuracy bar; ``label_segments`` equal to JAX's; ``write_geotiff`` bytes
equal to JAX's ``write_tiff`` of the reference render, with first-appearance
class codes; the quickstart flow, and ``mosaic_pipeline(training_classes=)``
equal to ``classify`` of the same table.
"""
import numpy as np
import pandas as pd
import pytest

from obia_tpu.classification import classify as jcm
from obia_tpu.classification.mlp import FlaxMLPClassifier
from obia_tpu.geometry import Affine as JAffine
from obia_tpu.geometry import Point as JPoint
from obia_tpu.geometry import box as jbox
from obia_tpu.io.tiff import write_tiff as jax_write_tiff
from obia_tpu.utils.utils import label_segments as jax_label_segments
from obia_tpu.vector import GeoDataFrame as JaxFrame
from obia_tpu_torch.classification import classify as tcm
from obia_tpu_torch.classification.mlp import TorchMLPClassifier, mlp_from_flax
from obia_tpu_torch.geometry import Affine, Point, box
from obia_tpu_torch.geometry.crs import CRS
from obia_tpu_torch.handlers.geotif import image_from_array
from obia_tpu_torch.io.tiff import TiffReader
from obia_tpu_torch.segmentation.segment import segment
from obia_tpu_torch.segmentation.segment_boundaries import SegmentLayer
from obia_tpu_torch.segmentation.segment_statistics import ObjectTable
from obia_tpu_torch.utils.utils import label_segments
from obia_tpu_torch.vector.geodataframe import GeoDataFrame


def _columns(n, seed=42):
    """A feature table shaped like create_objects' output (the JAX tests'
    ``_toy_objects``) and its two classes."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(n, 4))
    classes = np.where(feats[:, 0] > 0, 1, 2)
    cols = {"segment_id": np.arange(1, n + 1), "b0_mean": feats[:, 0],
            "b0_variance": np.abs(feats[:, 1]), "b1_mean": feats[:, 2],
            "b1_variance": np.abs(feats[:, 3]),
            "pai": np.full(n, np.nan)}  # all-NaN column must be tolerated
    return cols, classes


def _tables(n, n_train, labels, kind, seed=42):
    """(JAX segments frame, JAX training frame, port segments, port
    training) of the same values; ``kind`` "table" gives the port
    ObjectTables, "frame" the port's GeoDataFrames."""
    cols, classes = _columns(n, seed)
    labels = classes if labels is None else labels(classes)
    jseg = JaxFrame(dict(cols), geometry=[jbox(i, 0, i + 1, 1)
                                          for i in range(n)],
                    crs="EPSG:32633")
    jtrain = jseg.iloc[:n_train].copy()
    jtrain["feature_class"] = labels[:n_train]
    layer = SegmentLayer(n, [box(i, 0, i + 1, 1) for i in range(n)],
                         CRS.from_user_input("EPSG:32633"), None, None, None,
                         None)
    seg = ObjectTable(dict(cols), layer)
    train = seg.take(np.arange(n_train)).with_columns(
        feature_class=labels[:n_train])
    if kind == "frame":
        seg = seg.to_geodataframe()
        train = train.to_geodataframe()
    return jseg, jtrain, seg, train


# --- the split and the scaler ------------------------------------------------

@pytest.mark.parametrize("n", [5, 17, 48, 80, 333])
@pytest.mark.parametrize("test_size", [0.2, 0.25, 0.3, 3])
def test_split_is_sklearns(n, test_size):
    from sklearn.model_selection import train_test_split
    want_train, want_test = train_test_split(np.arange(n),
                                             test_size=test_size,
                                             random_state=42)
    train, test = tcm.train_test_split_indices(n, test_size, 42)
    np.testing.assert_array_equal(train, want_train)
    np.testing.assert_array_equal(test, want_test)


def test_split_rejects_an_empty_side():
    with pytest.raises(ValueError):
        tcm.train_test_split_indices(1, 0.2)
    with pytest.raises(ValueError):
        tcm.train_test_split_indices(10, 1.5)


def _scaler_table(case):
    rng = np.random.default_rng(7)
    X = rng.normal(size=(333, 6)) * 10.0 ** rng.integers(-3, 5, 6)
    X[:, 1] += 1e4
    if case == "constant":
        X[:, 2] = 3.25
    if case == "nan":
        X[rng.random(333) < 0.1, 3] = np.nan
    return X


@pytest.mark.parametrize("case", ["plain", "constant", "nan"])
def test_scaler_is_sklearns(case):
    """As JAX calls it: fitted on the training rows of a frame, applied to
    another frame."""
    from sklearn.preprocessing import StandardScaler
    X = _scaler_table(case)
    frame = pd.DataFrame(X, columns=[f"c{i}" for i in range(6)])
    train, test = tcm.train_test_split_indices(len(X), 0.2, 42)
    skl = StandardScaler().fit(frame.iloc[train])
    mine = tcm.StandardScaler(X[train])
    np.testing.assert_array_equal(mine.mean_, skl.mean_)
    np.testing.assert_array_equal(mine.var_, skl.var_)
    np.testing.assert_array_equal(mine.scale_, skl.scale_)
    np.testing.assert_array_equal(mine.transform(X[test]),
                                  skl.transform(frame.iloc[test]))


# --- classify: the forest route against JAX ------------------------------------

def _assert_classified_equal(got, want, margin_atol=1e-6):
    g, w = got.classified, want.classified
    assert list(g.columns) == list(w.columns)
    assert list(g.dtypes) == list(w.dtypes)
    np.testing.assert_array_equal(g["predicted_class"].to_numpy(),
                                  w["predicted_class"].to_numpy())
    np.testing.assert_allclose(g["prediction_margin"].to_numpy(),
                               w["prediction_margin"].to_numpy(), rtol=0,
                               atol=margin_atol)
    for c in w.columns:
        if c not in ("geometry", "predicted_class", "prediction_margin"):
            pd.testing.assert_series_equal(g[c], w[c], check_index=False)
    assert got.crs.to_epsg() == want.crs.to_epsg() == 32633


RF_CASES = {
    "reports_and_shap": dict(n=120, n_train=80, kw=dict(
        compute_reports=True, compute_shap=True, n_estimators=30,
        random_state=0)),
    "strict_scaling": dict(n=80, n_train=60, kw=dict(
        strict_reference_scaling=True, compute_reports=True,
        n_estimators=10, random_state=0, max_depth=5)),
    "single_class": dict(n=30, n_train=10, labels=lambda c: np.full(
        len(c), "only"), kw=dict(n_estimators=10, random_state=0)),
    "string_labels": dict(n=60, n_train=40, labels=lambda c: np.where(
        c == 1, "water", "land"), kw=dict(compute_reports=True,
                                         n_estimators=10, random_state=0)),
}


@pytest.mark.parametrize("kind", ["table", "frame"])
@pytest.mark.parametrize("case", sorted(RF_CASES))
def test_classify_rf_matches_jax(case, kind):
    spec = RF_CASES[case]
    jseg, jtrain, seg, train = _tables(spec["n"], spec["n_train"],
                                       spec.get("labels"), kind)
    want = jcm.classify(jseg, jtrain, method="rf", **spec["kw"])
    got = tcm.classify(seg, train, method="rf", device="cpu", **spec["kw"])
    _assert_classified_equal(got, want)
    assert got.report == want.report
    np.testing.assert_array_equal(got.confusion_matrix,
                                  want.confusion_matrix)
    assert (got.shap_values is None) == (want.shap_values is None)
    if want.shap_values is not None:
        assert got.shap_values.shape == (64, 4, 2)  # 80 * 0.8 rows
        np.testing.assert_array_equal(got.shap_values, want.shap_values)
    assert got.params == want.params
    if case == "single_class":
        np.testing.assert_allclose(got.classified["prediction_margin"], 1.0)


@pytest.mark.parametrize("kind", ["table", "frame"])
def test_classify_acceptable_classes_matches_jax(kind):
    jseg, jtrain, seg, train = _tables(40, 30, None, kind)
    jacc = JaxFrame({"acceptable_classes": [[2], [1, 7]]},
                    geometry=[jbox(0, 0, 10, 1), jbox(20.5, 0.2, 24, 0.8)])
    acc = GeoDataFrame({"acceptable_classes": [[2], [1, 7]]},
                       geometry=[box(0, 0, 10, 1), box(20.5, 0.2, 24, 0.8)])
    kw = dict(method="rf", n_estimators=10, random_state=0)
    want = jcm.classify(jseg, jtrain, acceptable_classes_gdf=jacc, **kw)
    got = tcm.classify(seg, train, acceptable_classes_gdf=acc, device="cpu",
                       **kw)
    _assert_classified_equal(got, want)
    preds = got.classified["predicted_class"].to_numpy()
    assert (preds[:10] == 2).all() and (preds[20:24] == 1).all()


@pytest.mark.parametrize("kind", ["table", "frame"])
def test_classify_does_not_change_its_input(kind):
    _, _, seg, train = _tables(40, 30, None, kind)
    before = {c: np.array(seg[c], copy=True) for c in seg.columns
              if c != "geometry"}
    out = tcm.classify(seg, train, method="rf", n_estimators=5,
                       random_state=0, device="cpu")
    assert "predicted_class" not in seg.columns
    assert "predicted_class" in out.classified.columns
    for c, v in before.items():
        np.testing.assert_array_equal(np.asarray(seg[c]), v)


def test_classify_bad_method():
    _, _, seg, train = _tables(30, 20, None, "table")
    with pytest.raises(ValueError):
        tcm.classify(seg, train, method="svm", device="cpu")


def test_classify_missing_feature_column_raises():
    _, _, seg, train = _tables(40, 30, None, "table")
    short = ObjectTable({c: v for c, v in seg.columns.items()
                         if c != "b1_mean"}, seg.layer)
    with pytest.raises(ValueError, match="missing training feature"):
        tcm.classify(short, train, method="rf", device="cpu")


def test_object_table_take_and_with_columns():
    _, _, seg, _ = _tables(12, 12, None, "table")
    sub = seg.take(np.array([5, 2, 9]))
    np.testing.assert_array_equal(sub["segment_id"], [6, 3, 10])
    assert [g.bounds[0] for g in sub.geometry] == [5.0, 2.0, 9.0]
    again = sub.take(np.array([False, True, True]))
    np.testing.assert_array_equal(again["segment_id"], [3, 10])
    assert [g.bounds[0] for g in again.geometry] == [2.0, 9.0]
    extra = again.with_columns(feature_class=np.array(["a", "b"]))
    assert list(extra.columns)[-1] == "feature_class"
    assert "feature_class" not in again.columns
    with pytest.raises(ValueError):
        again.with_columns(x=np.zeros(3))
    frame = extra.to_geodataframe()
    assert list(frame["segment_id"]) == [3, 10]


# --- classify: the MLP route against JAX ---------------------------------------

@pytest.mark.parametrize("kind", ["table", "frame"])
def test_classify_mlp_carried_matches_jax(kind, monkeypatch):
    """JAX's fit is recorded, and the port's fit replaced by its weights
    (``mlp_from_flax``): the same model on both sides, so predictions,
    margins and Kernel SHAP values compare."""
    jseg, jtrain, seg, train = _tables(60, 40, None, kind)
    fitted = {}
    jax_fit = FlaxMLPClassifier.fit

    def record(self, X, y):
        fitted["clf"] = self
        return jax_fit(self, X, y)

    monkeypatch.setattr(FlaxMLPClassifier, "fit", record)
    kw = dict(method="mlp", compute_shap=True, sample_shap=True,
              hidden_layer_sizes=(8,), max_iter=30)
    want = jcm.classify(jseg, jtrain, **kw)
    jc = fitted["clf"]

    def carry(self, X, y):
        c = mlp_from_flax(jc._params, jc.classes_, jc.hidden, jc.activation,
                          device=self.device)
        self._model, self.classes_ = c._model, c.classes_
        return self

    monkeypatch.setattr(TorchMLPClassifier, "fit", carry)
    got = tcm.classify(seg, train, device="cpu", **kw)
    _assert_classified_equal(got, want)
    assert got.shap_values.shape == want.shap_values.shape == (32, 4, 2)
    np.testing.assert_allclose(got.shap_values, want.shap_values, rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got.shap_values.sum(axis=(1, 2)), 0.0,
                               atol=1e-6)
    assert got.params == want.params


def test_classify_mlp():
    """The reference's case: string labels survive the port's own fit."""
    _, _, seg, train = _tables(120, 80, lambda c: c.astype(str), "table")
    out = tcm.classify(seg, train, method="mlp", hidden_layer_sizes=(16,),
                       max_iter=60, device="cpu")
    assert out.classified["predicted_class"].iloc[0] in ("1", "2")
    assert set(out.table["predicted_class"]) <= {"1", "2"}
    np.testing.assert_allclose(out.proba.sum(axis=1), 1.0, atol=1e-6)


def test_classify_mlp_learns(rng):
    """The reference's accuracy case for its MLP (``test_flax_mlp_learns``:
    the same table and bar), through ``classify`` with string labels."""
    X = rng.normal(size=(400, 4)).astype(np.float32)
    y = np.where(X[:, 0] + X[:, 1] > 0, "a", "b")
    layer = SegmentLayer(400, [box(i, 0, i + 1, 1) for i in range(400)],
                         None, None, None, None, None)
    seg = ObjectTable({"segment_id": np.arange(1, 401),
                       **{f"b{i}_mean": X[:, i] for i in range(4)}}, layer)
    train = seg.take(np.arange(300)).with_columns(feature_class=y[:300])
    out = tcm.classify(seg, train, method="mlp", hidden_layer_sizes=(32,),
                       max_iter=100, random_state=0, device="cpu")
    pred = np.asarray(out.table["predicted_class"])
    assert (pred[300:] == y[300:]).mean() > 0.9


def test_classify_accepts_segments_and_keeps_the_tree_shap(small_rgb):
    """A ``Segments`` facade is classified through its table; TreeSHAP
    through ``classify`` is the native function on the fitted forest."""
    from obia_tpu_torch import native
    image = image_from_array(small_rgb, Affine(1, 0, 100, 0, -1, 500),
                             crs="EPSG:32633")
    s = segment(image, method="slic", n_segments=30, device="cpu")
    idx = np.arange(0, len(s.table), 2)
    train = s.table.take(idx).with_columns(
        feature_class=np.where(s.table["b0_mean"][idx] > 0.4, 1, 2))
    out = tcm.classify(s, train, method="rf", compute_shap=True,
                       n_estimators=10, random_state=0, device="cpu")
    assert len(out.table) == len(s.table)
    rows = out.shap_inputs[0]
    np.testing.assert_array_equal(out.shap_values, native.tree_shap_forest(
        out.classifier.sklearn_model, rows))


# --- label_segments ------------------------------------------------------------

LABEL_CASES = {
    "unanimous_and_mixed": (
        {"segment_id": [1, 2, 3]}, [(0, 0, 2, 2), (2, 0, 4, 2), (4, 0, 6, 2)],
        {"class": [5, 5, 5, 7]}, [(1, 1), (1.5, 1.5), (3, 1), (3.5, 0.5)]),
    "string_classes": (
        {"segment_id": [1, 2]}, [(0, 0, 2, 2), (2, 0, 4, 2)],
        {"class": ["water", "water", "land"]}, [(1, 1), (3, 1), (3.5, 0.5)]),
    "empty_join": (
        {"segment_id": [1]}, [(0, 0, 1, 1)], {"class": [5]}, [(99, 99)]),
}


@pytest.mark.parametrize("case", sorted(LABEL_CASES))
def test_label_segments_matches_jax(case):
    seg_cols, boxes, pt_cols, pts = LABEL_CASES[case]
    want, want_mixed = jax_label_segments(
        JaxFrame(dict(seg_cols), geometry=[jbox(*b) for b in boxes]),
        JaxFrame(dict(pt_cols), geometry=[JPoint(*p) for p in pts]))
    got, mixed = label_segments(
        GeoDataFrame(dict(seg_cols), geometry=[box(*b) for b in boxes]),
        GeoDataFrame(dict(pt_cols), geometry=[Point(*p) for p in pts]))
    assert mixed == want_mixed
    assert list(got.columns) == list(want.columns)
    assert list(got.index) == list(want.index)
    for c in ("segment_id", "feature_class"):
        assert list(got[c]) == list(want[c])
        assert got[c].dtype == want[c].dtype


# --- the classified GeoTIFF ----------------------------------------------------

@pytest.fixture(scope="module")
def scene_segments():
    rng = np.random.default_rng(42)
    h, w = 96, 128
    base = np.zeros((h, w, 3), np.float32)
    base[:h // 2, :, 0] = 0.8
    base[h // 2:, :, 1] = 0.6
    base[:, w // 2:, 2] = 0.9
    scene = np.clip(base + rng.normal(0, 0.03, (h, w, 3)), 0, 1)
    image = image_from_array(scene.astype(np.float32),
                             Affine(1.0, 0, 100.0, 0, -1.0, 500.0),
                             crs="EPSG:32633")
    return segment(image, method="slic", n_segments=30, device="cpu")


def _reference_render(preds, sids, lab):
    """classify.py's render with pandas' first-appearance codes."""
    codes, _ = pd.factorize(pd.Series(preds))
    lut = np.zeros(max(int(sids.max()), int(lab.max()) + 1) + 1, np.int32)
    lut[sids] = codes + 1
    return np.where(lab >= 0, lut[lab + 1], 0).astype(np.int32)


@pytest.mark.parametrize("labels", ["int", "str"])
def test_write_geotiff_bytes_match_jax(scene_segments, tmp_path, labels):
    """Half of the objects kept (the dropped ones render as background 0),
    labels whose first appearance is not their sorted order."""
    s = scene_segments
    kept = s.table.take(np.arange(len(s.table) // 2))
    cls = np.where(np.arange(len(kept)) % 3 == 0, 2, 1)
    if labels == "str":
        cls = np.where(cls == 2, "water", "land")
    train = kept.with_columns(feature_class=cls)
    out = tcm.classify(kept, train, method="rf", n_estimators=10,
                       random_state=0, device="cpu")
    path = tmp_path / "port.tif"
    out.write_geotiff(str(path))
    lab = s.label_raster
    sids = np.asarray(kept["segment_id"])
    preds = np.asarray(out.table["predicted_class"])
    render = _reference_render(preds, sids, lab)
    ref = tmp_path / "jax.tif"
    jax_write_tiff(str(ref), render, transform=JAffine(*s.layer.transform[:6]),
                   crs="EPSG:32633", nodata=0)
    assert path.read_bytes() == ref.read_bytes()
    arr = TiffReader(str(path)).read()[:, :, 0]
    dropped = ~np.isin(lab + 1, sids)
    assert (arr[(lab >= 0) & dropped] == 0).all()
    assert (arr[np.isin(lab + 1, sids)] > 0).all()
    # the first object's class is code 1, whatever its sorted rank
    assert (arr[lab == sids[0] - 1] == 1).all()


def test_write_geotiff_without_a_layer_raises(tmp_path):
    _, _, seg, train = _tables(30, 20, None, "frame")
    out = tcm.classify(seg, train, method="rf", n_estimators=5,
                       random_state=0, device="cpu")
    with pytest.raises(ValueError, match="label raster"):
        out.write_geotiff(str(tmp_path / "x.tif"))


# --- the flows -----------------------------------------------------------------

def test_quickstart_flow(scene_segments, tmp_path):
    """The reference README's flow on the port: segment -> label ->
    classify -> GeoPackage + classified GeoTIFF, read back."""
    from obia_tpu.vector import read_file
    s = scene_segments
    objs = s.segments
    pts_geoms, pt_classes = [], []
    for i in range(0, len(objs), 3):
        pts_geoms.append(objs.geometry.iloc[i].centroid)
        pt_classes.append(1 if objs["b0_mean"].iloc[i] > 0.4 else 2)
    pts = GeoDataFrame({"class": pt_classes}, geometry=pts_geoms)
    training, mixed = label_segments(objs, pts)
    assert len(training) > 5 and mixed == []
    out = tcm.classify(s, training, method="rf", n_estimators=20,
                       random_state=0, test_size=0.3, device="cpu")
    df = out.classified
    assert df["predicted_class"].notna().all()
    assert df["predicted_class"].dtype.name == "Int64"
    gpkg = str(tmp_path / "classified.gpkg")
    df.to_file(gpkg)
    back = read_file(gpkg)
    assert list(back["predicted_class"]) == list(df["predicted_class"])
    tif = str(tmp_path / "classified.tif")
    out.write_geotiff(tif)
    r = TiffReader(tif)
    assert r.read().shape[:2] == s.label_raster.shape
    assert r.crs.to_epsg() == 32633
