"""The ``obia_torch`` namespace: the reference's import paths over
obia_tpu_torch, held against the ``obia`` namespace over the JAX package.

Bars: ``tests/test_alias_package.py``'s flow runs verbatim through
``obia_torch`` on the CPU (``device="cpu"``); its GeoPackage has the
``obia`` flow's columns in the same order, its classes are the ``obia``
flow's, and its labels split the pixels as JAX's do (as
``test_torch_slic.py`` holds SLIC); every ``obia`` module has an
``obia_torch`` counterpart that offers each public name of the JAX
module behind it, except the names left out on purpose (listed below, each
with the port's counterpart); each re-export is the ``obia_tpu_torch``
object itself, underscore names included.
"""
import importlib
import inspect
import pkgutil
import sqlite3

import numpy as np
import pytest

from obia_tpu.geometry.affine import Affine
from obia_tpu.io.tiff import write_tiff

# Public names of obia_tpu modules behind ``obia`` that the port leaves out
# on purpose, each with what the port has instead.
LEFT_OUT = {
    # the geometry-future plumbing of the JAX frames: the port's
    # SegmentLayer and ObjectTable carry the raster, transform and polygons
    "LABEL_RASTER_ATTR": "SegmentLayer.label_raster",
    "LABEL_DEV_ATTR": "SegmentLayer.labels_dev",
    "LABEL_IDS_ATTR": "SegmentLayer.segment_id",
    "TRANSFORM_ATTR": "SegmentLayer.transform",
    "GEOM_FUTURE_ATTR": "SegmentLayer.geometry (joins the thread)",
    "SharedArray": "SegmentLayer",
    "unwrap_attr": "SegmentLayer attributes",
    "resolve_geometry": "SegmentLayer.geometry",
    "segment_label_raster": "create_segments(...).labels_dev",
    # the JAX package's fixed ground-truth slots: the port keeps one
    # variable-length tensor an image
    "MAX_GT": "detection.train._pad_batch",
}
# Underscore names of those modules that the port's trimmed copies lack,
# each with the port's counterpart.
LEFT_OUT_PRIVATE = {
    "_feature_frame": "classification.classify._features",
    "_make_train_step": "detection.train.make_padded_train_step",
    "_to_f32": "Image.device_tensor",
    "_GeomFuture": "concurrent.futures.Future in SegmentLayer",
    "_reduce_none": "SegmentLayer",
    "_label_raster_for": "segment_statistics._attached",
    "_build_distance_matrix": "utils.seeds.distance_matrix",
    "_detect_chm_peaks": "utils.seeds.make_chm_seeds",
    "_detect_den_peaks": "utils.seeds.make_density_seeds",
    "_peaks_to_gdf": "utils.seeds._peaks_table",
    "_geom_bounds_table": "utils.training._geom_bounds",
}
# what the re-export loop itself leaves in an alias module
LOOP_NAMES = {"_impl", "_sys", "_n", "_importlib"}


def _alias_modules(top):
    pkg = importlib.import_module(top)
    return sorted(m.name[len(top) + 1:] for m in pkgutil.walk_packages(
        pkg.__path__, top + "."))


def _jax_api(alias, impl):
    """The names of ``impl``'s own functions, classes and upper-case
    constants that the ``obia`` module ``alias`` offers."""
    names = set()
    for n in dir(alias):
        if n.startswith("__") or n in LOOP_NAMES:
            continue
        obj = getattr(alias, n)
        if inspect.ismodule(obj):
            continue
        if inspect.isfunction(obj) or inspect.isclass(obj):
            if obj.__module__ == impl.__name__:
                names.add(n)
        elif n.isupper() and n in vars(impl):
            names.add(n)
    return names


def test_every_obia_module_has_a_counterpart():
    assert _alias_modules("obia") == _alias_modules("obia_torch")


@pytest.mark.parametrize("name", _alias_modules("obia"))
def test_public_names_resolve_to_the_port(name):
    alias = importlib.import_module(f"obia.{name}")
    impl = importlib.import_module(f"obia_tpu.{name}")
    port_alias = importlib.import_module(f"obia_torch.{name}")
    port = importlib.import_module(f"obia_tpu_torch.{name}")
    want = _jax_api(alias, impl)
    missing = {n for n in want if not hasattr(port_alias, n)}
    assert missing == {n for n in want if n in LEFT_OUT
                       or n in LEFT_OUT_PRIVATE}
    for n in want - missing:
        assert getattr(port_alias, n) is getattr(port, n), n
    # every name of the port module, underscore names included, is its
    # object (``obia_torch.detection`` names four, as ``obia.detection``;
    # the other packages' ``__init__`` are empty, as ``obia``'s)
    if name == "detection":
        names = ["build_detection_model", "calculate_iou", "predict",
                 "train_model"]
    elif hasattr(port_alias, "__path__"):
        names = []
    else:
        names = [n for n in dir(port) if not n.startswith("__")]
    for n in names:
        assert getattr(port_alias, n) is getattr(port, n), n


def test_left_out_names_are_only_those_the_jax_side_has():
    seen = set()
    for name in _alias_modules("obia"):
        seen |= _jax_api(importlib.import_module(f"obia.{name}"),
                         importlib.import_module(f"obia_tpu.{name}"))
    assert set(LEFT_OUT) | set(LEFT_OUT_PRIVATE) <= seen


def test_alias_module_identity():
    import obia_torch
    from obia_torch.classification.classify import classify
    from obia_torch.segmentation.segment import segment
    import obia_tpu_torch.classification.classify as real_c
    import obia_tpu_torch.segmentation.segment as real
    assert segment is real.segment and classify is real_c.classify
    assert obia_torch.__version__ == "0.1.0"
    predict = importlib.import_module("obia_torch.detection.predict")
    real_p = importlib.import_module("obia_tpu_torch.detection.predict")
    assert predict._impl is real_p and predict.predict is real_p.predict


def _readme_flow(pkg, image_path, out, device_kw):
    """tests/test_alias_package.py's flow through ``pkg``'s import paths."""
    classify = importlib.import_module(
        f"{pkg}.classification.classify").classify
    open_geotiff = importlib.import_module(
        f"{pkg}.handlers.geotif").open_geotiff
    segment = importlib.import_module(f"{pkg}.segmentation.segment").segment
    label_segments = importlib.import_module(
        f"{pkg}.utils.utils").label_segments
    impl = "obia_tpu_torch" if pkg == "obia_torch" else "obia_tpu"
    GeoDataFrame = importlib.import_module(f"{impl}.vector").GeoDataFrame
    Point = importlib.import_module(f"{impl}.geometry.geom").Point

    image = open_geotiff(image_path)
    s = segment(image, method="slic", n_segments=12, compactness=10,
                **device_kw)
    gdf = s.segments
    cents = [(g.centroid.x, g.centroid.y) for g in gdf.geometry.values]
    classes = ["water" if x % 7 < 3.5 else "land" for x, _ in cents]
    pts = GeoDataFrame({"class": classes},
                       geometry=[Point(x, y) for x, y in cents])
    training, mixed = label_segments(gdf, pts)
    result = classify(s, training, method="rf", n_estimators=20,
                      **device_kw)
    result.classified.to_file(str(out / "classified.gpkg"))
    result.write_geotiff(str(out / "classified.tif"))
    back = open_geotiff(str(out / "classified.tif"))
    return s, training, result, back


def _gpkg_columns(path):
    with sqlite3.connect(path) as con:
        table = con.execute("SELECT table_name FROM gpkg_contents").fetchone()
        return [r[1] for r in con.execute(f'PRAGMA table_info("{table[0]}")')]


def test_readme_flow_via_obia_torch_imports(small_rgb, tmp_path):
    scene = str(tmp_path / "scene.tif")
    write_tiff(scene, (small_rgb * 255).astype(np.uint8),
               transform=Affine(2.0, 0, 600000.0, 0, -2.0, 5100000.0),
               crs="EPSG:32610")
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    s, training, result, back = _readme_flow(
        "obia_torch", scene, tmp_path / "port", {"device": "cpu"})
    js, jtraining, jresult, jback = _readme_flow("obia", scene,
                                                 tmp_path / "jax", {})

    from test_torch_slic import same_partition
    assert len(s.segments) == len(js.segments)
    assert same_partition(s.label_raster, js.label_raster)
    assert (_gpkg_columns(str(tmp_path / "port" / "classified.gpkg"))
            == _gpkg_columns(str(tmp_path / "jax" / "classified.gpkg")))
    assert list(result.classified.columns) == list(jresult.classified.columns)
    assert (sorted(set(training["feature_class"]))
            == sorted(set(jtraining["feature_class"])) == ["land", "water"])
    got = set(result.classified["predicted_class"].dropna())
    assert got and got <= {"water", "land"}
    assert back.img_data.shape[:2] == small_rgb.shape[:2]
    assert back.img_data.shape == jback.img_data.shape
