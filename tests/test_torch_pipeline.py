"""The obia_tpu_torch config-4 slice end to end against the JAX package on
the CPU: an 8-band scene built as bench.py's config 4 builds it, cut to
192 x 256 pixels and n_segments=60; SLIC on bands 0/3/6 (so RGB->Lab runs),
spectral and GLCM features of all 8 bands, then a forest.

Bars: the same label raster (bitwise) and object count; the same polygon
areas; every feature column within rtol 2e-4, atol 1e-5 of JAX, except GLCM
correlation, held at atol 2e-3: the JAX package forms variance and
covariance as float32 differences of moments near mu^2 (up to 255^2), which
costs it up to ~1e-3 on low-contrast objects, while the port finishes in
float64 from exact sums (tests/test_torch_glcm.py holds it to a float64
oracle at rtol 1e-5); and the JAX-fitted forest, carried across with
``forest_from_jax``, giving the JAX probabilities to atol 1e-6. The
moments formed from sums (mean, variance, skewness, kurtosis) are held, at
the same bar, to JAX's moments of the same labels with only the sums
widened to float64 (``test_torch_stats.jax_moments64``), as the port adds
its float32 terms in float64 and rounds once; and to the shipped float32
function at atol 2e-4, whose float32 sums miss the port's by up to 1.1e-4
past rtol 2e-4 in kurtosis here.
"""
import numpy as np
import pytest
import torch


from bench import build_scene
from obia_tpu.classification import forest as jforest
from obia_tpu.geometry.affine import Affine
from obia_tpu.handlers.geotif import image_from_array as jax_image
from obia_tpu.segmentation.segment import segment as jax_segment
from obia_tpu_torch.classification.forest import (forest_from_jax,
                                                  forest_proba)
from obia_tpu_torch.segmentation.segment import segment

H, W = 192, 256
KW = dict(segmentation_bands=[0, 3, 6], statistics_bands=list(range(8)),
          method="slic", n_segments=60, compactness=10)


def _scene():
    base3 = build_scene(h=H, w=W, c=4).astype(np.float32)
    more = np.stack([np.roll(base3[..., i % 4], 17 * (i + 1), axis=i % 2)
                     for i in range(4)], axis=-1)
    return np.concatenate([base3, more], axis=-1).astype(np.uint8)


@pytest.fixture(scope="module")
def runs():
    image = jax_image(_scene(), Affine(1.0, 0, 0, 0, -1.0, H),
                      crs="EPSG:32633")
    return jax_segment(image, **KW), segment(image, device="cpu", **KW)


def test_same_objects_and_label_raster(runs):
    js, ts = runs
    assert len(ts.table) == len(js.segments) > 20
    np.testing.assert_array_equal(ts.label_raster,
                                  np.asarray(js.label_raster))
    np.testing.assert_array_equal(ts.table["segment_id"],
                                  js.segments["segment_id"].to_numpy())


def test_same_polygon_areas(runs):
    js, ts = runs
    np.testing.assert_allclose([g.area for g in ts.table.geometry],
                               [g.area for g in js.segments.geometry])


def test_schema_matches(runs):
    js, ts = runs
    assert list(ts.table.columns) + ["geometry"] == list(js.segments.columns)
    gdf = ts.objects
    assert list(gdf.columns) == list(js.segments.columns)
    # the port's CRS is its own class: compare what it holds
    assert gdf.crs.to_epsg() == js.segments.crs.to_epsg() == 32633
    assert gdf.crs.to_wkt() == js.segments.crs.to_wkt()


@pytest.mark.parametrize("family", ["mean", "variance", "min", "max",
                                    "skewness", "kurtosis", "contrast",
                                    "dissimilarity", "homogeneity", "ASM",
                                    "energy", "correlation"])
def test_feature_columns_match(runs, family):
    from test_torch_stats import jax_moments64, shipped_gap

    js, ts = runs
    moments64 = None
    if family in ("mean", "variance", "skewness", "kurtosis"):
        names, packed = jax_moments64(_scene(), ts.label_raster,
                                      len(ts.table))
        moments64 = packed[list(names).index(family)]
    for b in range(8):
        c = f"b{b}_{family}"
        shipped = js.segments[c].to_numpy(np.float64)
        want = shipped if moments64 is None else moments64[:, b]
        got = ts.table[c]
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        if family == "correlation":
            np.testing.assert_allclose(got, want, rtol=0, atol=2e-3,
                                       err_msg=c)
        else:
            np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5,
                                       err_msg=c)
        if moments64 is not None:
            # the shipped float32 function misses the port by up to 1.1e-4
            # past rtol 2e-4 (kurtosis of object 2, band 7)
            np.testing.assert_array_equal(np.isnan(got), np.isnan(shipped))
            assert shipped_gap(got, shipped, 2e-4, c) <= 2e-4, c


def test_forest_proba_matches(runs):
    js, ts = runs

    def features(get, cols):
        X = np.stack([get(c) for c in cols], axis=1).astype(np.float64)
        return np.nan_to_num(X)

    cols = [c for c in ts.table.columns if c != "segment_id"
            and not np.isnan(ts.table[c]).all()]
    Xj = features(lambda c: js.segments[c].to_numpy(), cols)
    Xt = features(lambda c: ts.table[c], cols)
    y = (Xj[:, 0] > np.median(Xj[:, 0])).astype(int)
    clf = jforest.JaxForestClassifier(n_estimators=50, random_state=0)
    clf.fit(Xj, y)
    want = clf.predict_proba(Xj)
    got = forest_proba(forest_from_jax(clf._arrays, device="cpu"),
                       torch.as_tensor(Xt)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_open_geotiff_and_device_upload_match_jax(tmp_path):
    from obia_tpu.handlers.geotif import open_geotiff as jax_open
    from obia_tpu.io.tiff import write_tiff
    from obia_tpu_torch.handlers.geotif import open_geotiff

    arr = (np.random.default_rng(7).random((30, 41, 4)) * 4000).astype(
        np.uint16)
    path = str(tmp_path / "scene.tif")
    write_tiff(path, arr, transform=Affine(2, 0, 600000, 0, -2, 5100000),
               crs="EPSG:32610", compression="deflate")
    want = jax_open(path, bands=[3, 1])
    got = open_geotiff(path, bands=[3, 1])
    np.testing.assert_array_equal(got.img_data, want.img_data)
    assert got.affine_transformation == want.affine_transformation
    # the port's CRS is its own class: compare what it holds
    assert got.crs.to_epsg() == want.crs.to_epsg() == 32610
    assert got.crs.to_wkt() == want.crs.to_wkt()
    assert got.transform == want.transform
    t = got.device_tensor("cpu")
    assert t.dtype == torch.float32 and got.device_tensor("cpu") is t
    np.testing.assert_array_equal(t.numpy(), want.img_data)
