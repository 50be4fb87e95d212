"""obia_tpu_torch/parallel/mosaic.py (config 5) against the JAX package's
mosaic on the 8-device CPU mesh of tests/conftest.py.

Bars: sharded labels and object counts bitwise equal to JAX's
``segment_mosaic`` (and, for a raster that divides the mesh, to the port's
single-device SLIC); ``mosaic_pipeline``'s columns within rtol 2e-4, atol
1e-5 of JAX's, except GLCM correlation at atol 2e-3 (JAX forms it from
float32 moment differences; see tests/test_torch_pipeline.py); the sharded
features within rtol 2e-4, atol 1e-5 of the single-device
``create_objects`` on the same labels (both add float32 terms in float64
and round once); seam_overhead equal to JAX's. The moments formed from sums
(mean, variance, skewness, kurtosis) are held, at the same bar, to JAX's
moments of the same labels with only the sums widened to float64
(``test_torch_stats.jax_moments64``), and to JAX's shipped float32 columns
at atol 1e-4: its sharded float32 sums miss the port's by up to 3.9e-5
past rtol 2e-4 in skewness here.
"""
import numpy as np
import pytest
import torch

from obia_tpu.geometry.affine import Affine
from obia_tpu.handlers.geotif import image_from_array as jax_image
from obia_tpu.parallel import mosaic as jmos
from obia_tpu.parallel.sharded import make_mesh as jax_mesh
from obia_tpu_torch.parallel import mosaic as tmos
from obia_tpu_torch.parallel.mesh import make_mesh

OKW = {"glcm_levels": 32}   # CI-sized histograms, as tests/test_mosaic.py


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8, ["cpu"])


def test_segment_mosaic_matches_jax_and_single_device(small_rgb, mesh):
    from obia_tpu_torch.ops.slic import slic_dense

    want, k_want = jmos.segment_mosaic(small_rgb, n_segments=30,
                                       compactness=10.0, mesh=jax_mesh(8))
    got, k = tmos.segment_mosaic(small_rgb, n_segments=30, compactness=10.0,
                                 mesh=mesh)
    assert k == k_want
    np.testing.assert_array_equal(got, want)
    single, k_single = slic_dense(torch.as_tensor(small_rgb), n_segments=30,
                                  compactness=10.0, convert2lab=False)
    assert k_single == k
    np.testing.assert_array_equal(got, single.numpy())


def test_segment_mosaic_nondivisible_matches_jax(small_rgb, mesh):
    img = small_rgb[:90, :123]  # not divisible by the mesh
    want, k_want = jmos.segment_mosaic(img, n_segments=20, mesh=jax_mesh(8))
    got, k = tmos.segment_mosaic(img, n_segments=20, mesh=mesh)
    assert got.shape == img.shape[:2]
    assert k == k_want and got.min() == 0 and got.max() == k - 1
    np.testing.assert_array_equal(got, want)


def test_segment_mosaic_device_keeps_labels_sharded(small_rgb, mesh):
    m, lab, K, hw = tmos.segment_mosaic_device(small_rgb[:90, :123],
                                               n_segments=20, mesh=mesh)
    assert m is mesh and hw == (90, 123)
    assert lab.padded_hw == (90, 124) and lab.block_hw == (45, 31)
    full = lab.gather()
    assert (full[:, 123:] == -1).all() and int(full.max()) == K - 1


def test_mesh_alone_places_the_shards(small_rgb, mesh):
    # no default mesh: the shards never land on the CPU unasked
    with pytest.raises(TypeError, match="mesh"):
        tmos.segment_mosaic_device(small_rgb, n_segments=20)
    # a tensor off the CPU given a CPU mesh raises rather than leave its
    # device (a meta tensor stands in for one on the card)
    off = torch.empty(small_rgb.shape, dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="mesh on the CPU"):
        tmos.segment_mosaic_device(off, n_segments=20, mesh=mesh)


@pytest.fixture(scope="module")
def pipelines(mesh):
    rng = np.random.default_rng(42)
    h, w = 96, 128
    base = np.zeros((h, w, 3), np.float32)
    base[:h // 2, :, 0] = 0.8
    base[h // 2:, :, 1] = 0.6
    base[:, w // 2:, 2] = 0.9
    noise = rng.normal(0, 0.03, size=(h, w, 3)).astype(np.float32)
    scene = np.clip(base + noise, 0, 1)
    image = jax_image(scene, Affine(1, 0, 0, 0, -1, 96), crs="EPSG:32633")
    want = jmos.mosaic_pipeline(image, n_segments=24, mesh=jax_mesh(8),
                                objects_kwargs=OKW)
    got = tmos.mosaic_pipeline(image, n_segments=24, mesh=mesh,
                               objects_kwargs=OKW)
    return image, want, got


def test_mosaic_pipeline_objects_match_jax(pipelines):
    _, want, got = pipelines
    assert len(got) == len(want) >= 4
    assert list(got.columns) + ["geometry"] == list(want.columns)
    np.testing.assert_array_equal(got["segment_id"],
                                  want["segment_id"].to_numpy())
    np.testing.assert_allclose([g.area for g in got.geometry],
                               [g.area for g in want.geometry])
    assert got.layer.shards is not None


@pytest.mark.parametrize("family", ["mean", "variance", "min", "max",
                                    "skewness", "kurtosis", "contrast",
                                    "dissimilarity", "homogeneity", "ASM",
                                    "energy", "correlation"])
def test_mosaic_pipeline_columns_match_jax(pipelines, family):
    from test_torch_stats import jax_moments64, shipped_gap

    image, want, got = pipelines
    moments64 = None
    if family in ("mean", "variance", "skewness", "kurtosis"):
        names, packed = jax_moments64(image.img_data,
                                      got.layer.label_raster, len(got))
        moments64 = packed[list(names).index(family)]
    for b in range(3):
        c = f"b{b}_{family}"
        shipped = want[c].to_numpy(np.float64)
        w = shipped if moments64 is None else moments64[:, b]
        np.testing.assert_array_equal(np.isnan(got[c]), np.isnan(w))
        tol = (dict(rtol=0, atol=2e-3) if family == "correlation"
               else dict(rtol=2e-4, atol=1e-5))
        np.testing.assert_allclose(got[c], w, err_msg=c, **tol)
        if moments64 is not None:
            # the shipped float32 function misses the port by up to 3.9e-5
            # past rtol 2e-4 (skewness of object 11, band 0)
            np.testing.assert_array_equal(np.isnan(got[c]),
                                          np.isnan(shipped))
            assert shipped_gap(got[c], shipped, 2e-4, c) <= 1e-4, c


def test_sharded_features_match_single_device(pipelines):
    from obia_tpu_torch.segmentation.segment_boundaries import SegmentLayer
    from obia_tpu_torch.segmentation.segment_statistics import create_objects

    image, _, got = pipelines
    lay = got.layer
    plain = SegmentLayer(len(lay), lay.geometry, lay.crs, lay.transform,
                         lay.affine_transformation, lay.label_raster,
                         lay.labels_dev)
    want = create_objects(plain, image, glcm_levels=32)
    for c in want.columns:
        np.testing.assert_array_equal(np.isnan(got[c]), np.isnan(want[c]))
        np.testing.assert_allclose(got[c], want[c], rtol=2e-4, atol=1e-5,
                                   err_msg=c)


def test_mosaic_pipeline_writes_a_geopackage(pipelines, mesh, tmp_path):
    from obia_tpu.vector import read_file

    image, _, got = pipelines
    path = str(tmp_path / "mosaic.gpkg")
    again = tmos.mosaic_pipeline(image, n_segments=24, mesh=mesh,
                                 output_gpkg=path, objects_kwargs=OKW)
    back = read_file(path)
    assert len(back) == len(again) == len(got)
    np.testing.assert_allclose(back["b0_mean"].to_numpy(), got["b0_mean"])


def test_training_classes_raise(pipelines, mesh):
    """A training table without ``feature_class`` cannot classify."""
    image, _, got = pipelines
    with pytest.raises(KeyError, match="feature_class"):
        tmos.mosaic_pipeline(image, n_segments=24, mesh=mesh,
                             objects_kwargs=OKW,
                             training_classes=got.take(np.arange(8)))


@pytest.mark.parametrize("method,kw", [
    ("rf", dict(n_estimators=10, random_state=0)),
    ("mlp", dict(hidden_layer_sizes=(8,), max_iter=20, random_state=0))])
def test_mosaic_pipeline_classifies(pipelines, mesh, method, kw, tmp_path):
    """With ``training_classes`` the mosaic returns the table ``classify``
    gives for its objects, and writes it."""
    from obia_tpu.vector import read_file
    from obia_tpu_torch.classification.classify import classify

    image, _, got = pipelines
    idx = np.arange(0, len(got), 2)
    training = got.take(idx).with_columns(
        feature_class=np.where(got["b0_mean"][idx] > np.median(
            got["b0_mean"]), 1, 2))
    path = str(tmp_path / "classified.gpkg")
    out = tmos.mosaic_pipeline(image, n_segments=24, mesh=mesh,
                               objects_kwargs=OKW, output_gpkg=path,
                               training_classes=training,
                               classify_kwargs=dict(method=method, **kw))
    want = classify(got, training, method=method, device="cpu", **kw).table
    assert list(out.columns) == list(want.columns)
    for c in want.columns:
        np.testing.assert_array_equal(out[c], want[c], err_msg=c)
    back = read_file(path)
    assert list(back["predicted_class"]) == list(want["predicted_class"])


@pytest.mark.parametrize("tol", [0, 1, 2])
def test_seam_overhead_matches_jax(tol):
    rng = np.random.default_rng(tol)
    a = rng.integers(0, 4, (40, 50)).astype(np.int32)
    b = np.where(rng.random((40, 50)) < 0.2, 9, a).astype(np.int32)
    assert tmos.seam_overhead(a, b, tolerance_px=tol) == pytest.approx(
        jmos.seam_overhead(a, b, tolerance_px=tol), abs=0)
    np.testing.assert_array_equal(tmos.boundary_map(b), jmos.boundary_map(b))


def test_seam_overhead_metric():
    a = np.zeros((20, 20), np.int32)
    a[:, 10:] = 1
    assert tmos.seam_overhead(a, a.copy()) == 0.0
    c = np.zeros((20, 20), np.int32)
    c[10:, :] = 1  # a completely different boundary
    assert tmos.seam_overhead(a, c, tolerance_px=0) > 50.0
    assert tmos.seam_overhead(np.zeros((5, 5)), c[:5, :5]) == 0.0
