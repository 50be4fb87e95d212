"""obia_tpu_torch's ``create_objects`` on any polygon table, against the
JAX package on the CPU: a filtered, a reordered and a shifted table, a
GeoPackage read back, a pandas frame, ``create_tiled_segments``' layer
(which carries no label raster) and a filtered mosaic table; the
``strict_reference_glcm`` hatch; the single-object helpers; and the
classified GeoTIFF of a rasterised table.

The scene is ``bench.build_scene(96, 128)`` (RGB uint8) with SLIC
n_segments=24, where both packages give the same label raster (21 objects).

Bars: the rasterised label raster bitwise JAX's; spectral min and max
equal, the moments within rtol 1e-4 / atol 1e-5 of JAX's moments of the
same labels with the sums widened to float64 (``test_torch_stats.
jax_moments64``, the port's own summation); GLCM props within rtol 2e-4 /
atol 1e-5 (correlation atol 2e-3, as ``test_torch_pipeline.py`` sets it);
NaN slots equal. The strict hatch's columns bitwise JAX's. A filtered
table's features equal the unfiltered table's rows within rtol 1e-6 /
atol 1e-6, as the polygons trace pixel edges and rasterise back to the
same pixels.
"""
import numpy as np
import pytest

from bench import build_scene
from obia_tpu.geometry.affine import Affine as JAffine
from obia_tpu.handlers.geotif import image_from_array as jax_image
from obia_tpu.segmentation import segment_statistics as jss
from obia_tpu.segmentation.segment_boundaries import (LABEL_RASTER_ATTR,
                                                      create_segments as
                                                      jax_create_segments,
                                                      unwrap_attr)
from obia_tpu_torch.segmentation import segment_statistics as tss
from obia_tpu_torch.segmentation.segment_boundaries import create_segments

H, W, N_SEGMENTS = 96, 128, 24
TRANSFORM = (2.0, 0, 500000.0, 0, -2.0, 4000000.0)
SPECTRAL = ("mean", "variance", "min", "max", "skewness", "kurtosis")


@pytest.fixture(scope="module")
def scene():
    """(JAX image, JAX segments frame, port layer, port full table, JAX
    full table), on the same label raster."""
    image = jax_image(build_scene(h=H, w=W, c=3), JAffine(*TRANSFORM),
                      crs="EPSG:32633")
    jsegs = jax_create_segments(image, method="slic", n_segments=N_SEGMENTS)
    layer = create_segments(image, method="slic", n_segments=N_SEGMENTS,
                            device="cpu")
    np.testing.assert_array_equal(
        np.asarray(layer.label_raster),
        np.asarray(unwrap_attr(jsegs.attrs[LABEL_RASTER_ATTR])))
    return (image, jsegs, layer, tss.create_objects(layer, image),
            jss.create_objects(jsegs, image))


def jax_labels(jobjs) -> np.ndarray:
    return np.asarray(unwrap_attr(jobjs.attrs[LABEL_RASTER_ATTR]))


def assert_features_match(port, jobjs, image):
    """The port's table against JAX's at the bars of the module docstring,
    the moments against JAX's moments of JAX's label raster with the sums
    widened."""
    from test_torch_stats import jax_moments64

    assert len(port) == len(jobjs)
    assert list(port.columns) + ["geometry"] == list(jobjs.columns)
    np.testing.assert_array_equal(port["segment_id"],
                                  jobjs["segment_id"].to_numpy())
    names, m64 = jax_moments64(np.asarray(image.img_data), jax_labels(jobjs),
                               len(jobjs))
    m64 = dict(zip(names, m64))
    for c in port.columns:
        if c == "segment_id":
            continue
        got = np.asarray(port[c], np.float64)
        want = jobjs[c].to_numpy(np.float64)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want),
                                      err_msg=c)
        stat = c.split("_", 1)[1] if c.startswith("b") else c
        if stat in ("min", "max"):
            np.testing.assert_array_equal(got, want, err_msg=c)
        elif stat in SPECTRAL:
            np.testing.assert_allclose(got, m64[stat][:, int(c[1])],
                                       rtol=1e-4, atol=1e-5, err_msg=c)
        elif stat == "correlation":
            np.testing.assert_allclose(got, want, rtol=0, atol=2e-3,
                                       err_msg=c)
        else:
            np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5,
                                       err_msg=c)


def _tables(scene, kind, tmp_path):
    """(port table, JAX table) of one kind of polygon table."""
    from obia_tpu.vector import read_file
    from obia_tpu_torch.vector.features import read_features
    image, jsegs, layer, full, _ = scene
    n = len(full)
    if kind == "gpkg":
        path = str(tmp_path / "segments.gpkg")
        layer.to_file(path)
        return read_features(path), read_file(path)
    idx = {"filtered": np.arange(0, n, 2), "reordered": np.arange(n)[::-1],
           "shifted": np.arange(1, n), "frame": np.arange(1, n, 3)}[kind]
    jtab = jsegs.iloc[idx].reset_index(drop=True)
    jtab.attrs = dict(jsegs.attrs)
    port = full.take(idx)
    return (port.to_geodataframe() if kind == "frame" else port), jtab


@pytest.mark.parametrize("kind", ["filtered", "reordered", "shifted",
                                  "gpkg", "frame"])
def test_any_polygon_table_matches_jax(scene, kind, tmp_path):
    image = scene[0]
    table, jtab = _tables(scene, kind, tmp_path)
    kw = {"device": "cpu"} if kind in ("gpkg", "frame") else {}
    got = tss.create_objects(table, image, **kw)
    want = jss.create_objects(jtab, image)
    np.testing.assert_array_equal(got.label_raster, jax_labels(want))
    assert got.layer is None and got.labels_dev.device.type == "cpu"
    assert_features_match(got, want, image)
    assert len(got.geometry) == len(got)


@pytest.mark.parametrize("kind", ["filtered", "reordered", "shifted"])
def test_rasterised_rows_equal_the_unfiltered_rows(scene, kind, tmp_path):
    """Rasterising a polygon gives back its pixels, so a filtered or
    reordered table's features are the unfiltered table's rows."""
    image, _, _, full, _ = scene
    table, _ = _tables(scene, kind, tmp_path)
    got = tss.create_objects(table, image)
    rows = table.label_rows
    for c in full.columns:
        np.testing.assert_allclose(got[c], full[c][rows], rtol=1e-6,
                                   atol=1e-6, err_msg=c)


def test_attached_tables_keep_their_raster(scene, monkeypatch):
    """A table whose rows still map onto its layer (every row, in order)
    is featurised on the layer's raster, not rasterised."""
    from obia_tpu_torch.geometry import rasterize as trz
    image, _, layer, full, jfull = scene
    monkeypatch.setattr(trz, "rasterize", lambda *a, **k: pytest.fail(
        "rasterised an attached table"))
    for table in (layer, full, full.take(np.arange(len(full)))):
        got = tss.create_objects(table, image)
        assert got.layer is layer and got.rows is None
        for c in full.columns:
            np.testing.assert_array_equal(got[c], full[c])
    assert_features_match(full, jfull, image)


def test_filtered_mosaic_table_takes_the_single_device_path(monkeypatch):
    """JAX's test_mosaic.py:104: a mosaic table whose rows no longer match
    its mesh blocks is featurised by the single-device reductions on the
    rasterised raster, and equals the unfiltered run's rows."""
    from obia_tpu_torch.handlers.geotif import image_from_array
    from obia_tpu_torch.parallel import glcm_sharded, sharded
    from obia_tpu_torch.parallel.mesh import make_mesh
    from obia_tpu_torch.parallel.mosaic import mosaic_pipeline

    img = image_from_array(build_scene(h=64, w=96, c=3),
                           JAffine(1, 0, 0, 0, -1, 64), crs="EPSG:32633")
    full = mosaic_pipeline(img, n_segments=12, mesh=make_mesh(8, ["cpu"]),
                           objects_kwargs={"glcm_levels": 32})
    assert full.layer.shards is not None

    def boom(*a, **k):
        raise AssertionError("stale sharded reduction must not be called")

    monkeypatch.setattr(sharded, "sharded_spectral_moments", boom)
    monkeypatch.setattr(glcm_sharded, "sharded_glcm_props", boom)
    got = tss.create_objects(full.take(np.arange(1, len(full))), img,
                             glcm_levels=32)
    assert len(got) == len(full) - 1
    assert np.isfinite(got["b0_mean"]).all()
    for c in full.columns:
        np.testing.assert_allclose(got[c], full[c][1:], rtol=1e-5,
                                   atol=1e-6, err_msg=c)


def test_tiled_layer_featurises_as_jax(tmp_path):
    """``create_tiled_segments``' layer carries no label raster:
    create_objects rasterises it, as JAX does with the same polygons."""
    from obia_tpu.utils.tiling import create_tiled_segments as jax_tiled
    from obia_tpu_torch.handlers.geotif import open_geotiff
    from obia_tpu_torch.io.tiff import write_tiff
    from obia_tpu_torch.utils.tiling import create_tiled_segments

    raster = str(tmp_path / "scene.tif")
    write_tiff(raster, build_scene(h=80, w=96, c=3),
               transform=JAffine(1, 0, 0, 0, -1, 80), crs="EPSG:32633")
    kw = dict(tile_size=48, buffer=8, n_segments=8)
    layer = create_tiled_segments(raster, str(tmp_path / "port"),
                                  device="cpu", **kw)
    jlayer = jax_tiled(raster, str(tmp_path / "jax"), **kw)
    assert layer.labels_dev is None and len(layer) == len(jlayer)
    image = open_geotiff(raster)
    got = tss.create_objects(layer, image, device="cpu")
    want = jss.create_objects(jlayer, image)
    np.testing.assert_array_equal(got.label_raster, jax_labels(want))
    assert_features_match(got, want, image)


def test_classified_geotiff_of_a_rasterised_table(scene, tmp_path):
    """``write_geotiff`` of a filtered table that create_objects
    rasterised draws each row on its own polygon's pixels: the bytes of
    JAX's render of the same rows over its attached raster."""
    from obia_tpu.classification.classify import ClassifiedImage
    from obia_tpu_torch.classification.classify import classify
    image, jsegs, _, full, jfull = scene
    table, jtab = _tables(scene, "filtered", tmp_path)
    objs = tss.create_objects(table, image)
    y = (objs["b0_mean"] > np.median(objs["b0_mean"])).astype(int)
    out = classify(objs, objs.with_columns(feature_class=y), method="mlp",
                   hidden_layer_sizes=(4,), max_iter=3, device="cpu")
    port_tif = tmp_path / "port.tif"
    out.write_geotiff(str(port_tif))
    jcls = jfull.iloc[table.label_rows].reset_index(drop=True)
    jcls["predicted_class"] = out.table["predicted_class"]
    jax_tif = tmp_path / "jax.tif"
    ClassifiedImage(jcls, None, None, None, image.transform, "EPSG:32633",
                    {}, label_raster=jax_labels(jfull)).write_geotiff(
                        str(jax_tif))
    assert port_tif.read_bytes() == jax_tif.read_bytes()


@pytest.mark.parametrize("kind", ["attached", "filtered"])
def test_strict_reference_glcm_is_jax_bitwise(scene, kind, tmp_path):
    image, jsegs, layer, _, _ = scene
    if kind == "attached":
        table, jtab = layer, jsegs
    else:
        table, jtab = _tables(scene, "filtered", tmp_path)
    got = tss.create_objects(table, image, strict_reference_glcm=True,
                             textural_bands=[0, 2])
    want = jss.create_objects(jtab, image, strict_reference_glcm=True,
                              textural_bands=[0, 2])
    for c in got.columns:
        if c.startswith(("b0_", "b2_")) and c.split("_", 1)[1] not in \
                SPECTRAL:
            np.testing.assert_array_equal(got[c], want[c].to_numpy(float),
                                          err_msg=c)


def test_strict_reference_sliver_bbox():
    """JAX's test_ops_stats.py:255: a bbox narrower than the band index
    gives NaN for that band, as JAX does, where the reference raises."""
    flags = dict.fromkeys(tss.TEXTURAL_STATS, True)
    crop = np.random.default_rng(0).random((4, 6, 2))
    crop[:, 0, 0] = np.nan
    got = tss._strict_reference_textural_stats(crop, [0, 1, 2, 3], flags)
    want = jss._strict_reference_textural_stats(crop, [0, 1, 2, 3], flags)
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(list(got.values()), list(want.values()))
    assert np.isfinite(got["b0_contrast"]) and np.isnan(got["b2_ASM"])


@pytest.mark.parametrize("empty_band", [False, True])
def test_single_object_helpers_match_jax(empty_band):
    rng = np.random.default_rng(3)
    img = (rng.random((3, 9, 11)) * 200).astype(np.float32)
    img[:, :2, :3] = np.nan
    if empty_band:
        img[1] = np.nan
    got = tss.calculate_spectral_stats(img, [0, 1, 2], calc_min=False)
    want = jss.calculate_spectral_stats(img, [0, 1, 2], calc_min=False)
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(list(got.values()), list(want.values()))
    got = tss.calculate_textural_stats(img, [0, 1, 2], calc_ASM=False,
                                       device="cpu")
    want = jss.calculate_textural_stats(img, [0, 1, 2], calc_ASM=False)
    assert got.keys() == want.keys()
    np.testing.assert_allclose(list(got.values()), list(want.values()),
                               rtol=2e-4, atol=1e-5)


def test_device_follows_the_input_and_type_is_checked(scene):
    image, _, _, full, _ = scene
    kept = full.take([0, 2])
    got = tss.create_objects(kept, image)
    assert got.labels_dev.device.type == "cpu"
    np.testing.assert_array_equal(got.labels_dev.numpy(), got.label_raster)
    with pytest.raises(ValueError, match="labels"):
        tss.create_objects(kept, image, device="meta")
    with pytest.raises(TypeError, match="SegmentLayer"):
        tss.create_objects([1, 2], image, device="cpu")
    with pytest.raises(ValueError, match="At least one"):
        tss.create_objects(kept, image, calculate_spectral=False,
                           calculate_textural=False)
