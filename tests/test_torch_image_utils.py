"""The port's image utilities (``utils/image``) and window, mask and
prediction helpers (``utils/utils``) against the JAX package, bitwise, on
the OpenCV path and on the numpy path (``_cv2`` patched to None in both
packages, as where OpenCV is not installed)."""
import json

import numpy as np
import pandas as pd
import pytest

from obia_tpu.geometry.affine import Affine as JAffine
from obia_tpu.geometry.geom import Polygon as JPolygon
from obia_tpu.handlers.geotif import image_from_array as jimage
from obia_tpu.utils import image as jimg
from obia_tpu.utils import utils as jutils
from obia_tpu_torch.geometry.affine import Affine
from obia_tpu_torch.geometry.geom import Polygon
from obia_tpu_torch.handlers.geotif import image_from_array as timage
from obia_tpu_torch.io.tiff import TiffReader, write_tiff
from obia_tpu_torch.utils import image as timg
from obia_tpu_torch.utils import utils as tutils


@pytest.fixture(params=["cv2", "numpy"])
def path(request, monkeypatch):
    """Run a case on OpenCV's path (where it imports) and on numpy's."""
    if request.param == "numpy":
        monkeypatch.setattr(jimg, "_cv2", lambda: None)
        monkeypatch.setattr(timg, "_cv2", lambda: None)
    elif timg._cv2() is None:
        pytest.skip("OpenCV is not installed")
    return request.param


def _rgb(seed=0, h=40, w=52):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([np.sin(yy / 7.0), np.cos(xx / 5.0),
                     np.sin((yy + xx) / 9.0)], axis=-1)
    return ((base + 1) * 100 + rng.normal(0, 8, (h, w, 3))).clip(
        0, 255).astype(np.uint8)


def test_rescale_and_gray():
    rng = np.random.default_rng(1)
    img = rng.normal(500, 120, (30, 34, 4)).astype(np.float32)
    for lo, hi in ((2, 98), (0, 100), (10, 60)):
        np.testing.assert_array_equal(timg.rescale_to_8bit(img, lo, hi),
                                      jimg.rescale_to_8bit(img, lo, hi))
    const = np.full((5, 5), 3.0)
    assert not timg.rescale_to_8bit(const).any()
    rgb = _rgb().astype(np.float32)
    np.testing.assert_array_equal(timg.rgb_to_gray(rgb),
                                  jimg.rgb_to_gray(rgb))


@pytest.mark.parametrize("bands", [3, 1])
def test_histogram_equalization(path, bands):
    img = _rgb(2)
    img = img if bands == 3 else np.ascontiguousarray(img[:, :, 1])
    got = timg.apply_histogram_equalization(img)
    np.testing.assert_array_equal(got, jimg.apply_histogram_equalization(img))
    assert got.shape == img.shape[:2] + (3,)


@pytest.mark.parametrize("bands", [3, 1])
def test_clahe(path, bands):
    img = _rgb(3, 64, 72)
    img = img if bands == 3 else np.ascontiguousarray(img[:, :, 0])
    np.testing.assert_array_equal(timg.apply_clahe(img),
                                  jimg.apply_clahe(img))


@pytest.mark.parametrize("win", [3, 7])
def test_variance_of_laplacian(path, win):
    gray = jimg.rgb_to_gray(_rgb(4).astype(np.float32) / 255)
    np.testing.assert_array_equal(timg.variance_of_laplacian(gray, win),
                                  jimg.variance_of_laplacian(gray, win))


def test_laplacian_raster(path, tmp_path):
    rng = np.random.default_rng(5)
    arr = (rng.random((48, 56, 6)) * 2000).astype(np.uint16)
    src = str(tmp_path / "in.tif")
    write_tiff(src, arr, transform=Affine(2, 0, 500000, 0, -2, 5100000),
               crs="EPSG:32633")
    mine, theirs = str(tmp_path / "port.tif"), str(tmp_path / "jax.tif")
    timg.laplacian(src, mine, 5, vis_bands=(2, 3, 5))
    jimg.laplacian(src, theirs, 5, vis_bands=(2, 3, 5))
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    got = TiffReader(mine).read()
    assert got.dtype == np.float32 and 0 <= got.min() and got.max() <= 1


def _images():
    arr = _rgb(6, 50, 60).astype(np.float32)
    return (timage(arr, Affine(0.5, 0, 500000, 0, -0.5, 5100000),
                   crs="EPSG:32633"),
            jimage(arr, JAffine(0.5, 0, 500000, 0, -0.5, 5100000),
                   crs="EPSG:32633"))


RING = [(500003.2, 5099980.1), (500020.7, 5099984.3), (500017.1, 5099996.6),
        (500005.4, 5099993.9), (500003.2, 5099980.1)]


@pytest.mark.parametrize("shift", [0.0, -10.0])
def test_crop_and_mask_equal_jax(shift):
    """A polygon inside the raster, and one hanging off its left edge."""
    ring = [(x + shift, y) for x, y in RING]
    mine, theirs = _images()
    crop, tfm = tutils.crop_image_to_bbox(mine, Polygon(ring))
    jcrop, jtfm = jutils.crop_image_to_bbox(theirs, JPolygon(ring))
    np.testing.assert_array_equal(crop, jcrop)
    assert tuple(tfm) == tuple(jtfm)
    masked = tutils.mask_image_with_polygon(crop, Polygon(ring), tfm)
    np.testing.assert_array_equal(
        masked, jutils.mask_image_with_polygon(jcrop, JPolygon(ring), jtfm))
    assert np.isnan(masked).any() and not np.isnan(masked).all()


@pytest.mark.parametrize("columns", ["label and score", "boxes only"])
def test_deepforest_predictions_gpkg_equal_jax(columns, tmp_path):
    from test_torch_seeds_cost import gpkg_rows
    df = pd.DataFrame({"xmin": [1.0, 10.5, 30.0], "ymin": [2.0, 4.0, 8.5],
                       "xmax": [9.0, 20.0, 44.0], "ymax": [7.5, 19.0, 20.0]})
    if columns == "label and score":
        df["label"] = ["Tree", "Tree", "Snag"]
        df["score"] = [0.91, 0.42, 0.77]
    tj = str(tmp_path / "transforms.json")
    with open(tj, "w") as f:
        json.dump({"tile_0": {"transform": [0.3, 0, 500000, 0, -0.3,
                                            5100000], "crs": "EPSG:32633"}},
                  f)
    mine = str(tmp_path / "pred.gpkg")
    theirs = str(tmp_path / "j" / "pred.gpkg")
    (tmp_path / "j").mkdir()
    tutils.save_deepforest_predictions_to_gpkg(df, "tile_0", tj, mine)
    jutils.save_deepforest_predictions_to_gpkg(df, "tile_0", tj, theirs)
    assert gpkg_rows(mine, "pred") == gpkg_rows(theirs, "pred")
    # an unknown tile and an empty frame write nothing, in both
    for mod in (tutils, jutils):
        mod.save_deepforest_predictions_to_gpkg(df, "nope", tj,
                                                str(tmp_path / "x.gpkg"))
        mod.save_deepforest_predictions_to_gpkg(df.iloc[:0], "tile_0", tj,
                                                str(tmp_path / "y.gpkg"))
    assert not (tmp_path / "x.gpkg").exists()
    assert not (tmp_path / "y.gpkg").exists()
