"""An ``Image`` made from a narrow-dtype scene (uint8, uint16) keeps the
source array: its shape and its upload read the source, and the float32
host copy is built, once and counted as ``image.widen``, only when
``img_data`` is read. What it builds equals ``np.asarray(arr, float32)``
and the JAX package's ``Image`` bit for bit."""
import numpy as np
import pytest
import torch

from obia_tpu.geometry.affine import Affine as JAffine
from obia_tpu.handlers.geotif import image_from_array as jimage
from obia_tpu_torch import telemetry
from obia_tpu_torch.geometry.affine import Affine
from obia_tpu_torch.handlers.geotif import (Image, image_from_array,
                                            open_geotiff)
from obia_tpu_torch.io.tiff import write_tiff

NARROW = [np.uint8, np.uint16]


@pytest.fixture(autouse=True)
def fresh_counters():
    telemetry.reset()
    yield
    telemetry.reset()


def _arr(dtype, seed=0, shape=(23, 31, 4)):
    top = np.iinfo(dtype).max
    return np.random.default_rng(seed).integers(0, top + 1, shape,
                                                dtype=dtype)


def _widens():
    return telemetry.counters().get("image.widen")


def _image(arr):
    return image_from_array(arr, Affine(1, 0, 0, 0, -1, arr.shape[0]))


@pytest.mark.parametrize("dtype", NARROW)
def test_narrow_scene_is_widened_only_when_img_data_is_read(dtype):
    arr = _arr(dtype)
    image = _image(arr)
    assert image.shape == arr.shape
    assert (image.height, image.width, image.count) == arr.shape
    image.device_tensor("cpu")
    assert _widens() == 0
    data = image.img_data
    assert _widens() == 1
    assert data.dtype == np.float32
    np.testing.assert_array_equal(data, np.asarray(arr, np.float32))
    want = jimage(arr, JAffine(1, 0, 0, 0, -1, arr.shape[0])).img_data
    assert want.dtype == np.float32
    np.testing.assert_array_equal(data, want)
    assert image.img_data is data and _widens() == 1


@pytest.mark.parametrize("dtype", NARROW)
def test_upload_of_a_narrow_scene_equals_the_host_widening(dtype):
    arr = _arr(dtype, seed=1)
    t = _image(arr).device_tensor("cpu")
    assert t.dtype == torch.float32
    assert torch.equal(t, torch.from_numpy(np.asarray(arr, np.float32)))
    assert _widens() == 0


def test_open_geotiff_keeps_the_uint8_source(tmp_path):
    arr = _arr(np.uint8, seed=2)
    path = str(tmp_path / "scene.tif")
    write_tiff(path, arr, transform=Affine(2, 0, 600000, 0, -2, 5100000),
               crs="EPSG:32610")
    image = open_geotiff(path, bands=[3, 1])
    want = np.asarray(arr[:, :, [2, 0]], np.float32)
    assert image.shape == want.shape and image.count == 2
    assert torch.equal(image.device_tensor("cpu"), torch.from_numpy(want))
    assert _widens() == 0
    np.testing.assert_array_equal(image.img_data, want)
    assert _widens() == 1


def test_assigning_img_data_drops_the_source_and_the_upload():
    image = _image(_arr(np.uint8, seed=3))
    old = image.device_tensor("cpu")
    new = np.full(image.shape, 7.5, np.float32)
    image.img_data = new
    assert image.img_data is new
    t = image.device_tensor("cpu")
    assert t is not old and torch.equal(t, torch.from_numpy(new))
    assert telemetry.counters()["image.uploads"] == 2
    assert _widens() == 0


def test_float32_input_is_kept_without_a_copy():
    arr = np.random.default_rng(4).random((9, 11, 3)).astype(np.float32)
    image = _image(arr)
    assert image.img_data is arr
    assert torch.equal(image.device_tensor("cpu"), torch.from_numpy(arr))
    assert _widens() is None


def test_float64_input_is_widened_at_once():
    arr = np.random.default_rng(5).random((9, 11, 3))
    image = _image(arr)
    assert image._data is not None and image._data.dtype == np.float32
    np.testing.assert_array_equal(image.img_data, arr.astype(np.float32))
    assert _widens() is None


def test_raw_data_beside_float32_data_is_what_crosses():
    raw = _arr(np.uint16, seed=6)
    data = np.asarray(raw, np.float32)
    image = Image(data, None, [1, 0, 0, -1, 0, 0], Affine.identity(),
                  raw_data=raw)
    assert image.img_data is data
    assert torch.equal(image.device_tensor("cpu"), torch.from_numpy(data))
    assert _widens() is None
