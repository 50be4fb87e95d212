"""``Image.device_tensor`` keeps one upload a device: a device named with
or without its index (``cpu`` and ``cpu:0``, ``cuda`` and ``cuda:0``) is
one cache entry, counted once as ``image.uploads``."""
import numpy as np
import pytest
import torch

from obia_tpu_torch import telemetry
from obia_tpu_torch.geometry.affine import Affine
from obia_tpu_torch.handlers.geotif import image_from_array


def _image():
    arr = np.random.default_rng(0).integers(0, 256, (17, 19, 3),
                                            dtype=np.uint8)
    return arr, image_from_array(arr, Affine(1, 0, 0, 0, -1, 17))


def _uploads_of(names):
    telemetry.reset()
    try:
        arr, image = _image()
        tensors = [image.device_tensor(n) for n in names]
        return arr, tensors, telemetry.counters().get("image.uploads")
    finally:
        telemetry.reset()


def test_cpu_with_and_without_its_index_is_one_upload():
    arr, (a, b, c), uploads = _uploads_of([torch.device("cpu"), "cpu:0",
                                           "cpu"])
    assert a is b is c and uploads == 1
    assert torch.equal(a, torch.from_numpy(np.asarray(arr, np.float32)))


@pytest.mark.cuda
def test_cuda_with_and_without_its_index_is_one_upload():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    index = torch.cuda.current_device()
    arr, (a, b), uploads = _uploads_of(["cuda", f"cuda:{index}"])
    assert a is b and uploads == 1
    assert a.device == torch.device("cuda", index)
    assert torch.equal(a.cpu(), torch.from_numpy(np.asarray(arr,
                                                            np.float32)))
