"""The detector's counters: ``detect.candidates`` counts the boxes that pass
the score filter and ``detect.kept`` those NMS keeps, each read 0 (not
absent) for a raster with none, on the CPU at a small width."""
import numpy as np
import pytest
import torch

from obia_tpu_torch import telemetry
from obia_tpu_torch.detection import build_detection_model
from obia_tpu_torch.detection.predict import infer_image_array

SMALL = dict(num_classes=2, in_channels=3, backbone_width=8,
             fpn_channels=32, stage_sizes=(1, 1, 1, 1))


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two threads a worker: the suite runs in parallel workers, and
    convolutions on every core of each slow all of them down."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return build_detection_model(seed=3, device="cpu", **SMALL)


@pytest.mark.parametrize("quantile", [0.0, 0.5, 0.99, None],
                         ids=["every-anchor", "half", "top-1pct", "none"])
def test_counts_equal_the_arrays(model, quantile):
    img = np.random.default_rng(5).integers(0, 256, (200, 160, 3),
                                            dtype=np.uint8)
    heads = []
    hook = model.RetinaNetHead_0.register_forward_hook(
        lambda m, i, o: heads.append(o[0][0]))
    try:
        infer_image_array(model, img, 2.0, 0.5)
        scores = torch.sigmoid(heads[0][:, 1])
        threshold = (2.0 if quantile is None else
                     float(torch.quantile(scores, quantile)))
        telemetry.reset()
        out = infer_image_array(model, img, threshold, 0.5)
    finally:
        hook.remove()
    counted = telemetry.counters()
    assert counted["detect.candidates"] == int((scores >= threshold).sum())
    assert counted["detect.kept"] == len(out["boxes"]) == len(out["scores"])
    if quantile is None:
        assert counted == {"detect.candidates": 0, "detect.kept": 0}
    else:
        assert 0 < counted["detect.kept"] <= counted["detect.candidates"]


def test_counts_add_up_over_rasters(model):
    img = np.random.default_rng(6).integers(0, 256, (128, 128, 3),
                                            dtype=np.uint8)
    telemetry.reset()
    first = infer_image_array(model, img, 0.0, 0.5)
    once = telemetry.counters()
    infer_image_array(model, img, 0.0, 0.5)
    assert telemetry.counters() == {k: 2 * v for k, v in once.items()}
    assert once["detect.kept"] == len(first["boxes"]) == 300
