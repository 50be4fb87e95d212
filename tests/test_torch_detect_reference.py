"""The port's detector against the benchmark's plain reference
(``benchmark/reference/retinanet.py``) on the CPU: the forward pass at the
published widths (ResNet-50 (3, 4, 6, 3) at width 64, FPN 256, heads of
256) on a 128^2 and an unpadded 200 x 328 raster, and at a cut width over
three seeds, each with the weights the benchmark's reference draws and
calibrates (its BatchNorm statistics from a train-mode pass) loaded into
the port's model; the reference's decode, filter and NMS of the port's
head outputs against ``infer_image_array``'s kept set, with scores tied
exactly among them too; and the bfloat16 reference, which misses.

Bar: each head output within ``TOL`` of the reference's, as the widest
abs(port - reference) over max(abs(reference), the output's mean
abs(reference)). The port and the reference run the same float32
convolutions; their BatchNorms round differently (rsqrt times the scale
against the scale over sqrt), and a last-bit difference grows through 53
normalised layers to about 1e-5 in the logits and 1e-4 in the deltas
(measured); bfloat16 misses by more than 0.1. The kept sets are equal:
both sides order the same float32 scores by ``np.argsort(-scores)``.
"""
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.drivers.detect_stream import build_model  # noqa: E402
from benchmark.reference import retinanet as ref  # noqa: E402
from benchmark.scenes import make_scene  # noqa: E402
from obia_tpu_torch.detection.predict import (infer_image_array,  # noqa: E402
                                              scale_to_uint8)

TOL = 1e-3
PUBLISHED = dict(num_classes=2, in_channels=8, backbone_width=64,
                 fpn_channels=256, stage_sizes=[3, 4, 6, 3])
CUT = dict(PUBLISHED, backbone_width=8, fpn_channels=32,
           stage_sizes=[1, 1, 1, 1])
PREDICT = {"nms_threshold": 0.5, "max_out": 300}
CALIBRATION = {"candidate_share": 0.01, "box_delta_std": [0.1, 0.1, 0.2, 0.2]}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two threads a worker: the suite runs in parallel workers, and
    convolutions on every core of each slow all of them down."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _config(model):
    return {"model": model, "bands": 8, "calibration": CALIBRATION,
            "predict": PREDICT}


def _built(model, seed):
    torch.manual_seed(0)
    return build_model(_config(model), seed, 256, "cpu")


@pytest.fixture(scope="module")
def published():
    return _built(PUBLISHED, 2 ** 31 + 11)


def _scene(h, w, seed):
    return make_scene(max(h, w), 8, seed, "cpu").numpy()[:h, :w]


def _port(model, scene, threshold):
    """``infer_image_array`` as ``predict`` runs it, with the head's
    outputs."""
    heads = []
    hook = model.RetinaNetHead_0.register_forward_hook(
        lambda m, i, o: heads.append((o[0][0], o[1][0])))
    try:
        out = infer_image_array(model, scale_to_uint8(scene, "cpu"),
                                threshold, PREDICT["nms_threshold"])
    finally:
        hook.remove()
    return out, heads[0]


def _gaps(built, arch, scene, **precision):
    model, weights, threshold = built
    out, (logits, deltas) = _port(model, scene, threshold)
    x = ref.padded_input(ref.scale_to_uint8(scene), "cpu")
    r_logits, r_deltas = ref.forward(weights, x,
                                     arch["stage_sizes"],
                                     arch["num_classes"], **precision)
    assert r_logits.shape == logits.shape and r_deltas.shape == deltas.shape
    return ref.gap(logits, r_logits), ref.gap(deltas, r_deltas)


@pytest.mark.parametrize("hw", [(128, 128), (200, 328)])
def test_published_widths_forward(published, hw):
    gaps = _gaps(published, PUBLISHED, _scene(*hw, 41))
    assert max(gaps) <= TOL, gaps


@pytest.mark.parametrize("seed", [0, 2 ** 32 + 3, 77])
def test_cut_width_forward(seed):
    gaps = _gaps(_built(CUT, seed), CUT, _scene(160, 224, seed + 1))
    assert max(gaps) <= TOL, gaps


def _judge_detections(model, scene, threshold):
    out, (logits, deltas) = _port(model, scene, threshold)
    det = ref.detect(logits, deltas, scene.shape[:2],
                     dict(PREDICT, score_threshold=threshold))
    assert len(det["keep"]) > 0 and float(det["scores"].min()) >= threshold
    det["share"] = len(det["ids"]) / len(logits)
    return ref.kept_numbers(out, det), out, det


@pytest.mark.parametrize("arch,hw", [("published", (256, 256)),
                                     ("published", (200, 328)),
                                     ("cut", (200, 328))])
def test_reference_nms_keeps_the_ports_set(published, arch, hw):
    model, _, threshold = published if arch == "published" else \
        _built(CUT, 5)
    nums, out, det = _judge_detections(model, _scene(*hw, 3), threshold)
    assert nums == {"kept_mismatch": 0, "score_gap": 0.0, "box_gap": 0.0}
    kept = ref.kept(det)
    for k in ("boxes", "scores", "labels"):
        np.testing.assert_array_equal(out[k], kept[k])
    if hw == (256, 256):
        # unpadded, as the cell's rasters: about the calibrated share of
        # the anchors pass, and no score saturates (the zero padding of
        # an unaligned raster lies far outside the calibration's
        # statistics, and saturates the anchors over it)
        assert 0.005 < det["share"] < 0.02
        assert float(det["scores"].max()) < 1.0


def test_tied_scores_keep_the_same_set():
    """Every anchor of one of the 9 kinds scores the same: the class
    output's weights zeroed, its biases three values."""
    model, _, _ = _built(CUT, 9)
    with torch.no_grad():
        head = model.RetinaNetHead_0.cls_out
        head.weight.zero_()
        head.bias.copy_(torch.tensor([-5.0, -1.0, -5.0, -2.0, -5.0, -1.0,
                                      -5.0, -2.0, -5.0, -1.0, -5.0, -2.0,
                                      -5.0, -1.0, -5.0, -2.0, -5.0, -1.0]))
    nums, out, det = _judge_detections(model, _scene(200, 328, 4), 0.1)
    assert len(np.unique(det["scores"])) == 2
    assert len(out["scores"]) == 300
    assert nums == {"kept_mismatch": 0, "score_gap": 0.0, "box_gap": 0.0}


def test_a_dropped_box_is_a_mismatch(published):
    model, _, threshold = published
    nums, out, det = _judge_detections(model, _scene(256, 256, 3),
                                       threshold)
    dropped = {k: v[1:] for k, v in out.items()}
    assert ref.kept_numbers(dropped, det)["kept_mismatch"] == 1


def test_bfloat16_reference_misses(published):
    gaps = _gaps(published, PUBLISHED, _scene(128, 128, 41),
                 dtype=torch.bfloat16)
    assert min(gaps) > 10 * TOL, gaps
