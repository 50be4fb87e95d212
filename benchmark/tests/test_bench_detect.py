"""The detector's cell, ``det-predict-4096``: its entries sit at the end of
``BENCHMARK.json``'s lists and keep the contract, a small copy (256^2 x 8
rasters, a width-cut model, 2 scenes) runs through the harness on the CPU
and is correct, its readers read, faults in the timed path and the
bfloat16 reference in the program's place come out not correct, and the
roofline counts what a hand count gives."""
import copy
import importlib
import time

import pytest

import test_bench_contract as contract
from benchmark import harness
from benchmark.reference import retinanet as ref
from benchmark.roofline import FP32_OPS_PER_MS, HBM_BYTES_PER_MS
from benchmark.roofline import retinanet as roofline
from test_bench_contract import check_cell

CELL = "det-predict-4096"
CUT = {"backbone_width": 8, "stage_sizes": [1, 1, 1, 1], "fpn_channels": 32}
READERS = ("detect_read_ms", "detect_scale_ms", "detect_forward_ms",
           "detect_decode_ms", "detect_nms_ms", "detect_candidates")
SEED = 2 ** 31 + 5


def bench() -> dict:
    return harness.load_benchmark()


@pytest.mark.parametrize("check", [
    "test_top_level_keys", "test_run_seconds_fit_a_full_check",
    "test_names_and_units", "test_configs", "test_workloads",
    "test_metrics", "test_every_file_found_by_name", "test_bounds_named"])
def test_appended_entries_keep_the_contract(check):
    getattr(contract, check)(bench())


def test_entries_sit_at_the_end_of_their_lists():
    b = bench()
    assert b["configs"][-1]["name"] == "retinanet-r50-fpn-8band"
    assert b["workloads"][-1]["name"] == CELL
    assert b["workloads"][-1]["chips"] == 1
    own = [m for m in b["per_layer"] if m.get("workloads") == [CELL]]
    assert own == b["per_layer"][-len(own):]
    assert {m["name"] for m in own} == set(READERS) | {
        "detect_forward_roofline"}
    # the device's idle shares read the cell's trace as the c4 cells' do
    for name in ("device_idle_pct", "idle_unspanned_pct"):
        m = next(m for m in b["per_layer"] if m["name"] == name)
        assert m["workloads"][-1] == CELL


def small_cell() -> dict:
    w = copy.deepcopy(harness.cell(bench(), CELL))
    w["config_data"]["model"].update(CUT)
    w["traffic_data"] = {"scene": {"side": 256, "pool": 2},
                         "trace": {"stage_scenes": 1, "profile_scenes": 1},
                         "check": {"scenes": 2}}
    return w


def run_small(trace: int = 0, seed: int = SEED):
    return harness.run(bench(), small_cell(), seed, 0.5,
                       trace, "cpu", time.perf_counter())


def test_contract_takes_the_cell():
    cell = harness.cell(bench(), CELL)
    check_cell(cell)
    assert cell["config_data"]["reduced"] == []
    D = harness.driver_class(cell["config_data"])
    assert set(D.REQUIRED) == {"logit_gap", "delta_gap", "kept_mismatch"}
    assert set(cell["limits"]) == set(D.NUMBERS) == set(ref.NUMBERS)
    assert cell["limits"]["kept_mismatch"] == 0


@pytest.mark.parametrize("trace", [0, 1])
def test_small_run_is_correct(trace):
    res, lines = run_small(trace)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 2
    assert res["checks"]["kept_mismatch"]["value"] == 0
    assert lines[-1].startswith("check ")
    if trace:
        for name in READERS:
            assert res["metrics"][name]["value"] > 0, name
        # nor the idle shares: the CPU's trace holds no device operation
        assert not {"device_idle_pct", "idle_unspanned_pct"} & \
            set(res["metrics"])
        # no device on the CPU: the roofline has nothing to read
        assert "detect_forward_roofline" not in res["metrics"]
    else:
        assert set(res["metrics"]) == {"scene_mp_per_s", "setup_s"}


def _wrong(name):
    res, lines = run_small()
    assert not res["correct"], res["checks"]
    c = res["checks"][name]
    assert c["value"] > c["limit"], res["checks"]


def _predict_module():
    # the package exports a function ``predict`` over the module's name
    return importlib.import_module("obia_tpu_torch.detection.predict")


def test_a_kept_box_dropped(monkeypatch):
    predict = _predict_module()
    real = predict.nms_numpy
    monkeypatch.setattr(predict, "nms_numpy",
                        lambda *a, **k: real(*a, **k)[1:])
    _wrong("kept_mismatch")


def test_a_logit_perturbed(monkeypatch):
    from obia_tpu_torch.detection.models import RetinaNetHead
    real = RetinaNetHead.forward

    def perturbed(self, feats):
        logits, deltas = real(self, feats)
        logits = logits.clone()
        logits[0, 0, 1] *= 1.01
        return logits, deltas
    monkeypatch.setattr(RetinaNetHead, "forward", perturbed)
    _wrong("logit_gap")


def test_a_box_moved(monkeypatch):
    predict = _predict_module()
    real = predict.decode_boxes
    monkeypatch.setattr(predict, "decode_boxes",
                        lambda a, d: real(a, d) + 0.25)
    _wrong("box_gap")


@pytest.mark.parametrize("name", ["bfloat16"])
def test_control_is_not_correct(name):
    """The reference in bfloat16 in the program's place. (The TF32
    control needs the card: on the CPU TF32 changes nothing.)"""
    from benchmark.drivers.detect_stream import Driver
    from benchmark.reference.compare import verdict
    w = small_cell()
    drv = Driver(w["config_data"], w["traffic_data"], SEED, "cpu")
    drv.setup()
    try:
        scene, model = drv.scenes[0], w["config_data"]["model"]
        weights = drv.weights
        out, heads = ref.control(scene, weights, model, drv.predict, "cpu",
                                 name)
        nums = ref.judge(out, heads, scene, weights, model, drv.predict)
    finally:
        drv.release()
    assert not verdict(nums, w["limits"]), nums
    assert nums["logit_gap"] > w["limits"]["logit_gap"]


def test_calibration():
    """On its own scene, the model the driver builds spreads its box
    deltas as the configuration says and its threshold passes its share;
    it holds the reference's weights."""
    import torch

    from benchmark.drivers.detect_stream import build_model
    from benchmark.scenes import make_scene, scene_seeds
    from obia_tpu_torch.detection.predict import scale_to_uint8

    config = small_cell()["config_data"]
    model, weights, threshold = build_model(config, 4, 256, "cpu")
    assert not model.training
    for k, v in model.state_dict().items():
        assert torch.equal(v, weights[k]), k
    scene = make_scene(256, 8, scene_seeds(4, 2, stream=3)[1], "cpu")
    x = ref.padded_input(scale_to_uint8(scene, "cpu"), "cpu")
    with torch.no_grad():
        logits, deltas = (t[0] for t in model(x))
    cal = config["calibration"]
    assert deltas.std(dim=0).tolist() == pytest.approx(cal["box_delta_std"],
                                                       rel=1e-3)
    passed = float((torch.sigmoid(logits[:, 1]) >= threshold).float().mean())
    assert passed == pytest.approx(cal["candidate_share"], rel=0.02)


def test_weights_owe_nothing_to_the_program(monkeypatch):
    """The weights and the threshold are the reference's: the port's own
    initialisation, made to draw something else, changes neither."""
    import torch

    from benchmark.drivers.detect_stream import build_model
    from obia_tpu_torch.detection import models

    config = small_cell()["config_data"]
    _, weights, threshold = build_model(config, 6, 128, "cpu")

    def other(model, seed):
        with torch.no_grad():
            for p in model.parameters():
                p.fill_(0.5)
    monkeypatch.setattr(models, "init_flax_like", other)
    _, again, threshold_again = build_model(config, 6, 128, "cpu")
    assert threshold_again == threshold
    assert all(torch.equal(weights[k], again[k]) for k in weights)


# -- the readers -----------------------------------------------------------

STAGES = {"detect_read_ms": "detect.read", "detect_scale_ms": "detect.scale",
          "detect_forward_ms": "detect.forward",
          "detect_decode_ms": "detect.decode", "detect_nms_ms": "detect.nms"}


@pytest.mark.parametrize("metric", sorted(STAGES))
def test_stage_reader(metric):
    read = harness.metric_reader(metric)
    rec = {"count": 4, "total_s": 1.2, "mean_s": 0.3, "last_s": 0.3}
    assert read({"stages": {STAGES[metric]: rec}, "stage_scenes": 4}) \
        == pytest.approx(300.0)
    assert read({"stages": {}, "stage_scenes": 4}) is None
    assert read({"trace": None}) is None


def test_candidates_reader():
    read = harness.metric_reader("detect_candidates")
    ctx = {"stages": {"detect.candidates": {"total": 62000}},
           "stage_scenes": 2}
    assert read(ctx) == pytest.approx(31000.0)
    assert read({"stages": {}, "stage_scenes": 2}) is None


SCENE = {"H": 4096, "W": 4096, "in_channels": 8, "backbone_width": 64,
         "stage_sizes": [3, 4, 6, 3], "fpn_channels": 256,
         "num_classes": 2}


def test_roofline_reader():
    read = harness.metric_reader("detect_forward_roofline")
    bound = roofline.bound_ms(SCENE)
    ctx = {"forward_s": 2 * 4 * bound / 1000.0,
           "traced_scenes": [SCENE, SCENE]}
    assert read(ctx) == pytest.approx(25.0)
    assert read({"trace": None}) is None
    assert read(dict(ctx, forward_s=None)) is None


# -- the roofline's counts -------------------------------------------------

def test_resnet50_backbone_by_hand():
    """ResNet-50 at 224^2 on RGB: 4.09 G multiply-adds in its
    convolutions (torchvision's 4.09 GFLOPS counts the 2 M of the
    classifier's fully connected layer too), 118 M of them in the stem."""
    s = dict(SCENE, H=224, W=224, in_channels=3)
    assert roofline.macs(s, "backbone") == pytest.approx(4.09e9, rel=0.005)
    stem = roofline.convs(s)[0]
    assert stem == ("backbone", 3, 64, 7, 112, 112, 4)
    assert 7 * 7 * 3 * 64 * 112 * 112 == 118_013_952


def test_cell_counts():
    # P3-P7 of 4096^2: 512^2 + ... + 32^2 cells, 9 anchors each
    assert roofline.anchors(SCENE) == 9 * sum(
        (4096 // s) ** 2 for s in (8, 16, 32, 64, 128)) == 3_142_656
    # the heads: 8 convolutions of 256 to 256, then 18 and 36 outputs,
    # 3x3, at every cell
    per_cell = 8 * 256 * 256 * 9 + 256 * 9 * (18 + 36)
    assert roofline.macs(SCENE, "head") == per_cell * 3_142_656 // 9
    assert roofline.params(SCENE) == 36_419_382
    flops = 2 * roofline.macs(SCENE)
    assert roofline.bound_ms(SCENE) == pytest.approx(flops / FP32_OPS_PER_MS)
    assert roofline.call_bytes(SCENE) / HBM_BYTES_PER_MS < 0.01 * \
        roofline.bound_ms(SCENE)


def test_params_are_the_models():
    from obia_tpu_torch.detection.models import DetectionModel
    for arch in ({}, CUT):
        model = DetectionModel(2, 8, **{k: tuple(v) if isinstance(v, list)
                                        else v for k, v in arch.items()})
        n = sum(p.numel() for p in model.parameters()) + \
            sum(b.numel() for b in model.buffers())
        assert roofline.params(dict(SCENE, **arch)) == n


class _Event:
    def __init__(self, name, start, end, dev, note=False):
        self._n, self._s, self._d = name, start, end - start
        self._dev, self._note = dev, note

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"

    def is_user_annotation(self):
        return self._note


EVENTS = [_Event("detect.forward", 100, 200, False, note=True),
          _Event("detect.forward", 150, 180, True, note=True),
          _Event("conv", 150, 170, True),
          _Event("relu", 175, 180, True),
          _Event("sigmoid", 310, 330, True)]


def test_forward_device_time():
    assert roofline.forward_device_s(EVENTS, 0, 1000) == pytest.approx(25e-9)
    assert roofline.forward_device_s(EVENTS, 400, 1000) is None
    # the host's range alone attributes nothing
    assert roofline.forward_device_s(EVENTS[:1] + EVENTS[2:], 0, 1000) \
        is None


def test_idle_shares_read_the_detectors_trace(monkeypatch):
    """The device's idle shares read the detector's traced run as they read
    the scene stream's: here a stand-in for the card runs one kernel for
    each host ``detect.forward`` range, so the card is idle outside the
    forward passes, and the program's spans cover some of that idle."""
    from benchmark import trace

    real = trace.device_events

    def with_card(prof):
        events = real(prof)
        return events + [
            _Event("conv", e.start_ns(), e.start_ns() + e.duration_ns(), True)
            for e in events
            if e.name() == "detect.forward" and trace._annotation(e)]
    monkeypatch.setattr(trace, "device_events", with_card)
    res, _ = run_small(1)
    assert res["correct"], res["checks"]
    idle = res["metrics"]["device_idle_pct"]["value"]
    assert idle == pytest.approx(
        100.0 * (1 - res["device"]["busy_s"] / res["device"]["window_s"]))
    assert 0 < idle < 100
    assert 0 <= res["metrics"]["idle_unspanned_pct"]["value"] < 100


def test_small_run_repeats_on_its_seed():
    a, _ = run_small(1)
    b, _ = run_small(1)
    assert a["checks"] == b["checks"]
    assert a["metrics"]["detect_candidates"] == \
        b["metrics"]["detect_candidates"]
