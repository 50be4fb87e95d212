"""A cell of a second driver, with check numbers of its own, keeps to the
contract and runs through the harness, by new files alone: a
configuration naming the driver, a traffic mix and the cell's limits.

The driver here is a stand-in for a detector over a stream of 4096^2
scenes; it is reached as ``benchmark.drivers.toy_detect`` through
``sys.modules`` and returns the numbers its configuration lists."""
import json
import sys
import time
import types

import pytest

from benchmark import harness
from test_bench_contract import check_cell

CELL = "det-predict-4096"
LIMITS = {"box_gap": 1e-3, "score_gap": 1e-3, "kept_mismatch": 0}


class ToyDetector:
    """Set-up, window, traced run and check of a detector's cell, with none
    of the scene stream's numbers."""

    NUMBERS = ("box_gap", "score_gap", "kept_mismatch")
    REQUIRED = ("box_gap", "kept_mismatch")

    def __init__(self, config: dict, workload: dict, seed: int, device):
        self.config = config
        self.workload = workload
        self.attempted = 0
        self.failed = 0

    def setup(self) -> None:
        pass

    def window(self, seconds: float) -> dict:
        self.attempted += 2
        side = self.workload["scene"]["side"]
        return {"scene_mp_per_s": 2 * side * side / 1e6 / seconds}

    def traced(self) -> dict:
        self.attempted += 1
        return {"trace": types.SimpleNamespace(
            busy_s=lambda: 0.25, window_s=lambda: 1.0,
            top_ops=lambda: [["forward", 0.25]],
            idle_gaps=lambda: [["nms", 0.75]])}

    def release(self) -> None:
        pass

    def check(self) -> dict:
        return dict(self.config["numbers"])


@pytest.fixture
def toy(monkeypatch, tmp_path):
    """The toy driver importable by name, and a benchmark folder in
    ``tmp_path`` holding the cell's traffic and limits files; returns a
    function that loads the cell with the given limits and numbers."""
    mod = types.ModuleType("benchmark.drivers.toy_detect")
    mod.Driver = ToyDetector
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    for sub in ("configs", "traffic", "limits"):
        (tmp_path / sub).mkdir()
    (tmp_path / "traffic" / "scenes-4096.json").write_text(json.dumps(
        {"scene": {"side": 4096, "pool": 2},
         "trace": {"stage_scenes": 1, "profile_scenes": 1},
         "check": {"scenes": 1}}))
    monkeypatch.setattr(harness, "HERE", str(tmp_path))
    workload = {"name": CELL, "config": "retinanet-r50-fpn-8band",
                "traffic": "scenes-4096", "chips": 1}

    def load(limits: dict, numbers: dict) -> dict:
        config = tmp_path / "configs" / "retinanet-r50-fpn-8band.json"
        config.write_text(json.dumps(
            {"name": workload["config"], "driver": "toy_detect",
             "reduced": [], "numbers": numbers}))
        (tmp_path / "limits" / f"{CELL}.json").write_text(
            json.dumps(limits))
        return harness.load_cell(workload, str(config))
    return load


def test_contract_takes_the_cell(toy):
    cell = toy(LIMITS, {})
    assert harness.driver_class(cell["config_data"]) is ToyDetector
    check_cell(cell)


@pytest.mark.parametrize("limits", [
    {"score_gap": 1e-3, "kept_mismatch": 0},            # lacks box_gap
    {"box_gap": 1e-3, "score_gap": 1e-3},               # lacks kept_mismatch
    dict(LIMITS, label_mismatch=0.01),                  # not the driver's
    dict(LIMITS, iou_gap=1e-3),                         # declared by none
], ids=["no-box_gap", "no-kept_mismatch", "segmentation-number",
        "undeclared"])
def test_contract_refuses_the_limits(toy, limits):
    with pytest.raises(AssertionError):
        check_cell(toy(limits, {}))


@pytest.mark.parametrize("required", [(), ("box_gap", "nms_gap")],
                         ids=["none-required", "required-undeclared"])
def test_contract_refuses_the_driver(toy, monkeypatch, required):
    monkeypatch.setattr(ToyDetector, "REQUIRED", required)
    with pytest.raises(AssertionError):
        check_cell(toy(LIMITS, {}))


def test_scene_stream_cell_may_not_name_a_detectors_number():
    bench = harness.load_benchmark()
    cell = harness.cell(bench, bench["workloads"][0]["name"])
    cell["limits"] = dict(cell["limits"], box_gap=1e-3)
    with pytest.raises(AssertionError):
        check_cell(cell)


GOOD = {"box_gap": 2e-4, "score_gap": 5e-4, "kept_mismatch": 0}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("numbers,correct", [
    (GOOD, True),
    (dict(GOOD, box_gap=2e-3), False),                  # over its limit
    (dict(GOOD, kept_mismatch=1), False),               # exact, over
    ({"box_gap": 2e-4, "score_gap": 5e-4}, False),      # one missing
], ids=["within", "box_gap-over", "kept_mismatch-over", "missing"])
def test_harness_runs_the_cell(toy, trace, numbers, correct):
    cell = toy(LIMITS, numbers)
    res, lines = harness.run(harness.load_benchmark(), cell, 2 ** 31 + 7,
                             0.5, trace, "cpu", time.perf_counter())
    assert res["correct"] is correct, res["checks"]
    assert list(res)[-1] == "checks"
    assert list(res["checks"]) == list(LIMITS)
    for name, c in res["checks"].items():
        assert c["limit"] == LIMITS[name]
        assert c["value"] == numbers.get(name)
    assert lines == [f"check {k} {c['value']} limit {c['limit']}"
                     for k, c in res["checks"].items()]
    if trace:
        assert res["device"]["busy_s"] == 0.25
        assert res["breakdown"]["device_ops"] == [["forward", 0.25]]
    else:
        assert set(res["metrics"]) == {"scene_mp_per_s", "setup_s"}
