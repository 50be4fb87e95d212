"""BENCHMARK.json keeps to the benchmark's contract, and every file that a
cell, a configuration or a metric names is found by its name."""
import json
import os
import re

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH_DIR)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
BOUNDS = ("scene_mp_per_s", "tile_s_p90", "peak_device_gib", "setup_s")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536
    assert 1 <= len(bench["command"]) <= 32
    assert all(_line(w) for w in bench["command"])
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51


def test_run_seconds_fit_a_full_check(bench):
    cells = 24
    runs = 2 + 14 * cells
    need = runs * (bench["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert need <= 43200


def test_command_names_only_paths(bench):
    for word in bench["command"][1:]:
        if "/" in word or word.endswith(".py"):
            assert any(word.startswith(p + "/") for p in bench["paths"])


def test_names_and_units(bench):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
    for group in ("configs", "workloads"):
        got = [n for g, n in names if g == group]
        assert len(got) == len(set(got))
    metrics = [n for g, n in names if g in ("end_to_end", "per_layer")]
    assert len(metrics) == len(set(metrics))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")


def test_configs(bench):
    assert 1 <= len(bench["configs"]) <= 24
    files = set()
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["name"] in used
        with open(os.path.join(ROOT, c["file"])) as f:
            data = json.load(f)
        assert data["name"] == c["name"]
        assert data["reduced"] == c["reduced"]


def test_workloads(bench):
    ws = bench["workloads"]
    assert 1 <= len(ws) <= 24
    pairs = [(w["config"], w["traffic"]) for w in ws]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in ws) <= max(1, len(ws) // 4)
    for w in ws:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert NAME.match(w["traffic"])
        assert _line(w["why"])


def test_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and "setup_s" in e2e
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                         "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = [w["name"] for w in bench["workloads"]]
    assert 1 <= len(bench["per_layer"]) <= 128
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                         "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
        assert m["moves"] in e2e
        for c in m.get("workloads", cells):
            moved = e2e[m["moves"]]
            assert c in moved.get("workloads", cells)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for c in cells:
        got = [m for m in bench["end_to_end"]
               if c in m.get("workloads", cells)]
        assert "setup_s" in [m["name"] for m in got] and len(got) >= 2
        assert any(c in m.get("workloads", cells)
                   for m in bench["per_layer"])


def check_cell(cell: dict) -> None:
    """A loaded cell (``harness.load_cell``'s form) keeps to the contract:
    its driver is found by the configuration's name for it, and its limits
    name only numbers that driver's ``check()`` can return, among them
    every number the driver requires of its cells."""
    from benchmark import harness
    assert cell["traffic_data"]["scene"]["side"] > 0
    D = harness.driver_class(cell["config_data"])
    assert D.__name__
    assert D.REQUIRED
    assert set(D.REQUIRED) <= set(D.NUMBERS)
    assert set(D.REQUIRED) <= set(cell["limits"]) <= set(D.NUMBERS)


def test_every_file_found_by_name(bench):
    from benchmark import harness
    for w in bench["workloads"]:
        check_cell(harness.cell(bench, w["name"]))
    for m in bench["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))


def test_scene_stream_holds_its_cells_to_the_same_numbers():
    """A scene-stream cell may limit any number the scene stream's
    reference computes, and is held to the partition, its polygons and
    its features at least."""
    from benchmark.drivers.scene_stream import Driver
    from benchmark.reference import compare
    assert Driver.NUMBERS == compare.NUMBERS
    assert set(Driver.REQUIRED) == {"label_mismatch", "polygon_faults",
                                    "feature_gap"}


def test_file_names_use_name_characters(bench):
    for p in bench["paths"]:
        for dirpath, _, files in os.walk(os.path.join(ROOT, p)):
            if "__pycache__" in dirpath:
                continue
            for f in files:
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
                assert PATH.match(rel), rel


def test_bounds_named(bench):
    assert {m["name"] for m in bench["end_to_end"]} == set(BOUNDS)
