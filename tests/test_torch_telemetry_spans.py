"""The port's span log and counters (``obia_tpu_torch.telemetry``): spans
on the profiler's clock with their parent, root and thread, the bounded
log, ``record_function`` ranges under a recording profiler, nothing taken
with the telemetry off and no profiler, and the counter registry (kernel
launches, CCL and merge sweeps) in ``report()``."""
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from obia_tpu_torch import telemetry
from obia_tpu_torch.geometry.affine import Affine
from obia_tpu_torch.handlers.geotif import image_from_array

MAIN = threading.main_thread().native_id


@pytest.fixture
def on():
    """The telemetry reset and on for the test, off and reset after it."""
    telemetry.reset()
    telemetry.enable(True)
    try:
        yield
    finally:
        telemetry.enable(False)
        telemetry.reset()


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def _small_image(seed: int = 3, side: int = 48, bands: int = 3):
    arr = (np.random.default_rng(seed).random((side, side, bands))
           * 255).astype(np.uint8)
    return image_from_array(arr, Affine(1.0, 0, 0, 0, -1.0, side))


def test_span_name_parent_thread_and_root(on, capsys):
    with telemetry.stage("outer"):
        with telemetry.stage("inner"):
            pass
        with telemetry.stage("second", host_only=True):
            pass
    with telemetry.stage("alone"):
        pass
    got = _by_name(telemetry.spans())
    outer, inner = got["outer"][0], got["inner"][0]
    second, alone = got["second"][0], got["alone"][0]
    assert outer.parent is None and outer.root == outer.id
    assert inner.parent == outer.id and second.parent == outer.id
    assert inner.root == second.root == outer.id
    assert alone.parent is None and alone.root == alone.id != outer.id
    assert {s.thread for s in telemetry.spans()} == {MAIN}
    assert outer.start_ns <= inner.start_ns <= inner.end_ns \
        <= second.start_ns <= second.end_ns <= outer.end_ns
    # the log is in the order the spans ended
    assert [s.name for s in telemetry.spans()] == ["inner", "second",
                                                   "outer", "alone"]
    assert "[obia_tpu_torch] outer:" in capsys.readouterr().out


def test_a_failed_synchronise_still_closes_the_span(on, monkeypatch,
                                                    capsys):
    """A device fault that surfaces in the stage's closing synchronise
    propagates, and the span is closed all the same: logged, and no longer
    the parent of the spans that follow."""
    real_sync = telemetry.sync
    calls = []

    def sync(x=None):
        calls.append(1)
        if len(calls) == 2:  # the stage's closing synchronise
            raise RuntimeError("device fault")
        return real_sync(x)

    monkeypatch.setattr(telemetry, "sync", sync)
    with pytest.raises(RuntimeError, match="device fault"):
        with telemetry.stage("faulted"):
            pass
    monkeypatch.setattr(telemetry, "sync", real_sync)
    with telemetry.stage("after"):
        pass
    got = _by_name(telemetry.spans())
    faulted, after = got["faulted"][0], got["after"][0]
    assert faulted.end_ns >= faulted.start_ns
    assert after.parent is None and after.root == after.id


def test_spans_on_the_host_wall_clock(on):
    t0 = time.time_ns()
    with telemetry.stage("clock"):
        time.sleep(0.002)
    t1 = time.time_ns()
    (s,) = telemetry.spans()
    assert t0 <= s.start_ns and s.end_ns <= t1
    assert s.end_ns - s.start_ns >= 2_000_000
    assert abs(telemetry.report()["clock"]["total_s"]
               - (s.end_ns - s.start_ns) / 1e9) < 1e-3


def test_polygonizer_thread_span_has_the_submitting_parent(on):
    from obia_tpu_torch.segmentation.segment import segment
    image = _small_image()
    with telemetry.stage("caller"):
        s = segment(image, device="cpu", n_segments=12, compactness=10.0)
        geometry = s.table.geometry
    assert len(geometry) == len(s.table) > 0
    got = _by_name(telemetry.spans())
    caller = got["caller"][0]
    (poly,) = got["segment.polygonize"]
    assert poly.thread != MAIN
    assert poly.parent == caller.id and poly.root == caller.id
    for name in ("segment.kernel", "segment.download", "segment.join",
                 "image.upload", "objects.spectral", "objects.glcm",
                 "glcm.prepass"):
        spans = got[name]
        assert all(x.root == caller.id and x.thread == MAIN for x in spans)
    assert got["segment.kernel"][0].parent == caller.id
    (prepass,) = got["glcm.prepass"]
    (glcm,) = got["objects.glcm"]
    assert prepass.parent == glcm.id
    (join,) = got["segment.join"]
    assert join.parent == caller.id and join.end_ns >= poly.end_ns


def test_image_convert_and_upload_stages(on):
    image = _small_image()
    (conv,) = telemetry.spans()
    assert conv.name == "image.convert"
    image.device_tensor("cpu")
    image.device_tensor("cpu")          # cached: no second upload
    assert [s.name for s in telemetry.spans()] == ["image.convert",
                                                   "image.upload"]
    assert telemetry.report()["image.upload"]["count"] == 1


def test_forest_predict_stage(on):
    from obia_tpu_torch.classification.forest import (ForestArrays,
                                                      forest_proba)
    trees = ForestArrays.from_numpy(
        feature=np.array([[0, -1, -1]]), threshold=np.array([[0.5, 0, 0]]),
        left=np.array([[1, 1, 2]]), right=np.array([[2, 1, 2]]),
        leaf_proba=np.array([[[0.5, 0.5], [1.0, 0.0], [0.0, 1.0]]]),
        classes=np.array([0, 1]), max_depth=1, device="cpu")
    p = forest_proba(trees, torch.tensor([[0.2], [0.9]]))
    assert torch.equal(p, torch.tensor([[1.0, 0.0], [0.0, 1.0]]))
    assert [s.name for s in telemetry.spans()] == ["forest.predict"]


def test_span_log_is_bounded(on, capsys):
    assert telemetry.SPAN_CAPACITY >= 65_536
    n = telemetry.SPAN_CAPACITY + 10
    for _ in range(n):
        with telemetry.stage("tick"):
            pass
    capsys.readouterr()
    spans = telemetry.spans()
    assert len(spans) == telemetry.SPAN_CAPACITY
    assert spans[-1].id - spans[0].id == telemetry.SPAN_CAPACITY - 1
    assert telemetry.report()["tick"]["count"] == n
    telemetry.reset()
    assert telemetry.spans() == []


def test_off_takes_no_time_ns_no_record_function_no_span(monkeypatch):
    telemetry.reset()
    assert not telemetry.is_enabled()

    def boom(*a, **k):
        raise AssertionError("called with the telemetry off")

    monkeypatch.setattr(telemetry.time, "time_ns", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(telemetry, "Span", boom)
    monkeypatch.setattr(telemetry, "_OpenSpan", boom)
    with telemetry.stage("quiet"):
        pass
    monkeypatch.undo()
    assert telemetry.spans() == []
    assert telemetry.report()["quiet"]["count"] == 1
    telemetry.reset()


def test_profiler_with_telemetry_off_records_spans_on_its_clock():
    telemetry.reset()
    assert not telemetry.is_enabled()
    x = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with telemetry.stage("probe.outer"):
            with telemetry.stage("probe.stage"):
                y = x @ x
    assert y.shape == (256, 256)
    got = _by_name(telemetry.spans())
    span = got["probe.stage"][0]
    assert span.parent == got["probe.outer"][0].id
    events = list(prof.profiler.kineto_results.events())
    (mm,) = [e for e in events if e.name() == "aten::mm"]
    start, end = mm.start_ns(), mm.start_ns() + mm.duration_ns()
    assert span.start_ns - 1_000_000 <= start <= end \
        <= span.end_ns + 1_000_000
    marks = [e for e in events if e.name() == "probe.stage"]
    assert len(marks) == 1 and marks[0].is_user_annotation()
    assert marks[0].start_ns() <= start and end <= (
        marks[0].start_ns() + marks[0].duration_ns())
    telemetry.reset()


def test_trace_chrome_file_shows_each_stage(tmp_path):
    telemetry.reset()
    with telemetry.trace(str(tmp_path)):
        with telemetry.stage("traced.stage"):
            torch.ones(8).sum()
    (path,) = tmp_path.iterdir()
    names = {e.get("name") for e in json.loads(path.read_text())[
        "traceEvents"]}
    assert "traced.stage" in names
    assert [s.name for s in telemetry.spans()] == ["traced.stage"]
    telemetry.reset()


def test_counters_in_report_and_cleared_by_reset():
    telemetry.reset()
    telemetry.count("unit.count", 2)
    telemetry.count("unit.count")
    with telemetry.stage("unit.stage"):
        pass
    assert telemetry.counters() == {"unit.count": 3}
    rep = telemetry.report()
    assert rep["unit.count"] == {"total": 3}
    assert rep["unit.stage"]["count"] == 1
    telemetry.reset()
    assert telemetry.counters() == {} and telemetry.report() == {}


def test_counters_lose_no_update_across_threads():
    telemetry.reset()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                telemetry.count("unit.threads")

        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert telemetry.counters()["unit.threads"] == 16 * 2000
    telemetry.reset()


def test_segmentation_counts_its_host_synced_sweeps():
    from obia_tpu_torch.segmentation.segment import segment
    telemetry.reset()
    s = segment(_small_image(5), device="cpu", n_segments=20,
                compactness=10.0)
    assert len(s.table) > 0
    n = telemetry.counters()
    assert n["ccl.sweeps"] >= 1 and n["merge.sweeps"] >= 1
    assert telemetry.report()["ccl.sweeps"] == {"total": n["ccl.sweeps"]}
    # the CPU takes every kernel's twin: no launch counted
    assert not any(k.startswith("kernel.") for k in n)
    again = telemetry.counters()
    telemetry.reset()
    segment(_small_image(5), device="cpu", n_segments=20, compactness=10.0)
    assert telemetry.counters() == again       # the same scene, the same
    telemetry.reset()


def test_bench_launch_keys_read_the_counters():
    from obia_tpu_torch import bench as tbench
    telemetry.reset()
    tbench.reset_launches()
    telemetry.count("kernel.glcm_sums", 3)
    telemetry.count("kernel.qs_parent")
    assert tbench.kernel_launches() == {"glcm_sums": 3, "glcm_hist": 0,
                                        "qs_density": 0, "qs_parent": 1}
    tbench.reset_launches()
    assert not any(tbench.kernel_launches().values())
    telemetry.reset()
