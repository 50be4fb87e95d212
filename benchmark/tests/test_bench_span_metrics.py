"""The readers of the program's spans and counters (``metrics/``) on
hand-made contexts, and ``idle_unspanned_pct`` on a device trace with
known gaps and spans."""
import threading
import time

import pytest

from benchmark import harness
from benchmark.trace import GAP_FLOOR_NS, DeviceTrace

STAGE_METRICS = {"image_convert_ms": "image.convert",
                 "upload_ms": "image.upload",
                 "glcm_prepass_ms": "glcm.prepass",
                 "polygonize_join_ms": "segment.join",
                 "forest_predict_ms": "forest.predict"}
COUNTER_METRICS = {"ccl_sweeps": "ccl.sweeps",
                   "merge_sweeps": "merge.sweeps"}
MAIN = threading.main_thread().native_id


@pytest.mark.parametrize("metric", sorted(STAGE_METRICS))
def test_stage_reader_gives_the_mean_ms_a_scene(metric):
    read = harness.metric_reader(metric)
    stage = STAGE_METRICS[metric]
    rec = {"count": 6, "total_s": 0.9, "mean_s": 0.15, "last_s": 0.1}
    assert read({"stages": {stage: rec}, "stage_scenes": 3}) \
        == pytest.approx(300.0)
    assert read({"stages": {}, "stage_scenes": 3}) is None
    assert read({"stages": {stage: rec}, "stage_scenes": 0}) is None


@pytest.mark.parametrize("metric", sorted(COUNTER_METRICS))
def test_counter_reader_gives_the_mean_a_scene(metric):
    read = harness.metric_reader(metric)
    counter = COUNTER_METRICS[metric]
    assert read({"stages": {counter: {"total": 14}}, "stage_scenes": 4}) \
        == pytest.approx(3.5)
    assert read({"stages": {}, "stage_scenes": 4}) is None


class _Event:
    """A profiler event as ``DeviceTrace`` reads one."""

    def __init__(self, name, start, end, kind="CUDA"):
        self._name, self._start, self._dur = name, start, end - start
        self._kind = kind

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def device_type(self):
        return f"DeviceType.{self._kind}"

    def is_user_annotation(self):
        return False


class _Span:
    def __init__(self, start, end, thread=MAIN):
        self.start_ns, self.end_ns, self.thread = start, end, thread


def _trace():
    """Window [0, 1 ms]; device busy [100, 200], [500, 600], [700, 710],
    [715, 720] us: idle gaps [0, 100], [200, 500], [600, 700], [720, 1000]
    us, and [710, 715] below the floor."""
    us = 1000
    busy = [(100, 200), (500, 600), (700, 710), (715, 720)]
    events = [_Event(f"k{i}", a * us, b * us) for i, (a, b) in
              enumerate(busy)]
    events.append(_Event("aten::mm", 0, 1000 * us, kind="CPU"))
    return DeviceTrace(events, 0, 1000 * us, [])


def test_idle_unspanned_intersects_exactly(monkeypatch):
    from obia_tpu_torch import telemetry
    read = harness.metric_reader("idle_unspanned_pct")
    us = 1000
    assert 5 * us < GAP_FLOOR_NS <= 100 * us
    spans = [_Span(50 * us, 300 * us),      # 50 of gap 1, 100 of gap 2
             _Span(250 * us, 260 * us),     # inside the one before
             _Span(550 * us, 712 * us),     # 100 of gap 3, the short gap
             _Span(990 * us, 2000 * us),    # 10 of gap 4, past the window
             _Span(0, 1000 * us, thread=MAIN + 1),  # another thread
             _Span(-500 * us, -100 * us)]   # before the window
    monkeypatch.setattr(telemetry, "spans", lambda: spans)
    idle = 100 + 300 + 100 + 280
    covered = 50 + 100 + 100 + 10
    assert read({"trace": _trace()}) == pytest.approx(
        100.0 * (idle - covered) / idle)
    monkeypatch.setattr(telemetry, "spans", lambda: [])
    assert read({"trace": _trace()}) == pytest.approx(100.0)
    monkeypatch.setattr(telemetry, "spans",
                        lambda: [_Span(-1, 2000 * us)])
    assert read({"trace": _trace()}) == pytest.approx(0.0)


def test_idle_unspanned_with_a_program_that_logs_no_spans(monkeypatch):
    from obia_tpu_torch import telemetry
    read = harness.metric_reader("idle_unspanned_pct")
    monkeypatch.delattr(telemetry, "spans")
    assert read({"trace": _trace()}) is None
    assert read({"trace": DeviceTrace([], 0, 10, [])}) is None
    assert read({"trace": None}) is None


def test_idle_unspanned_reads_real_spans_on_the_trace_clock():
    """A span the telemetry logs under a profiler, against a trace window
    taken on the same clock: the stage covers the idle around the one
    kernel inside it."""
    from torch.profiler import ProfilerActivity, profile

    from obia_tpu_torch import telemetry
    read = harness.metric_reader("idle_unspanned_pct")
    telemetry.reset()
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        with telemetry.stage("probe.sleep"):
            time.sleep(0.01)
    t1 = time.time_ns()
    try:
        (span,) = telemetry.spans()
        assert span.thread == MAIN and t0 <= span.start_ns < span.end_ns <= t1
        mid = (span.start_ns + span.end_ns) // 2
        tr = DeviceTrace([_Event("k", mid, mid + 1000)], t0, t1, [])
        idle = (t1 - t0) - 1000
        inside = (span.end_ns - span.start_ns) - 1000
        assert read({"trace": tr}) == pytest.approx(
            100.0 * (idle - inside) / idle)
    finally:
        telemetry.reset()
