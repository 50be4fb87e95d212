"""The readers of the image layer's counters (``metrics/image_widens.py``
and ``metrics/image_uploads.py``) on hand-made contexts."""
import pytest

from benchmark import harness

COUNTER_METRICS = {"image_widens": "image.widen",
                   "image_uploads": "image.uploads"}


@pytest.mark.parametrize("metric", sorted(COUNTER_METRICS))
def test_counter_reader_gives_the_mean_a_scene(metric):
    read = harness.metric_reader(metric)
    counter = COUNTER_METRICS[metric]
    assert read({"stages": {counter: {"total": 14}}, "stage_scenes": 4}) \
        == pytest.approx(3.5)
    # a counter the program registered and never raised reads 0
    assert read({"stages": {counter: {"total": 0}}, "stage_scenes": 4}) \
        == 0.0
    # a program without the counter, or a run with no scenes, reads nothing
    assert read({"stages": {}, "stage_scenes": 4}) is None
    assert read({"stages": {counter: {"total": 14}}, "stage_scenes": 0}) \
        is None
