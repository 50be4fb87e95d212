"""The readers of SLIC's k-means loop (``metrics/slic_iterate_ms.py``, the
stage ``slic.iterate``, and ``metrics/slic_kernel_launches.py``, the counter
``kernel.slic_pass``) on hand-made contexts."""
import pytest

from benchmark import harness


def test_slic_iterate_ms_is_the_stage_mean_a_scene():
    read = harness.metric_reader("slic_iterate_ms")
    rec = {"count": 4, "total_s": 0.12, "mean_s": 0.03, "last_s": 0.03}
    assert read({"stages": {"slic.iterate": rec}, "stage_scenes": 2}) \
        == pytest.approx(60.0)
    assert read({"stages": {}, "stage_scenes": 2}) is None
    assert read({"stages": {"slic.iterate": rec}, "stage_scenes": 0}) is None


def test_slic_kernel_launches_is_the_counter_mean_a_scene():
    read = harness.metric_reader("slic_kernel_launches")
    ctx = {"stages": {"kernel.slic_pass": {"total": 88}}, "stage_scenes": 8}
    assert read(ctx) == pytest.approx(11.0)
    # a parent without the kernel has no counter: the metric reads nothing
    assert read({"stages": {"slic.iterate": {"total_s": 1.0}},
                 "stage_scenes": 8}) is None
    assert read({"stages": {"kernel.slic_pass": {"total": 88}},
                 "stage_scenes": 0}) is None


@pytest.mark.parametrize("name", ["slic_iterate_ms", "slic_kernel_launches"])
def test_entries_read_the_segmentation_layer_of_both_c4_cells(name):
    bench = harness.load_benchmark()
    entry = next(m for m in bench["per_layer"] if m["name"] == name)
    assert entry["layer"] == "segmentation"
    assert entry["moves"] == "scene_mp_per_s"
    assert entry["workloads"] == ["c4-northstar-100mp", "c4-tiles-1024"]
