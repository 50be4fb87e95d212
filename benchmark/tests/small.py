"""Cells of the benchmark at sizes a CPU test run holds."""
import copy

from benchmark import harness

SIZES = {"c4-northstar-100mp": (128, {"n_segments": 40}),
         "c4-tiles-1024": (128, {"n_segments": 40}),
         "c2-quickshift-1024": (64, {})}
# a cell whose files are here but which BENCHMARK.json does not run
LATER = {"c2-quickshift-1024": (
    {"name": "c2-quickshift-1024", "config": "quickshift-mlp-rgb",
     "traffic": "scenes-1024", "chips": 1},
    "benchmark/configs/quickshift-mlp-rgb.json")}


def small_cell(name: str) -> dict:
    """The cell ``name`` (of BENCHMARK.json, or one of :data:`LATER`),
    with its scenes cut to a test's size: 3 scenes, 1 traced a part, 2
    checked."""
    if name in LATER:
        w = harness.load_cell(*LATER[name])
    else:
        w = copy.deepcopy(harness.cell(harness.load_benchmark(), name))
    side, seg = SIZES[name]
    w["config_data"]["segment"].update(seg)
    w["traffic_data"] = {"scene": {"side": side, "pool": 3},
                         "trace": {"stage_scenes": 1, "profile_scenes": 1},
                         "check": {"scenes": 2}}
    return w


def run_small(name: str, trace: int = 0, seed: int = 2 ** 31 + 5):
    """(result line, stderr lines) of a run of the small cell on the CPU,
    past the harness's look for a card."""
    import time
    bench = harness.load_benchmark()
    w = small_cell(name)
    if name in LATER:
        bench = dict(bench, per_layer=[dict(m, workloads=[name])
                                       for m in bench["per_layer"]],
                     end_to_end=[m for m in bench["end_to_end"]
                                 if "workloads" not in m])
    return harness.run(bench, w, seed, 0.5, trace, "cpu",
                       time.perf_counter())
