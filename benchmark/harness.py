"""One run of one cell: what ``run.py`` does once it has a card.

Everything of a configuration, a traffic mix or a per-layer metric is a
file of its own, found by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json`` (the entry's ``file``): the configuration and
  the name of its ``driver``, ``drivers/<driver>.py``, whose ``Driver``
  class runs the cell's set-up, window, traced run and check;
- ``traffic/<traffic>.json``: the traffic mix the driver reads;
- ``limits/<cell>.json``: the limit of each number the check compares;
- ``metrics/<metric>.py``: a per-layer metric's reader, ``read(ctx)``,
  which returns a number or None where it finds nothing to read.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "obia_tpu", "obia")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell(bench: dict, name: str) -> dict:
    """The cell ``name`` of ``BENCHMARK.json``, loaded
    (:func:`load_cell`)."""
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"]
                 if c["name"] == found[0]["config"])
    return load_cell(found[0], entry["file"])


def load_cell(workload: dict, config_file: str) -> dict:
    """A workload entry with its configuration (``config_file``, relative
    to the repository's root), traffic and limits loaded."""
    w = dict(workload)
    w["config_data"] = load_json(os.path.join(ROOT, config_file))
    w["traffic_data"] = load_json(os.path.join(HERE, "traffic",
                                               w["traffic"] + ".json"))
    w["limits"] = load_json(os.path.join(HERE, "limits",
                                         w["name"] + ".json"))
    return w


def applies(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver_class(config: dict):
    return importlib.import_module(
        f"benchmark.drivers.{config['driver']}").Driver


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the run must not load."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def _finite(x: float) -> float:
    return x if math.isfinite(x) else 1e308


def run(bench: dict, w: dict, seed: int, seconds: float, trace: int,
        device, t_start: float) -> tuple:
    """Set-up, the window (or the traced run), the check: (result line,
    the lines for standard error)."""
    import torch

    name = w["name"]
    config = w["config_data"]
    drv = driver_class(config)(config, w["traffic_data"], seed, device)
    drv.setup()
    setup_s = time.perf_counter() - t_start
    on_card = torch.device(device).type == "cuda"
    dev_info = {"platform": "gpu" if on_card else "cpu",
                "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                "count": int(w["chips"])}
    metrics = {}
    out = {}
    if trace:
        ctx = drv.traced()
        tr = ctx["trace"]
        for m in bench["per_layer"]:
            if applies(m, name):
                v = metric_reader(m["name"])(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev_info["busy_s"] = tr.busy_s()
        dev_info["window_s"] = tr.window_s()
        out["breakdown"] = {"device_ops": tr.top_ops(),
                            "idle_gaps": tr.idle_gaps()}
    else:
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        vals = drv.window(seconds)
        vals["setup_s"] = setup_s
        if on_card:
            vals["peak_device_gib"] = torch.cuda.max_memory_allocated() / 2**30
        for m in bench["end_to_end"]:
            if applies(m, name) and m["name"] in vals:
                metrics[m["name"]] = {"value": vals[m["name"]],
                                      "unit": m["unit"]}
    dev_info["memory_peak_bytes"] = (int(torch.cuda.max_memory_allocated())
                                     if on_card else 0)
    drv.release()
    numbers = drv.check()
    from benchmark.reference.compare import verdict
    correct = (drv.attempted > 0 and drv.failed == 0
               and verdict(numbers, w["limits"]))
    checks = {k: {"value": _finite(numbers[k]) if k in numbers else None,
                  "limit": lim} for k, lim in w["limits"].items()}
    result = {"correct": bool(correct), "attempted": drv.attempted,
              "failed": drv.failed, "metrics": metrics, "device": dev_info,
              **out, "card": card_line() if on_card else "cpu",
              "checks": checks}
    lines = [f"check {k} {c['value']} limit {c['limit']}"
             for k, c in checks.items()]
    return result, lines
