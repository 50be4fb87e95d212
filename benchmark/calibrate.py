"""The readings that the check's limits are set from, at a cell's own size.

    python3 benchmark/calibrate.py --workload <cell> --seeds S1 S2 ...
                                   [--control N]

For each seed, one scene of the cell made as a run makes it, through the
program's timed path, then the comparison's numbers against the reference
(the lower readings); for the first ``N`` seeds also the control, the
reference computed in the nearest precision below the configuration's
(``reference.CONTROL``) put in the program's place, judged by the same
comparison (the upper readings). One JSON line a reading. The benchmark's
own runs never run this.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from benchmark import harness
    from benchmark.reference import CONTROL, compare
    from benchmark.scenes import make_pool

    w = harness.cell(harness.load_benchmark(ROOT), args.workload)
    config = w["config_data"]
    traffic = dict(w["traffic_data"], scene=dict(
        w["traffic_data"]["scene"], pool=1))
    traffic["check"] = {"scenes": 1}
    for i, seed in enumerate(args.seeds):
        drv = harness.driver_class(config)(config, traffic, seed,
                                           args.device)
        arr = make_pool(traffic, int(config["bands"]), seed, args.device)[1]
        t = time.perf_counter()
        drv.run_scene(arr)
        wall = time.perf_counter() - t
        t = time.perf_counter()
        nums = drv.check()
        print(json.dumps({"seed": seed, "kind": "program", "K":
                          drv.kept[0]["K"], "scene_s": wall,
                          "check_s": time.perf_counter() - t, **nums}),
              flush=True)
        if i < args.control:
            scene = torch.as_tensor(arr, device=args.device)
            t = time.perf_counter()
            out = compare.control(scene, config, drv.seeds, args.device,
                                  CONTROL)
            nums = compare.judge(scene, out, config, drv.seeds, args.device)
            print(json.dumps({"seed": seed, "kind": "control", "K": out["K"],
                              "check_s": time.perf_counter() - t, **nums}),
                  flush=True)
        del drv
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
