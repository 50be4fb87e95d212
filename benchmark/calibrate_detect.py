"""The readings that the detector's limits are set from, at its cell's size.

    python3 benchmark/calibrate_detect.py [--workload det-predict-4096]
                                          --seeds S1 S2 ... [--control N]

For each seed, the model and one scene of the cell made as a run makes
them, the scene through the program's timed path (``predict`` on its
GeoTIFF), then the comparison's numbers against the reference (the lower
readings) with the scene's candidates: how many pass the score filter,
their share of the anchors, how many share their score exactly with
another, the highest score. For the first ``N`` seeds also the two
controls, the reference in TF32 and in bfloat16 (``reference/retinanet``'s
``CONTROLS``) put in the program's place and judged by the same
comparison (the upper readings). One JSON line a reading. The benchmark's
own runs never run this.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def candidate_stats(logits, threshold: float) -> dict:
    """The candidates of one scene's class logits (N, K)."""
    import torch
    scores = torch.sigmoid(logits[:, 1:] if logits.shape[1] > 1
                           else logits).amax(dim=1)
    cand = scores[scores >= threshold]
    return {"anchors": scores.numel(), "candidates": cand.numel(),
            "share": cand.numel() / scores.numel(),
            "tied": cand.numel() - torch.unique(cand).numel(),
            "max_score": float(scores.max()),
            "saturated": int((scores >= 1.0).sum())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="det-predict-4096")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from benchmark import harness
    from benchmark.reference import retinanet as ref

    w = harness.cell(harness.load_benchmark(ROOT), args.workload)
    config = w["config_data"]
    traffic = dict(w["traffic_data"], scene=dict(
        w["traffic_data"]["scene"], pool=1))
    for i, seed in enumerate(args.seeds):
        drv = harness.driver_class(config)(config, traffic, seed,
                                           args.device)
        t = time.perf_counter()
        drv.setup()
        setup_s = time.perf_counter() - t
        hold = []
        t = time.perf_counter()
        out = drv.run_scene(drv.paths[0], hold)
        wall = time.perf_counter() - t
        logits, deltas = hold[0]
        scene = drv.scenes[0]
        weights = drv.weights
        model, predict = config["model"], drv.predict
        threshold = predict["score_threshold"]
        t = time.perf_counter()
        nums = ref.judge(out, (logits, deltas), scene, weights, model,
                         predict)
        print(json.dumps({"seed": seed, "kind": "program",
                          "threshold": threshold,
                          "kept": len(out["boxes"]), "setup_s": setup_s,
                          "scene_s": wall,
                          "check_s": time.perf_counter() - t,
                          **candidate_stats(logits, threshold),
                          **nums}), flush=True)
        del hold, logits, deltas
        if i < args.control:
            for name in ref.CONTROLS:
                t = time.perf_counter()
                c_out, heads = ref.control(scene, weights, model, predict,
                                           args.device, name)
                nums = ref.judge(c_out, heads, scene, weights, model, predict)
                print(json.dumps({"seed": seed, "kind": name,
                                  "kept": len(c_out["boxes"]),
                                  "check_s": time.perf_counter() - t,
                                  **nums}), flush=True)
                del heads
        drv.release()
        del drv, weights
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
