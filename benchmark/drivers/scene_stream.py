"""A closed-loop stream of scenes through the port's public path:
image -> ``segment`` (segmentation, label download, polygonisation on its
thread, spectral and texture features) -> the classify tail -> the
polygons joined and the card synchronised.

One worker takes scene after scene and finishes the scene it started. Each
scene enters as a new ``Image`` from ``image_from_array`` on its uint8
array, as ``open_geotiff`` hands a scene over, so every scene pays one
upload of its uint8 array, cast on the card; the ``Image`` keeps the
source dtype and makes no float32 copy on the host (``image_convert_ms``
and ``image_widens`` read that). The scenes are made on the device in
set-up (``benchmark/scenes.py``): the warm scene, run once, then the pool,
cycled. Every completed scene's outputs are kept on the host for the check
after the window; the check (``benchmark/reference``) runs on a sample of
them drawn from the seed.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchmark.reference import compare
from benchmark.reference.classify import forest_fields, training_table
from benchmark.roofline import quickshift as qs_roofline
from benchmark.scenes import make_pool, scene_seeds


def rings_of(geom) -> list:
    """The rings of a polygon or multipolygon: [(coords, is_hole)]."""
    parts = geom.geoms if geom.geom_type == "MultiPolygon" else [geom]
    out = []
    for g in parts:
        out.append((g.exterior.coords_array, False))
        out += [(h.coords_array, True) for h in g.interiors]
    return out


class Driver:
    """One run's scenes, window, traced run and check on ``device``."""

    #: every number :meth:`check` can return
    NUMBERS = compare.NUMBERS
    #: the numbers every cell this driver runs is held to
    REQUIRED = ("label_mismatch", "polygon_faults", "feature_gap")

    def __init__(self, config: dict, workload: dict, seed: int, device):
        self.config = config
        self.workload = workload
        self.seed = int(seed)
        self.device = torch.device(device)
        s = scene_seeds(seed, 3, stream=1)
        self.seeds = {"table": s[0], "forest": s[1], "mlp": s[2]}
        self.kept = []          # outputs of every completed scene
        self.walls = []         # seconds of each scene in the window
        self.attempted = 0
        self.failed = 0
        self.pool = []
        self.next = 0

    # -- set-up ------------------------------------------------------------

    def setup(self) -> None:
        """The scenes, then one warm scene of the cell's shape."""
        scenes = make_pool(self.workload, int(self.config["bands"]),
                           self.seed, self.device)
        warm, self.pool = scenes[0], scenes[1:]
        self.run_scene(warm, keep=False)
        self._sync()
        self.kept.clear()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- one scene -----------------------------------------------------------

    def _classify(self, columns: dict) -> np.ndarray:
        clf = self.config["classifier"]
        X, y, idx = training_table(columns, self.seeds["table"],
                                   float(clf.get("train_frac", 0.2)))
        dev = self.device
        if clf["kind"] == "stand_in_forest":
            from obia_tpu_torch.classification.forest import (ForestArrays,
                                                              forest_proba)
            trees = ForestArrays.from_numpy(
                **forest_fields(X[idx], int(clf["n_trees"]),
                                int(clf["depth"]), self.seeds["forest"]),
                device=dev)
            return forest_proba(trees, torch.as_tensor(
                X, dtype=torch.float32, device=dev)).cpu().numpy()
        from obia_tpu_torch.classification.mlp import TorchMLPClassifier
        model = TorchMLPClassifier(
            hidden_layer_sizes=tuple(clf["hidden"]),
            max_iter=int(clf["max_iter"]), random_state=self.seeds["mlp"],
            device=dev)
        model.fit(X[idx], y[idx])
        return model.predict_proba(X)

    def run_scene(self, arr: np.ndarray, keep: bool = True, spans=None,
               marks=None) -> float:
        """Run one scene; returns its wall seconds. ``spans`` collects
        the join's and the classify tail's seconds, ``marks`` the host
        clock (ns) of each step."""
        from obia_tpu_torch.geometry.affine import Affine
        from obia_tpu_torch.handlers.geotif import image_from_array
        from obia_tpu_torch.segmentation.segment import segment

        H = arr.shape[0]
        t0 = time.perf_counter()
        m = [("image", time.time_ns())]
        image = image_from_array(arr, Affine(1.0, 0, 0, 0, -1.0, H),
                                 crs=self.config["crs"])
        m.append(("segment", time.time_ns()))
        s = segment(image, device=self.device, **self.config["segment"])
        table = s.table
        columns = {c: v for c, v in table.columns.items()
                   if c != "segment_id"}
        m.append(("classify", time.time_ns()))
        t1 = time.perf_counter()
        proba = self._classify(columns)
        t2 = time.perf_counter()
        m.append(("join", time.time_ns()))
        geometry = table.geometry
        self._sync()
        t3 = time.perf_counter()
        m.append(("end", time.time_ns()))
        if spans is not None:
            spans["classify"].append(t2 - t1)
            spans["polygonize_wait"].append(t3 - t2)
        if marks is not None:
            marks.append(m)
        if keep:
            rle = s.layer.label_raster
            self.kept.append({
                "scene": arr, "rle": (rle.values, rle.lengths, rle.shape),
                "K": len(table), "columns": columns, "proba": proba,
                "geometry": geometry})
        return t3 - t0

    def _next_scene(self) -> np.ndarray:
        arr = self.pool[self.next % len(self.pool)]
        self.next += 1
        return arr

    def _attempt(self, **kw):
        """One scene from the pool; a scene that raises counts as failed
        and its traceback goes to standard error."""
        import traceback
        self.attempted += 1
        try:
            return self.run_scene(self._next_scene(), **kw)
        except Exception:  # the run goes on and reports the failure
            self.failed += 1
            traceback.print_exc()
            return None

    # -- the measured window --------------------------------------------------

    def window(self, seconds: float) -> dict:
        """Scenes until ``seconds`` have passed; the end-to-end metrics
        this driver can give."""
        side = self.workload["scene"]["side"]
        mp = side * side / 1e6
        t0 = time.perf_counter()
        done = 0
        while time.perf_counter() - t0 < seconds:
            wall = self._attempt()
            if wall is not None:
                self.walls.append(wall)
                done += 1
        elapsed = time.perf_counter() - t0
        out = {"scene_mp_per_s": done * mp / elapsed}
        if self.walls:
            out["tile_s_p90"] = float(np.percentile(self.walls, 90))
        return out

    # -- the traced run --------------------------------------------------------

    def _scene_shapes(self, out: dict) -> dict:
        H, W = out["rle"][2]
        seg = self.config["segment"]
        info = {"H": H, "W": W, "K": out["K"],
                "angles": len(self.config["glcm"]["angles_deg"]),
                "texture_bands": out["scene"].shape[2], "qs": None}
        if seg["method"] == "quickshift":
            info["qs"] = {"C": 3, "radius": qs_roofline.radius(
                float(seg["kernel_size"])),
                "max_dist": float(seg["max_dist"])}
        return info

    def traced(self) -> dict:
        """Part 1: scenes with the program's telemetry on (every stage
        waits for the card); part 2: whole scenes under ``torch.profiler``
        with the telemetry off. Returns what the per-layer readers take
        and the device's numbers."""
        from obia_tpu_torch import telemetry
        from torch.profiler import ProfilerActivity, profile

        from benchmark.trace import DeviceTrace, device_events

        tw = self.workload["trace"]
        spans = {"classify": [], "polygonize_wait": []}
        telemetry.reset()
        telemetry.enable(True)
        try:
            n1 = 0
            for _ in range(int(tw["stage_scenes"])):
                n1 += self._attempt(spans=spans) is not None
            stages = telemetry.report()
        finally:
            telemetry.enable(False)
        first_profiled = len(self.kept)
        marks = []
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.reset_peak_memory_stats(self.device)
        with profile(activities=acts) as prof:
            t0 = time.time_ns()
            for _ in range(int(tw["profile_scenes"])):
                self._attempt(marks=marks)
            t1 = time.time_ns()
        host_spans = [(name, a, b) for m in marks
                      for (name, a), (_, b) in zip(m[:-1], m[1:])]
        tr = DeviceTrace(device_events(prof), t0, t1, host_spans)
        return {"stages": stages, "stage_scenes": n1, "spans": spans,
                "trace": tr,
                "traced_scenes": [self._scene_shapes(o)
                                  for o in self.kept[first_profiled:]]}

    # -- the check -------------------------------------------------------------

    def release(self) -> None:
        """Drop the scene pool; the kept outputs stay for the check."""
        self.pool = []
        import gc
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """The comparison's numbers, each the worst over a sample of the
        completed scenes drawn from the seed."""
        n = min(int(self.workload["check"]["scenes"]), len(self.kept))
        if n == 0:
            return {}
        rng = np.random.default_rng([self.seed % (1 << 64), 9])
        pick = rng.choice(len(self.kept), n, replace=False)
        worst = {}
        for i in sorted(pick):
            out = self.kept[i]
            values, lengths, shape = out["rle"]
            scene = torch.as_tensor(out["scene"], device=self.device)
            nums = compare.judge(scene, {
                "labels": np.repeat(values, lengths).reshape(shape),
                "K": out["K"], "columns": out["columns"],
                "proba": out["proba"],
                "polygons": [rings_of(g) for g in out["geometry"]]},
                self.config, self.seeds, self.device)
            for k, v in nums.items():
                worst[k] = max(worst.get(k, -math.inf), v)
        return worst

