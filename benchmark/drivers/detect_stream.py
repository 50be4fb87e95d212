"""A closed-loop stream of whole rasters through the port's detector:
``predict(model, path)`` reads the GeoTIFF (``detect.read``), scales it to
uint8 on the card (``detect.scale``), runs RetinaNet's forward pass
(``detect.forward``), decodes and filters the 3.1 M anchors of a 4096^2
raster on the card and downloads the candidates (``detect.decode``), and
runs greedy NMS on the host (``detect.nms``).

The weights are the reference's: drawn from the run's seed and calibrated
with the reference's own forward pass over a seeded scene outside the pool
(``reference/retinanet.py``'s ``init_weights`` and ``calibrate``: BatchNorm
statistics from a train-mode pass, the box output's spread, the score
threshold), then loaded into the port's model on the card. The pool's scenes
(``benchmark/scenes.py``'s 8-band recipe) are written in set-up as
uncompressed GeoTIFFs under a temporary directory, and a warm scene is run
once. One worker then takes scene after scene and finishes the scene it
started.

The check judges two of the completed scenes, drawn from the seed before
the window from the first eight (in the traced run, from the scenes it
runs). A forward hook on the head keeps those scenes' class logits and
box deltas as the timed path produced them (about 75 MB each on the card
at 4096^2); the reference (``benchmark/reference/retinanet.py``) runs its
own forward pass on the same raster and its own decode, filter and NMS of
the program's head outputs.
"""
from __future__ import annotations

import math
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from benchmark.reference import retinanet as ref
from benchmark.roofline import retinanet as roofline
from benchmark.scenes import make_pool, make_scene, scene_seeds

#: completed scenes of the window that the check draws its sample from
CHECK_FROM = 8


def build_model(config: dict, seed: int, side: int, device):
    """The cell's model on ``device``, its weights by module name on the
    host and its score threshold. The reference draws the weights from
    ``seed`` (:func:`ref.init_weights`) and calibrates them with its own
    forward pass on a ``side``-pixel scene of the same seed
    (:func:`ref.calibrate`); the program's model is then handed them."""
    from obia_tpu_torch.detection import build_detection_model

    m = config["model"]
    w_seed, scene_seed = scene_seeds(seed, 2, stream=3)
    weights = {k: v.to(device) for k, v in ref.init_weights(
        m, torch.Generator().manual_seed(w_seed)).items()}
    scene = make_scene(side, int(config["bands"]), scene_seed, device)
    x = ref.padded_input(ref.scale_to_uint8(scene.cpu().numpy()), device)
    threshold = ref.calibrate(weights, x, m, config["calibration"])
    del x
    model = build_detection_model(
        num_classes=int(m["num_classes"]), in_channels=int(m["in_channels"]),
        seed=w_seed, backbone_width=int(m["backbone_width"]),
        fpn_channels=int(m["fpn_channels"]),
        stage_sizes=tuple(m["stage_sizes"]), device=device)
    model.load_state_dict(weights)
    model.eval()
    return model, {k: v.cpu() for k, v in weights.items()}, threshold


class Driver:
    """One run's scenes, window, traced run and check on ``device``."""

    #: every number :meth:`check` can return
    NUMBERS = ref.NUMBERS
    #: the numbers every cell this driver runs is held to
    REQUIRED = ("logit_gap", "delta_gap", "kept_mismatch")

    def __init__(self, config: dict, workload: dict, seed: int, device):
        self.config = config
        self.workload = workload
        self.seed = int(seed)
        self.device = torch.device(device)
        self.kept = []          # detections of every completed scene
        self.heads = {}         # completed scene index -> head outputs
        self.scenes = []        # raw rasters of the pool, on the host
        self.paths = []
        self.tmp = None
        self.model = None
        self.weights = None     # the reference's, on the host
        self.predict = None
        self.picks = set()
        self.attempted = 0
        self.failed = 0
        self.next = 0
        self._hold = None

    # -- set-up ------------------------------------------------------------

    def setup(self) -> None:
        """The model, the pool's GeoTIFFs, one warm scene."""
        from obia_tpu_torch.geometry.affine import Affine
        from obia_tpu_torch.io.tiff import write_tiff

        side = int(self.workload["scene"]["side"])
        self.model, self.weights, threshold = build_model(
            self.config, self.seed, side, self.device)
        self.predict = dict(self.config["predict"],
                            score_threshold=threshold)
        self.model.RetinaNetHead_0.register_forward_hook(self._keep_heads)
        self.tmp = tempfile.mkdtemp(prefix="det-scenes-")
        scenes = make_pool(self.workload, int(self.config["bands"]),
                           self.seed, self.device)
        for i, arr in enumerate(scenes):
            path = os.path.join(self.tmp, f"scene{i}.tif")
            write_tiff(path, arr, Affine(1.0, 0, 0, 0, -1.0, side),
                       crs=self.config["crs"], compression="none")
            self.paths.append(path)
        self.scenes = scenes[1:]
        self.run_scene(self.paths[0])
        self.paths = self.paths[1:]

    def _keep_heads(self, module, inputs, output) -> None:
        if self._hold is not None:
            self._hold.append((output[0][0], output[1][0]))

    # -- one scene -----------------------------------------------------------

    def run_scene(self, path: str, hold=None) -> dict:
        """``predict`` on one raster; ``hold``, a list, receives the head
        outputs."""
        from obia_tpu_torch.detection import predict

        p = self.predict
        self._hold = hold
        try:
            return predict(self.model, path,
                           score_threshold=float(p["score_threshold"]),
                           nms_threshold=float(p["nms_threshold"]))
        finally:
            self._hold = None

    def _attempt(self):
        """The next scene of the pool; one that raises counts as failed and
        its traceback goes to standard error. Returns its wall seconds."""
        import traceback
        self.attempted += 1
        i = self.next % len(self.paths)
        self.next += 1
        n = len(self.kept)
        hold = [] if n in self.picks else None
        t0 = time.perf_counter()
        try:
            out = self.run_scene(self.paths[i], hold)
        except Exception:  # the run goes on and reports the failure
            self.failed += 1
            traceback.print_exc()
            return None
        wall = time.perf_counter() - t0
        out["scene"] = i
        self.kept.append(out)
        if hold:
            self.heads[n] = hold[0]
        return wall

    def _pick(self, first: int) -> None:
        """The completed scenes the check will judge: ``check.scenes`` of
        the ``first`` to complete, drawn from the seed."""
        n = int(self.workload["check"]["scenes"])
        rng = np.random.default_rng([self.seed % (1 << 64), 11])
        start = len(self.kept)
        self.picks = {start + int(i) for i in
                      rng.choice(first, min(n, first), replace=False)}

    def _finish_picks(self) -> None:
        """Scenes past the timed ones until every picked scene completed."""
        while len(self.kept) <= max(self.picks, default=-1) and \
                not self.failed:
            self._attempt()

    # -- the measured window --------------------------------------------------

    def window(self, seconds: float) -> dict:
        """Scenes until ``seconds`` have passed; the end-to-end metrics
        this driver can give."""
        side = int(self.workload["scene"]["side"])
        self._pick(CHECK_FROM)
        t0 = time.perf_counter()
        done = 0
        while time.perf_counter() - t0 < seconds:
            done += self._attempt() is not None
        out = {"scene_mp_per_s": done * side * side / 1e6
               / (time.perf_counter() - t0)}
        self._finish_picks()
        return out

    # -- the traced run ----------------------------------------------------

    def traced(self) -> dict:
        """Part 1: scenes with the program's telemetry on (every stage
        waits for the card); part 2: scenes under ``torch.profiler`` with
        it off. Returns what the per-layer readers take and the device's
        numbers."""
        from obia_tpu_torch import telemetry
        from torch.profiler import ProfilerActivity, profile

        from benchmark.trace import DeviceTrace, device_events

        tw = self.workload["trace"]
        n1, n2 = int(tw["stage_scenes"]), int(tw["profile_scenes"])
        self._pick(n1 + n2)
        telemetry.reset()
        telemetry.enable(True)
        try:
            done = sum(self._attempt() is not None for _ in range(n1))
            stages = telemetry.report()
        finally:
            telemetry.enable(False)
        first_profiled = len(self.kept)
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            t0 = time.time_ns()
            for _ in range(n2):
                self._attempt()
            t1 = time.time_ns()
        events = device_events(prof)
        # the detector's stages, which name the idle gaps
        spans = [(s.name, s.start_ns, s.end_ns) for s in telemetry.spans()
                 if s.start_ns >= t0 and s.parent is None]
        self._finish_picks()
        padded = -(-int(self.workload["scene"]["side"]) // ref.PAD) * ref.PAD
        return {"stages": stages, "stage_scenes": done,
                "trace": DeviceTrace(events, t0, t1, spans),
                "forward_s": roofline.forward_device_s(events, t0, t1),
                "traced_scenes": [
                    {"H": padded, "W": padded, **self.config["model"]}
                    for _ in self.kept[first_profiled:first_profiled + n2]]}

    # -- the check ---------------------------------------------------------

    def release(self) -> None:
        """Remove the GeoTIFFs; the rasters and kept outputs stay for the
        check."""
        if self.tmp is not None:
            shutil.rmtree(self.tmp, ignore_errors=True)
            self.tmp = None

    def check(self) -> dict:
        """The comparison's numbers, each the worst over the picked
        scenes."""
        worst = {}
        for n in sorted(self.heads):
            out = self.kept[n]
            nums = ref.judge(out, self.heads[n], self.scenes[out["scene"]],
                             self.weights, self.config["model"],
                             self.predict)
            for k, v in nums.items():
                worst[k] = max(worst.get(k, -math.inf), v)
        return worst
