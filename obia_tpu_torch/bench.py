"""End-to-end throughput of the port: segment + featurize + classify, in
megapixels a second, through the port's public entry points (the port's
counterpart of the repository's ``bench.py``, which times the JAX package).

    python -m obia_tpu_torch.bench [size] [--config N|detection]
                                   [--forest stand-in|fit] [--batch B]
                                   [--device DEVICE]

Each configuration builds the same synthetic scene as ``bench.py``, runs once
(``first_run_s``: the CUDA context, the kernel library and the host library
loaded), then takes the best of ``OBIA_BENCH_RUNS`` runs (default 3; 1 means
the first run is the value). A run ends after the polygonisation thread is
joined and the card is synchronised, so the clock covers the host work too.
It prints one JSON row: ``metric``, ``value`` (MP/s), ``unit``,
``elapsed_s``, ``first_run_s``, ``megapixels``, ``n_objects``, ``config``,
``device`` (the card's name and power limit as ``nvidia-smi`` gives them, or
``cpu``), ``forest`` (configs 1 and 4; null elsewhere) and ``launches`` (each
hand-written kernel's launches in the last run; none on the CPU).

- config 1: RGB SLIC (3000 segments, compactness 10), the features of the
  three bands, a 300-tree forest (default size 4096);
- config 4: the 8-band scene, SLIC on bands 0/3/6, the features of all 8
  bands, the forest (4096);
- config 2: RGB quickshift (ratio 1, kernel 5, max_dist 10), the features, a
  (64,) MLP fitted for 60 epochs (1024);
- config 3: ``create_tiled_segments`` (tile 512, buffer 64, 700 segments a
  tile) on the scene written as a GeoTIFF (4096; the sweep runs it once at
  ``min(size, 2048)``); a tile that the manifest does not mark done raises;
- config 5: ``mosaic_pipeline`` over a logical 2 x 4 mesh of shards on the
  one device (4096);
- ``detection``: the repository's ``tools/bench_detection.py`` through the
  port (1024): the full-width RetinaNet on 8-band tiles, the train step
  at batch ``--batch`` (default 2) and whole-raster ``infer_image_array``,
  on the tool's seeded tiles, boxes and scene. Its row is the tool's
  ``{"detection_bench": {...}}``, unrounded, with ``device`` and
  ``launches`` added: the first train step, then the best of 5; the first
  predict, then the best of 3; each timed window ends with the card
  synchronised. It is not part of the sweep.

With no ``--config`` the sweep runs configs 1 and 4, then configs 3 and 5
once each, and prints one row: config 4's, with every row under ``rows``.
A configuration that raises is recorded as an ``error`` row, and the command
then exits non-zero.

The forest of configs 1 and 4 is chosen, never probed for: ``stand-in`` (the
default) is a seeded random forest of the same size with thresholds drawn
from the training rows' quantiles, built on the host and predicted on the
device; its rows time no fit, so they are not ``bench.py``'s quantity.
``fit`` fits ``TorchForestClassifier(n_estimators=300, random_state=0)`` as
``bench.py`` does, and raises ``ImportError`` where scikit-learn is missing.
The rows carry no ``vs_baseline``: that ratio is against a TPU target.
Everything runs on the card unless ``device="cpu"`` is given.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

METRIC = "megapixels/sec end-to-end (segment+featurize+classify)"
N_SEGMENTS = 3000
N_TREES = 300
STAND_IN, FIT = "stand-in", "fit"
FORESTS = (STAND_IN, FIT)
QS_KW = dict(method="quickshift", ratio=1.0, kernel_size=5, max_dist=10.0)
C3_KW = dict(tile_size=512, buffer=64, n_segments=700)
MESH_SHARDS = 8         # config 5's logical 2 x 4 mesh
PRIMARY = "4-multispectral-glcm-rf"
DEFAULT_SIZE = 4096
CONFIG2_SIZE = 1024     # quickshift's cost grows with the window
CONFIG3_SWEEP_SIZE = 2048
DETECTION = "detection"
DETECTION_SIZE = 1024
DETECTION_BANDS = 8
DETECTION_BOXES = 12    # boxes a tile
DETECTION_BATCH = 2


class SweepFailed(RuntimeError):
    """A configuration of the sweep raised; its row holds the error."""


# -- the scenes ------------------------------------------------------------

def build_scene(h=2048, w=2048, c=3, seed=0) -> np.ndarray:
    """The synthetic scene of ``bench.py``: smooth bands plus seeded noise,
    scaled to uint8 (H, W, C)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([
        np.sin(yy / 97.0) + np.cos(xx / 131.0),
        np.sin((yy + xx) / 151.0),
        np.cos(yy / 71.0) * np.sin(xx / 113.0),
        ((yy // 256 + xx // 256) % 5).astype(np.float32) / 4.0,
    ], axis=-1)[:, :, :c].astype(np.float32)
    noise = rng.normal(0, 0.05, (h, w, c)).astype(np.float32)
    arr = base + noise
    lo, hi = arr.min(), arr.max()
    return (255.0 * (arr - lo) / (hi - lo)).astype(np.uint8)


def config4_scene(size: int) -> np.ndarray:
    """Config 4's 8 uint8 bands: :func:`build_scene`'s 4, then each rolled."""
    base3 = build_scene(h=size, w=size, c=4).astype(np.float32)
    more = np.stack([np.roll(base3[..., i % 4], 17 * (i + 1), axis=i % 2)
                     for i in range(4)], axis=-1)
    return np.concatenate([base3, more], axis=-1).astype(np.uint8)


def as_image(scene: np.ndarray):
    """``scene`` as the port's in-memory image (1 m pixels, EPSG:32633)."""
    from .geometry.affine import Affine
    from .handlers.geotif import image_from_array
    h = scene.shape[0]
    return image_from_array(scene, Affine(1.0, 0, 0, 0, -1.0, h),
                            crs="EPSG:32633")


def write_scene(path: str, scene: np.ndarray) -> str:
    """``scene`` as an uncompressed GeoTIFF at ``path`` (config 3's
    input); returns the path."""
    from .geometry.affine import Affine
    from .io.tiff import write_tiff
    h = scene.shape[0]
    write_tiff(path, scene, transform=Affine(1.0, 0, 0, 0, -1.0, h),
               crs="EPSG:32633", compression="none")
    return path


# -- the classify tail -----------------------------------------------------

def training_table(table, seed: int = 0, train_frac: float = 0.2):
    """``bench.py``'s classify table from an ``ObjectTable``: every column
    but ``segment_id`` (the geometry is not a column), all-NaN columns
    dropped, NaN as 0, a median-split target of the first column and a
    seeded ``train_frac`` subset. Returns (X float64, y, subset indices)."""
    cols = [c for c in table.columns if c not in ("segment_id", "geometry")]
    X = np.stack([np.asarray(table[c]) for c in cols],
                 axis=1).astype(np.float64)
    X = np.nan_to_num(X[:, ~np.isnan(X).all(axis=0)])
    y = (X[:, 0] > np.median(X[:, 0])).astype(int)
    n_train = max(10, int(len(X) * train_frac))
    idx = np.random.default_rng(seed).permutation(len(X))[:n_train]
    return X, y, idx


def forest_fields(X: np.ndarray, n_trees: int, depth: int = 8,
                  seed: int = 0) -> dict:
    """The stand-in forest: ``n_trees`` full binary trees of ``depth``
    (heap-ordered nodes), each inner node splitting a random feature at a
    random quantile (0.1-0.9) of ``X``'s rows, each leaf a random class
    distribution; the dense tables ``ForestArrays.from_numpy`` takes."""
    rng = np.random.default_rng(seed)
    n_int = 2 ** depth - 1
    n_nodes = 2 ** (depth + 1) - 1
    feature = np.full((n_trees, n_nodes), -1, np.int64)
    feature[:, :n_int] = rng.integers(0, X.shape[1], (n_trees, n_int))
    q = rng.uniform(0.1, 0.9, (n_trees, n_int))
    rank = np.floor(q * (X.shape[0] - 1)).astype(np.int64)
    threshold = np.zeros((n_trees, n_nodes), np.float32)
    threshold[:, :n_int] = np.sort(X, axis=0)[rank, feature[:, :n_int]]
    idx = np.arange(n_nodes)
    left = np.where(idx < n_int, 2 * idx + 1, idx)[None].repeat(n_trees, 0)
    right = np.where(idx < n_int, 2 * idx + 2, idx)[None].repeat(n_trees, 0)
    p = rng.uniform(0, 1, (n_trees, n_nodes, 1)).astype(np.float32)
    proba = np.concatenate([p, 1 - p], axis=2)
    return dict(feature=feature, threshold=threshold, left=left, right=right,
                leaf_proba=proba, classes=np.array([0, 1]), max_depth=depth)


def check_forest(forest: str) -> None:
    """Raise unless ``forest`` can run here: ``ValueError`` for an unknown
    name, ``ImportError`` for ``fit`` without scikit-learn."""
    if forest not in FORESTS:
        raise ValueError(f"forest must be one of {FORESTS}, not {forest!r}")
    if forest == FIT:
        try:
            import sklearn  # noqa: F401
        except ImportError as exc:
            raise ImportError("forest='fit' fits the forest with "
                              "scikit-learn (sklearn), which is not "
                              "installed; use forest='stand-in'") from exc


def featurize_classify(table, device, forest: str = STAND_IN,
                       seed: int = 0) -> np.ndarray:
    """Configs 1 and 4's classify tail on an ``ObjectTable``: the training
    table, then the 300-tree forest's ``predict_proba`` of every object on
    ``device``: the stand-in's, or a fitted one's (``forest="fit"``)."""
    import torch

    from .classification.forest import (ForestArrays, TorchForestClassifier,
                                        forest_proba)
    check_forest(forest)
    X, y, idx = training_table(table, seed)
    if forest == FIT:
        clf = TorchForestClassifier(device=device, n_estimators=N_TREES,
                                    random_state=0)
        clf.fit(X[idx], y[idx])
        return clf.predict_proba(X)
    trees = ForestArrays.from_numpy(**forest_fields(X[idx], N_TREES),
                                    device=device)
    return forest_proba(trees, torch.as_tensor(
        X, dtype=torch.float32, device=device)).cpu().numpy()


def mlp_classify(table, device, seed: int = 0) -> np.ndarray:
    """Config 2's classify tail: the training table, a (64,) MLP fitted for
    60 epochs on ``device``, then ``predict_proba`` of every object."""
    from . import telemetry
    from .classification.mlp import TorchMLPClassifier
    X, y, idx = training_table(table, seed)
    clf = TorchMLPClassifier(hidden_layer_sizes=(64,), max_iter=60,
                             random_state=0, device=device)
    with telemetry.stage("classify.fit"):
        clf.fit(X[idx], y[idx])
    with telemetry.stage("classify.predict"):
        return clf.predict_proba(X)


# -- one run of each configuration -------------------------------------------

def _finish(table, device) -> None:
    """End a run: join the polygonisation thread, synchronise the card."""
    import torch
    table.geometry
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_config1(image, device, forest: str = STAND_IN):
    """Config 1 once: (segments, probabilities)."""
    from .segmentation.segment import segment
    s = segment(image, method="slic", n_segments=N_SEGMENTS, compactness=10,
                device=device)
    proba = featurize_classify(s.table, device, forest)
    _finish(s.table, device)
    return s, proba


def run_config4(image, device, forest: str = STAND_IN, **seg_kw):
    """Config 4 once: (segments, probabilities). ``seg_kw`` (``sigma``) go
    to SLIC."""
    from .segmentation.segment import segment
    s = segment(image, segmentation_bands=[0, 3, 6],
                statistics_bands=list(range(8)), method="slic",
                n_segments=N_SEGMENTS, compactness=10, device=device,
                **seg_kw)
    proba = featurize_classify(s.table, device, forest)
    _finish(s.table, device)
    return s, proba


def run_config2(image, device, **seg_kw):
    """Config 2 once: (segments, probabilities). ``seg_kw`` (``sigma``) go
    to quickshift."""
    from .segmentation.segment import segment
    s = segment(image, device=device, **QS_KW, **seg_kw)
    proba = mlp_classify(s.table, device)
    _finish(s.table, device)
    return s, proba


def run_config5(image, device):
    """Config 5 once: the object table of ``mosaic_pipeline`` over a 2 x 4
    mesh of shards on ``device``."""
    from .parallel.mesh import make_mesh
    from .parallel.mosaic import mosaic_pipeline
    objects = mosaic_pipeline(image, n_segments=N_SEGMENTS, compactness=10.0,
                              mesh=make_mesh(MESH_SHARDS, [device]))
    _finish(objects, device)
    return objects


def run_config3(raster: str, out_dir: str, device, **kw):
    """Config 3 once into ``out_dir``: the tiled driver's segments. Raises
    when the manifest marks a tile failed or not done."""
    import torch

    from .checkpoint import TileManifest
    from .utils.tiling import create_tiled_segments
    out = create_tiled_segments(raster, out_dir, **C3_KW, device=device,
                                **kw)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    manifest = TileManifest(os.path.join(out_dir, "manifest.json"))
    if manifest.failed() or not all(
            v["status"] == "done" for v in manifest.state.values()):
        raise RuntimeError(f"config 3 tiles not done: {manifest.state}")
    return out


# -- the timer and the row ---------------------------------------------------

def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_label(device) -> str:
    """What a row says it ran on: the card's line, or ``cpu``."""
    import torch
    return card_line() if torch.device(device).type == "cuda" else "cpu"


# each hand-written kernel's launch counter in the telemetry, by the key
# the rows print
LAUNCH_COUNTERS = {"glcm_sums": "kernel.glcm_sums",
                   "glcm_hist": "kernel.glcm_hist",
                   "qs_density": "kernel.qs_density",
                   "qs_parent": "kernel.qs_parent"}
_launches_at_reset: dict = {}


def reset_launches() -> None:
    """Count every kernel's launches from here on (:func:`kernel_launches`
    reads them)."""
    from . import telemetry
    _launches_at_reset.clear()
    _launches_at_reset.update(telemetry.counters())


def kernel_launches() -> dict:
    """Each hand-written kernel's launches since :func:`reset_launches`,
    read from the telemetry's counters (a wrapper counts only when it
    launches its kernel, never its plain version on the CPU; a
    ``telemetry.reset()`` after :func:`reset_launches` voids the reading)."""
    from . import telemetry
    now = telemetry.counters()
    return {key: now.get(name, 0) - _launches_at_reset.get(name, 0)
            for key, name in LAUNCH_COUNTERS.items()}


def _timed(fn, runs=None):
    """(fn's last result, best seconds, first run's seconds, the last
    run's kernel launches): one first run, then the best of ``runs``
    (``OBIA_BENCH_RUNS``, default 3) runs counting the first."""
    if runs is None:
        runs = int(os.environ.get("OBIA_BENCH_RUNS", "3"))
    reset_launches()
    t0 = time.perf_counter()
    n = fn()
    first = time.perf_counter() - t0
    best = first
    for _ in range(max(0, runs - 1)):
        reset_launches()
        t0 = time.perf_counter()
        n = fn()
        best = min(best, time.perf_counter() - t0)
    return n, best, first, kernel_launches()


def _emit(mp, timed, config, device, extra=None, emit=True) -> dict:
    n_obj, elapsed, first, launches = timed
    row = {"metric": METRIC, "value": mp / elapsed, "unit": "MP/s",
           "elapsed_s": elapsed, "first_run_s": first, "megapixels": mp,
           "n_objects": int(n_obj), "config": config,
           "device": device_label(device), "forest": None,
           "launches": launches}
    row.update(extra or {})
    if emit:
        print(json.dumps(row), flush=True)
    return row


# -- the five configurations -------------------------------------------------

def _device(device):
    from .device import resolve_device
    return str(resolve_device(device))


def bench_config1(size: int, device=None, forest: str = STAND_IN,
                  emit: bool = True, runs=None) -> dict:
    """Config 1 at size^2 RGB."""
    device = _device(device)
    image = as_image(build_scene(h=size, w=size))
    timed = _timed(
        lambda: len(run_config1(image, device, forest)[0].table), runs)
    return _emit(size * size / 1e6, timed, "1-quickstart-slic-rf", device,
                 {"forest": forest}, emit)


def bench_config4(size: int, device=None, forest: str = STAND_IN,
                  emit: bool = True, runs=None) -> dict:
    """Config 4 at size^2 x 8 bands."""
    device = _device(device)
    image = as_image(config4_scene(size))
    timed = _timed(
        lambda: len(run_config4(image, device, forest)[0].table), runs)
    return _emit(size * size / 1e6, timed, PRIMARY, device,
                 {"forest": forest}, emit)


def bench_config2(size: int, device=None, emit: bool = True,
                  runs=None) -> dict:
    """Config 2 at size^2 RGB."""
    device = _device(device)
    image = as_image(build_scene(h=size, w=size))
    timed = _timed(lambda: len(run_config2(image, device)[0].table), runs)
    return _emit(size * size / 1e6, timed, "2-quickshift-mlp", device, None,
                 emit)


def bench_config3(size: int, device=None, emit: bool = True,
                  runs=None) -> dict:
    """Config 3 at size^2 RGB: each run writes into a new folder; the scene
    and the folders are removed afterwards."""
    device = _device(device)
    tmp = tempfile.mkdtemp(prefix="obia_bench3_")
    try:
        raster = write_scene(os.path.join(tmp, "scene.tif"),
                             build_scene(h=size, w=size))
        timed = _timed(lambda: len(run_config3(
            raster, tempfile.mkdtemp(dir=tmp), device)), runs)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return _emit(size * size / 1e6, timed, "3-tiled-slic", device, None,
                 emit)


def bench_config5(size: int, device=None, emit: bool = True,
                  runs=None) -> dict:
    """Config 5 at size^2 RGB on a logical 2 x 4 mesh on one device."""
    device = _device(device)
    image = as_image(build_scene(h=size, w=size))
    timed = _timed(lambda: len(run_config5(image, device)), runs)
    return _emit(size * size / 1e6, timed, "5-sharded-mosaic", device,
                 {"mesh": [2, MESH_SHARDS // 2]}, emit)


def detection_inputs(size: int, batch: int, seed: int = 0):
    """The tool's draws from ``np.random.default_rng(seed)``, in its order:
    ``batch`` (C, size, size) float32 tiles, then each tile's 12 boxes
    (x0, y0 in [0, size - 80), sides in [20, 70)) with label 1, then the
    (size, size, C) float32 scene that the predict runs on. Returns
    (tiles, targets, scene)."""
    rng = np.random.default_rng(seed)
    C, n = DETECTION_BANDS, DETECTION_BOXES
    images = [rng.random((C, size, size), np.float32) for _ in range(batch)]
    targets = []
    for _ in range(batch):
        x0 = rng.uniform(0, size - 80, n)
        y0 = rng.uniform(0, size - 80, n)
        w = rng.uniform(20, 70, n)
        h = rng.uniform(20, 70, n)
        targets.append({
            "boxes": np.stack([x0, y0, x0 + w, y0 + h], -1).astype(np.float32),
            "labels": np.ones(n, np.int32)})
    scene = rng.random((size, size, C), np.float32)
    return images, targets, scene


def bench_detection(size: int = DETECTION_SIZE, device=None,
                    batch: int = DETECTION_BATCH, emit: bool = True,
                    warm_runs=None) -> dict:
    """The detection configuration at size^2 x 8 bands: one first train
    step, then the best of 5 more (``warm_runs`` when given); one first
    predict, then the best of 3 more (``warm_runs``): the tool's runs."""
    import torch

    from .detection.models import build_detection_model
    from .detection.predict import infer_image_array
    from .detection.train import _pad_batch, make_padded_train_step
    device = _device(device)
    train_runs, predict_runs = (5, 3) if warm_runs is None else (
        warm_runs, warm_runs)

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    model = build_detection_model(num_classes=2, in_channels=DETECTION_BANDS,
                                  image_size=(size, size), device=device)
    images, targets, scene = detection_inputs(size, batch)
    padded = _pad_batch(images, targets, device)
    step = make_padded_train_step(model, torch.optim.Adam(
        model.parameters(), lr=1e-4))
    reset_launches()

    def best_of(fn, runs):
        """(fn's last result, its first run's seconds, the best of the
        ``runs`` after it, or the first's when there are none)."""
        times = []
        for _ in range(1 + runs):
            t0 = time.perf_counter()
            out = fn()
            sync()
            times.append(time.perf_counter() - t0)
        return out, times[0], min(times[1:] or times)

    loss, first_train, best_train = best_of(lambda: step(*padded),
                                            train_runs)
    out, first_pred, best_pred = best_of(lambda: infer_image_array(
        model, scene, score_threshold=0.05, nms_threshold=0.5),
        predict_runs)
    mp = size * size / 1e6
    row = {"detection_bench": {
        "tile": f"{size}x{size}x{DETECTION_BANDS}", "batch": batch,
        "backbone": "resnet50-w64-fpn256",
        "train_step_s": best_train, "train_step_first_s": first_train,
        "train_images_per_s": batch / best_train, "loss": float(loss),
        "predict_s": best_pred, "predict_first_s": first_pred,
        "predict_mp_s": mp / best_pred,
        "n_detections": int(len(out["boxes"])),
        "device": device_label(device), "launches": kernel_launches()}}
    if emit:
        print(json.dumps(row), flush=True)
    return row


CONFIGS = {1: bench_config1, 2: bench_config2, 3: bench_config3,
           4: bench_config4, 5: bench_config5}


def bench_default(size: int, device=None, forest: str = STAND_IN) -> dict:
    """The sweep: configs 1 and 4 at size^2, then config 3 at
    ``min(size, 2048)`` and config 5 at size^2, each of those once. Prints
    and returns config 4's row with every row under ``rows``; raises
    :class:`SweepFailed` after printing if any configuration raised."""
    rows = []
    for name, fn in (
            ("1-quickstart-slic-rf",
             lambda: bench_config1(size, device, forest, emit=False)),
            (PRIMARY, lambda: bench_config4(size, device, forest,
                                            emit=False)),
            ("3-tiled-slic",
             lambda: bench_config3(min(size, CONFIG3_SWEEP_SIZE), device,
                                   emit=False, runs=1)),
            ("5-sharded-mosaic",
             lambda: bench_config5(size, device, emit=False, runs=1))):
        try:
            rows.append(fn())
            print(f"bench {name}: {json.dumps(rows[-1])}", file=sys.stderr,
                  flush=True)
        except Exception as exc:  # recorded, then the sweep exits non-zero
            rows.append({"config": name,
                         "error": f"{type(exc).__name__}: {exc}"[:300]})
            print(f"bench {name} failed: {rows[-1]['error']}",
                  file=sys.stderr, flush=True)
    out = dict(next(r for r in rows if r["config"] == PRIMARY))
    out["rows"] = rows
    print(json.dumps(out), flush=True)
    failed = [r["config"] for r in rows if "error" in r]
    if failed:
        raise SweepFailed(f"configurations failed: {failed}")
    return out


def default_size(config) -> int:
    """A configuration's size when none is given: 1024 for config 2 and
    the detection configuration, else 4096."""
    return (CONFIG2_SIZE if config == 2 else DETECTION_SIZE
            if config == DETECTION else DEFAULT_SIZE)


def config_arg(value: str):
    """A ``--config`` value: ``detection`` or a configuration number."""
    return value if value == DETECTION else int(value)


def run(size=None, config=None, forest: str = STAND_IN, device=None,
        batch: int = DETECTION_BATCH) -> dict:
    """One configuration (``config`` 1-5 or ``"detection"``, which takes
    ``batch``) or the sweep (None) at ``size`` (:func:`default_size` when
    None) on ``device`` (the card when None); prints and returns the
    row."""
    if size is None:
        size = default_size(config)
    device = _device(device)
    check_forest(forest)
    if config is None:
        return bench_default(size, device, forest)
    if config == DETECTION:
        return bench_detection(size, device, batch)
    if config not in CONFIGS:
        raise ValueError(f"config must be one of {sorted(CONFIGS)} or "
                         f"{DETECTION!r}, not {config!r}")
    kw = {"forest": forest} if config in (1, 4) else {}
    return CONFIGS[config](size, device, **kw)


def main(argv=None) -> dict:
    import argparse
    parser = argparse.ArgumentParser(
        prog="python -m obia_tpu_torch.bench",
        description=__doc__.splitlines()[0])
    parser.add_argument("size", nargs="?", type=int, default=None,
                        help="scene side in pixels (default: 1024 for "
                             "config 2 and detection, else 4096)")
    parser.add_argument("--config", type=config_arg,
                        choices=[*sorted(CONFIGS), DETECTION], default=None,
                        help="one configuration; none runs the sweep")
    parser.add_argument("--forest", choices=FORESTS, default=STAND_IN,
                        help="configs 1 and 4's forest")
    parser.add_argument("--batch", type=int, default=DETECTION_BATCH,
                        help="the detection configuration's batch")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)
    return run(args.size, args.config, args.forest, args.device, args.batch)


def script() -> int:
    """``python -m obia_tpu_torch.bench``: :func:`main` on ``sys.argv``;
    returns the exit code, 1 when a configuration of the sweep failed (its
    line, with the error rows, is printed). Any other error prints a 0.0
    row and is raised again."""
    try:
        main()
    except SweepFailed:
        return 1
    except Exception as exc:
        print(json.dumps({"metric": METRIC, "value": 0.0, "unit": "MP/s",
                          "error": f"{type(exc).__name__}: {exc}"[:300]}),
              flush=True)
        raise
    return 0


if __name__ == "__main__":
    sys.exit(script())
