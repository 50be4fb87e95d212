#!/usr/bin/env python3
"""Smoke run of obia_tpu_torch on one NVIDIA GPU: build, check, drive.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. require a CUDA device and print its name and power limit (nvidia-smi);
2. build the CUDA kernels from ``obia_tpu_torch/csrc`` with nvcc;
3. hold the GLCM kernel against its plain-torch twin on an edge-case scene
   (integer sums and sum (C+C^T)^2 equal, sum 1/(1+d^2) within rtol 1e-6);
4. drive the config-4 slice of ``bench.py`` at 4096^2 x 8 bands on the card:
   ``segment`` (SLIC on bands 0/3/6, spectral + GLCM features of all 8
   bands) and a 300-tree forest ``predict_proba``, once cold and once warm,
   with the kernel launch counts read around the warm run; then a profiled
   run for the stage split, the kernel against its twin on one band of that
   scene, and both timed with CUDA events;
5. cross-check: the same slice at 512^2 on the card and on the CPU (the
   plain path the CPU tests hold against the JAX reference): object counts
   within 1%, each feature column's mean within 1e-3 of the column's mean
   magnitude.

The last two lines are a JSON object of the kernels' counts, errors and
times, and ``{"ok": true, "device": {...}}``. The script needs no network,
JAX, pandas or sklearn (with sklearn importable, the forest is fitted by it;
without, a seeded numpy forest stands in).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SIZE = 4096
CROSS_SIZE = 512
BANDS = 8
N_SEGMENTS = 3000
N_TREES = 300


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def config4_scene(size: int) -> np.ndarray:
    """The config-4 scene exactly as bench.py builds it (8 uint8 bands)."""
    from bench import build_scene
    base3 = build_scene(h=size, w=size, c=4).astype(np.float32)
    more = np.stack([np.roll(base3[..., i % 4], 17 * (i + 1), axis=i % 2)
                     for i in range(4)], axis=-1)
    return np.concatenate([base3, more], axis=-1).astype(np.uint8)


def numpy_forest(X: np.ndarray, n_trees: int, depth: int = 8, seed: int = 0):
    """A random full binary forest (heap-ordered nodes) with thresholds
    drawn from the feature quantiles: the model when sklearn is absent."""
    from obia_tpu_torch.classification.forest import ForestArrays
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
    return ForestArrays.from_numpy(feature, threshold, left, right, proba,
                                   np.array([0, 1]), depth, device="cuda")


def featurize_classify(table, device, seed: int = 0) -> np.ndarray:
    """bench._featurize_classify on the port's table: features without
    all-NaN columns -> median-split target -> seeded 20% training subset ->
    fit -> predict_proba of every object."""
    import torch

    from obia_tpu_torch.classification.forest import forest_proba
    cols = [c for c in table.columns if c != "segment_id"]
    X = np.stack([table[c] for c in cols], axis=1).astype(np.float64)
    X = np.nan_to_num(X[:, ~np.isnan(X).all(axis=0)])
    y = (X[:, 0] > np.median(X[:, 0])).astype(int)
    n_train = max(10, int(len(X) * 0.2))
    idx = np.random.default_rng(seed).permutation(len(X))[:n_train]
    try:
        from obia_tpu_torch.classification.forest import \
            TorchForestClassifier
        clf = TorchForestClassifier(device=device, n_estimators=N_TREES,
                                    random_state=0)
    except ImportError:  # sklearn is not installed
        forest = numpy_forest(X[idx], N_TREES)
        return forest_proba(forest.to(device), torch.as_tensor(
            X, dtype=torch.float32, device=device)).cpu().numpy()
    clf.fit(X[idx], y[idx])
    return clf.predict_proba(X)


def run_slice(image, device):
    """segment + featurize/classify, synchronised; returns (segments,
    proba, seconds)."""
    import torch

    from obia_tpu_torch.segmentation.segment import segment
    t0 = time.perf_counter()
    s = segment(image, segmentation_bands=[0, 3, 6],
                statistics_bands=list(range(BANDS)), method="slic",
                n_segments=N_SEGMENTS, compactness=10, device=device)
    proba = featurize_classify(s.table, device)
    s.table.geometry  # join the polygonisation thread
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return s, proba, time.perf_counter() - t0


def glcm_inputs(image_t, labels, K, band):
    """The kernel's inputs for one band, as segment_glcm_props_packed
    builds them."""
    from obia_tpu_torch.ops import glcm
    mins = glcm.bbox_minmax(image_t, labels, K, (band,))
    mn = mins[:, 4].contiguous()
    inv = glcm.quant_inv(-mins[:, 5] - mn, 256).contiguous()
    offsets = glcm.angle_offsets(2, glcm.DEFAULT_ANGLES)
    return (labels, image_t, band, glcm._bboxes_from_mins(mins), mn, inv,
            256, offsets)


def compare_kernel(args, what: str) -> float:
    """Kernel vs twin on the same CUDA inputs; returns the max abs error."""
    import torch

    from obia_tpu_torch.ops import glcm_kernel
    before = glcm_kernel.launches
    isums, hsum = glcm_kernel.glcm_sums(*args)
    ri, rh = glcm_kernel.glcm_sums_reference(*args)
    torch.cuda.synchronize()
    glcm_kernel.launches = before  # comparison launches do not count
    d_int = int((isums - ri).abs().max())
    d_h = float((hsum - rh).abs().max())
    rel_h = float(((hsum - rh).abs() / rh.abs().clamp(min=1e-300)).max())
    log(f"  {what}: int sums max|diff| = {d_int}, sum 1/(1+d^2) "
        f"max|diff| = {d_h:.3e} (rel {rel_h:.3e}), pairs = "
        f"{int(isums[..., 0].sum())}")
    if d_int != 0 or not torch.allclose(hsum, rh, rtol=1e-6, atol=0):
        raise AssertionError(f"GLCM kernel disagrees with its twin ({what})")
    return max(float(d_int), d_h)


def edge_case_scene():
    """A small scene with every edge case: pixels outside every object
    (-1), an object id with no pixels, a constant-band object (inv = 0), a
    1-pixel object (no pairs), and objects on all four borders."""
    rng = np.random.default_rng(1)
    H, W, C = 70, 90, 3
    lab = (np.arange(H)[:, None] // 10 * 9 + np.arange(W)[None, :] // 10)
    lab = lab.astype(np.int32)
    lab[20:30, 30:40] = -1          # unlabelled hole
    lab[lab == 5] = 4               # id 5: empty
    lab[45, 45] = lab.max() + 1     # 1-pixel object
    img = rng.uniform(0, 1000, (H, W, C)).astype(np.float32)
    img[lab == 12] = 7.0            # constant object
    return img, lab, int(lab.max()) + 1


def time_ms(fn, n: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False)")
    card = card_line()
    log(f"card: {card}")
    sys.path.insert(0, ROOT)
    from obia_tpu.geometry.affine import Affine
    from obia_tpu_torch import _build, telemetry
    from obia_tpu_torch.handlers.geotif import image_from_array
    from obia_tpu_torch.ops import glcm_kernel
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.build(verbose=True)
    _build.load()
    log(f"build: {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.2f} s"
        f" (nvcc {_build.build_seconds} s)")

    # -- 3. kernel vs twin, edge cases ------------------------------------
    img, lab, K = edge_case_scene()
    img_t = torch.as_tensor(img, device="cuda")
    lab_t = torch.as_tensor(lab, device="cuda")
    err = 0.0
    for band in range(img.shape[2]):
        err = max(err, compare_kernel(glcm_inputs(img_t, lab_t, K, band),
                                      f"edge-case scene band {band}"))

    # -- 4. the config-4 slice at full width --------------------------------
    scene = config4_scene(SIZE)
    image = image_from_array(scene, Affine(1.0, 0, 0, 0, -1.0, SIZE),
                             crs="EPSG:32633")
    mp = SIZE * SIZE / 1e6
    s_cold, _, cold = run_slice(image, "cuda")
    glcm_kernel.launches = 0
    s, proba, warm = run_slice(image, "cuda")
    launches = glcm_kernel.launches
    n_obj = len(s.table)
    rle_cold, rle_warm = s_cold.layer.label_raster, s.layer.label_raster
    same_runs = (np.array_equal(rle_cold.values, rle_warm.values)
                 and np.array_equal(rle_cold.lengths, rle_warm.lengths))
    log(f"cold and warm label rasters identical: {same_runs}")
    log(f"slice {SIZE}^2 x {BANDS} bands: {n_obj} objects, cold {cold:.3f} s,"
        f" warm {warm:.3f} s, {mp / warm:.3f} MP/s warm; GLCM launches "
        f"{launches}")
    if launches < BANDS:
        raise AssertionError(f"{launches} GLCM launches, expected >= {BANDS}")
    if proba.shape[0] != n_obj or not np.allclose(proba.sum(1), 1.0,
                                                  atol=1e-5):
        raise AssertionError("predict_proba rows do not sum to 1")
    for b in range(BANDS):
        if np.isnan(s.table[f"b{b}_mean"]).any():
            raise AssertionError(f"b{b}_mean holds NaN")
    if len(s.table.geometry) != n_obj:
        raise AssertionError("geometry count != object count")

    telemetry.reset()
    telemetry.enable(True)
    _, _, prof = run_slice(image, "cuda")
    telemetry.enable(False)
    log(f"profiled run (device synced at every stage): {prof:.3f} s")
    for name, r in telemetry.report().items():
        log(f"  stage {name}: {1000 * r['total_s']:.1f} ms")

    labels = s.layer.labels_dev
    args = glcm_inputs(image.device_tensor("cuda"), labels, n_obj, 0)
    err = max(err, compare_kernel(args, f"{SIZE}^2 scene band 0"))
    before = glcm_kernel.launches
    ms = time_ms(lambda: glcm_kernel.glcm_sums(*args), 10)
    plain_ms = time_ms(lambda: glcm_kernel.glcm_sums_reference(*args), 3)
    glcm_kernel.launches = before
    log(f"GLCM one band at {SIZE}^2, K={n_obj}: kernel {ms:.3f} ms, "
        f"plain torch {plain_ms:.3f} ms ({card})")

    # -- 5. cross-check against the CPU plain path ------------------------
    small = config4_scene(CROSS_SIZE)
    im_small = image_from_array(small, Affine(1.0, 0, 0, 0, -1.0,
                                              CROSS_SIZE), crs="EPSG:32633")
    sg, _, _ = run_slice(im_small, "cuda")
    sc, _, _ = run_slice(im_small, "cpu")
    ng, nc = len(sg.table), len(sc.table)
    log(f"cross-check {CROSS_SIZE}^2: {ng} objects on the card, {nc} on the "
        f"CPU")
    if abs(ng - nc) > 0.01 * nc:
        raise AssertionError("object counts differ by more than 1%")
    same = float((sg.label_raster == sc.label_raster).mean())
    log(f"  label rasters agree on {same:.6f} of the pixels")
    # means are held to 1e-3 of the column's mean magnitude: a plain
    # relative bound is ill-conditioned for a mean near 0 (skewness)
    worst = ("", 0.0)
    for c in sc.table.columns:
        if not np.array_equal(np.isnan(sg.table[c]), np.isnan(sc.table[c])):
            raise AssertionError(f"column {c}: NaN slots differ")
        if np.isnan(sc.table[c]).all():
            continue  # the point-cloud slots: NaN by design
        a, b = np.nanmean(sg.table[c]), np.nanmean(sc.table[c])
        scale = np.nanmean(np.abs(sc.table[c]))
        rel = abs(a - b) / max(scale, 1e-12)
        if rel > worst[1]:
            worst = (c, rel)
        if not rel <= 1e-3:
            raise AssertionError(f"column {c}: mean {a} (card) vs {b} (CPU)")
    log(f"cross-check column means: worst |diff| / mean|value| "
        f"{worst[1]:.3e} ({worst[0]})")

    log(card_line())
    log(json.dumps({"kernels": [{
        "name": "glcm_sums", "route": "cuda",
        "source": "obia_tpu_torch/csrc/glcm.cu",
        "replaces": "obia_tpu/ops/glcm_pallas.py:220",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
