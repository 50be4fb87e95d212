#!/usr/bin/env python3
"""Smoke run of obia_tpu_torch on one NVIDIA GPU: build, check, drive.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. require a CUDA device and print its name and power limit (nvidia-smi);
2. build the CUDA kernels from ``obia_tpu_torch/csrc`` with nvcc, one
   process per source, all started together, and the port's host library
   (``obia_tpu_torch/native``: polygoniser, union-find) with g++;
3. hold the GLCM sums kernel against its plain-torch twin (integer sums and
   sum (C+C^T)^2 equal, sum 1/(1+d^2) within rtol 1e-6, two runs of the
   kernel identical) on an edge-case scene, on a scene of many small
   objects (1-60 px, boxes either side of the kernel's size classes) at
   L = 1, 2, 16 and 256 with 8 offsets, and on one object covering most of
   a raster with all 256 levels;
4. drive the config-4 slice of ``bench.py`` at 4096^2 x 8 bands on the card:
   ``segment`` (SLIC on bands 0/3/6, spectral + GLCM features of all 8
   bands) and a 300-tree forest ``predict_proba``, once cold and once warm,
   with the kernel launch counts read around the warm run, and the cold and
   warm runs' spectral columns identical where their label rasters are;
   then a profiled run for the stage split, the kernel against its twin on
   one band of that scene, and both timed with CUDA events;
5. cross-check: the same slice at 512^2 on the card and on the CPU (the
   plain path the CPU tests hold against the JAX reference): object counts
   within 1%, each feature column's mean within 1e-3 of the column's mean
   magnitude;
6. hold the quickshift density and parent kernels against their twins on
   edge-case scenes (ragged 70x300 C=3, 96x80 C=1, 64x64 C=8, a constant
   plateau) at radii 3, 15 and the density's largest, max_dist 0.6 r:
   density within rtol 1e-6, parent outputs exactly equal given the twin's
   rho, and the kernel pipeline's roots against the twin pipeline's
   (partition agreement >= 0.995); each kernel one past its own limit must
   raise (the density on r, the parent on its disk's radius rp);
7. drive the config-2 slice of ``bench.py`` at 1024^2 RGB on the card:
   ``segment(method="quickshift", ratio=1.0, kernel_size=5, max_dist=10.0)``
   (spectral + GLCM features of the 3 bands) and a (64,) MLP fitted for
   max_iter=60, then ``predict_proba``, once cold (profiled) and once warm,
   with the launch counts read around the warm run; a profiled warm run;
   both quickshift kernels against their twins at 1024^2 and at
   4096^2, and on the 8 bands of the config-4 scene at 1024^2 (the same
   radius and max_dist), and the GLCM sums kernel at this slice's object
   count, all timed with CUDA events;
8. cross-check: the config-2 slice at 256^2 on the card and on the CPU:
   object counts within 1%, label partitions agreeing on >= 99.5% of the
   pixels, column means as in phase 5;
9. hold the seam-spanner histogram kernel (``glcm_spanner_hist``: every
   shard's pieces of every spanner in one launch, the tables summed over
   the shards and their sum (C + C^T)^2) against its twin on an edge-case
   scene sharded 2 x 4 on the card (spanners across the row seam, a column
   seam and a corner of four shards, a constant-band spanner, a 1-pixel
   piece of a spanner on one shard) at 16 (one block), 180 (two), 255 (an
   odd row split over two) and 256 levels, and on a dense scene whose big
   spanner has more nonzero cells than a block lists (the whole-row scan)
   at 100, 180, 255 and 256 levels: every table entry and every sum equal,
   the sums
   of a launch that stores no table (as the main path launches it) equal
   too, two runs identical;
10. drive config 5 of ``bench.py`` at its real size (``OBIA_BENCH5_REAL=1``:
   4096^2 RGB, n_segments=3000, compactness=10) through ``mosaic_pipeline``
   on a 2 x 4 mesh of shards on the one card, once cold and once warm, with
   the launch counts read around the warm run (``glcm_sums`` >= 24,
   ``glcm_hist`` == 3, one a band) and the cold and warm runs' spectral
   columns identical where their label rasters are; a profiled run for the
   stage split; the histogram kernel against its twin on one band of that
   scene at 256, 16 and 255 levels, timed with CUDA events behind a queued
   sleep (the card's time, not the host's) as the main path launches it,
   with its tables stored, at 16 and 255 levels, and with every box
   emptied (no walk), and the twin; the GLCM sums kernel on one band of
   that scene (one launch per shard) against its twin, timed with CUDA
   events;
11. sharded against single-device on the card, on the same normalised
   image: SLIC labels (convert2lab=False) as partitions agreeing on
   >= 99.5% of the pixels, and every feature column of the mosaic against
   single-device ``create_objects`` on the mosaic's labels (rtol 2e-4,
   atol 1e-5);
12. cross-check: config 5 at 768^2 (``bench.py``'s default size for it) on
   the card and on the CPU, as in phase 8.

After the build a line gives the quickshift kernels' registers, spilled
bytes and pixels a thread (P) as the library reports them. The last two
lines are a JSON object of the kernels' launches, errors, times and bounds,
and ``{"ok": true, "device": {...}}``. A kernel's ``bound_ms`` is the larger
of the bytes it must move (each input read once, each output written once;
a band counts its own 4 bytes a pixel) over 3.35 TB/s and its operations
over 67 TFLOP/s float32, from this run's shapes. The quickshift scans count
the pixel-offset pairs whose neighbour lies in the image (the parent's
offsets only those of the max_dist disk) at 3C + 4 float32 operations, and
the density's exponentials apart, over the SFU's 16 a clock per SM (4.18 T/s
at 1.98 GHz); their ``bound_term`` names the larger term ("fp32", "sfu" or
"bytes"; ``bound_by`` says "operations" for either of the first two).
``glcm_hist``'s bound charges the labels and band of each piece's box and
its 2-pixel halo (8 bytes a pixel), the work list, and the sums written
once, as the main path launches it (no tables); ``bound_ms_tables`` adds
the summed tables written once. ``glcm_sums`` also reports
``bound_ms_layout``: the same with the band charged the 32-byte sectors that
hold it in the interleaved (H, W, C) image, the least a kernel that reads
the band in place can take. No one
PyTorch call computes any of the four, so ``library_ms`` is null. The
script needs no network, JAX, pandas or sklearn (with sklearn importable,
the forest is fitted by it; without, a seeded numpy forest stands in; the
MLP needs neither), and imports nothing of the JAX package.
"""
from __future__ import annotations

import json
import math
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
QS_SIZE = 1024          # config 2's own size (bench.py)
QS_CROSS_SIZE = 256
QS_BIG = 4096           # the kernels alone, as the JAX package timed them
QS_KW = dict(method="quickshift", ratio=1.0, kernel_size=5, max_dist=10.0)
C5_SIZE = 4096          # bench.py config 5 with OBIA_BENCH5_REAL=1
C5_CROSS_SIZE = 768     # bench.py's default size for config 5
C5_SHARDS = 8           # the 2 x 4 mesh
HBM_BYTES_PER_MS = 3.35e9   # H100 SXM: 3.35 TB/s
FP32_OPS_PER_MS = 67e9      # H100 SXM: 67 TFLOP/s float32 outside the MMAs
SFU_OPS_PER_MS = 132 * 16 * 1.98e6  # 132 SMs x 16 exponentials a clock


def log(msg: str) -> None:
    print(msg, flush=True)


def build_scene(h=2048, w=2048, c=3, seed=0):
    """bench.py's synthetic scene (smooth bands plus noise, uint8), copied
    so the script needs nothing of the repo's JAX side; a CPU test holds the
    two equal."""
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


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def config4_scene(size: int) -> np.ndarray:
    """The config-4 scene exactly as bench.py builds it (8 uint8 bands)."""
    base3 = build_scene(h=size, w=size, c=4).astype(np.float32)
    more = np.stack([np.roll(base3[..., i % 4], 17 * (i + 1), axis=i % 2)
                     for i in range(4)], axis=-1)
    return np.concatenate([base3, more], axis=-1).astype(np.uint8)


def as_image(scene: np.ndarray):
    from obia_tpu_torch.geometry.affine import Affine
    from obia_tpu_torch.handlers.geotif import image_from_array
    h = scene.shape[0]
    return image_from_array(scene, Affine(1.0, 0, 0, 0, -1.0, h),
                            crs="EPSG:32633")


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


def training_table(table, seed: int = 0):
    """bench._featurize_classify's table: features without all-NaN columns,
    median-split target, seeded 20% training subset."""
    cols = [c for c in table.columns if c != "segment_id"]
    X = np.stack([table[c] for c in cols], axis=1).astype(np.float64)
    X = np.nan_to_num(X[:, ~np.isnan(X).all(axis=0)])
    y = (X[:, 0] > np.median(X[:, 0])).astype(int)
    n_train = max(10, int(len(X) * 0.2))
    idx = np.random.default_rng(seed).permutation(len(X))[:n_train]
    return X, y, idx


def featurize_classify(table, device, seed: int = 0) -> np.ndarray:
    """Config 4's classify tail: fit a forest -> predict_proba of every
    object."""
    import torch

    from obia_tpu_torch.classification.forest import forest_proba
    X, y, idx = training_table(table, seed)
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


def mlp_classify(table, device, seed: int = 0) -> np.ndarray:
    """Config 2's classify tail: fit a (64,) MLP for max_iter=60 ->
    predict_proba of every object."""
    from obia_tpu_torch import telemetry
    from obia_tpu_torch.classification.mlp import TorchMLPClassifier
    X, y, idx = training_table(table, seed)
    clf = TorchMLPClassifier(hidden_layer_sizes=(64,), max_iter=60,
                             random_state=0, device=device)
    with telemetry.stage("classify.fit"):
        clf.fit(X[idx], y[idx])
    with telemetry.stage("classify.predict"):
        return clf.predict_proba(X)


def run_slice(image, device):
    """Config 4: segment + featurize/classify, synchronised; returns
    (segments, proba, seconds)."""
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


def run_config2(image, device):
    """Config 2: quickshift segment + MLP fit/predict, synchronised; returns
    (segments, proba, seconds)."""
    import torch

    from obia_tpu_torch.segmentation.segment import segment
    t0 = time.perf_counter()
    s = segment(image, device=device, **QS_KW)
    proba = mlp_classify(s.table, device)
    s.table.geometry  # join the polygonisation thread
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return s, proba, time.perf_counter() - t0


def run_config5(image, device):
    """Config 5: ``mosaic_pipeline`` over a 2 x 4 mesh of shards on
    ``device``, synchronised; returns (result, None, seconds), the result
    with the object table, the layer and the host label raster."""
    import types

    import torch

    from obia_tpu_torch.parallel.mesh import make_mesh
    from obia_tpu_torch.parallel.mosaic import mosaic_pipeline
    t0 = time.perf_counter()
    objects = mosaic_pipeline(image, n_segments=N_SEGMENTS, compactness=10.0,
                              mesh=make_mesh(C5_SHARDS, [device]))
    objects.geometry  # join the polygonisation thread
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return types.SimpleNamespace(
        table=objects, layer=objects.layer,
        label_raster=np.asarray(objects.layer.label_raster)), None, seconds


def seam_scene():
    """A 32 x 48 scene for the 2 x 4 mesh (16 x 12 shards): small grid
    objects, spanners across the row seam, a column seam and a corner of
    four shards, a constant-band spanner (quantiser inverse 0), a spanner
    with a 1-pixel piece on one shard, and a masked hole."""
    rng = np.random.default_rng(3)
    lab = (np.arange(32)[:, None] // 5 * 10
           + np.arange(48)[None, :] // 5).astype(np.int32)
    lab[12:20, 8:16] = 100
    lab[2:8, 20:28] = 101
    lab[14:19, 30:34] = 102
    lab[20:30, 34:40] = 103
    lab[3:16, 44:48] = 104
    lab[16, 45] = 104
    lab[24:26, 4:6] = -1
    ids, inv = np.unique(lab, return_inverse=True)
    lab = inv.reshape(lab.shape).astype(np.int32) - int(ids[0] < 0)
    img = rng.integers(0, 256, (32, 48, 2)).astype(np.float32)
    img[lab == lab[20, 36]] = 5.0
    return img, lab, int(lab.max()) + 1


def dense_scene():
    """A 128 x 192 scene of random levels for the 2 x 4 mesh: one object over
    nearly all of it (every shard) and two small spanners. At an angle the
    big one's table has more nonzero cells than a block of the kernel lists
    (8,895 at L = 100; ~7,900 a half at L = 180, ~9,900 at 255 and 256)."""
    rng = np.random.default_rng(3)
    lab = np.zeros((128, 192), np.int32)
    lab[:8, :8] = 1
    lab[60:70, 40:50] = 2
    lab[100:110, 140:190] = 3
    img = rng.integers(0, 256, (128, 192, 2)).astype(np.float32)
    return img, lab, 4


def shard_calls(mesh, image_sh, labels_sh, K, levels, band):
    """The glcm_sums arguments of every shard and the glcm_spanner_hist
    arguments of the band, as ``sharded_glcm_sums`` builds them for one band
    on a mesh on one device."""
    import torch

    from obia_tpu_torch.ops import glcm
    from obia_tpu_torch.parallel import glcm_sharded as gs
    mins, multi, present = gs.glcm_prepass(mesh, image_sh, labels_sh, K,
                                           (band,))
    mn = mins[:, 4].contiguous()
    inv = glcm.quant_inv(-mins[:, 5] - mn, levels).contiguous()
    shards = gs.shard_inputs(mesh, image_sh, labels_sh,
                             glcm._bboxes_from_mins(mins), multi, present, 2)
    offsets = glcm.angle_offsets(2, glcm.DEFAULT_ANGLES)
    sums = [(lab_h, img_h, band, loc, mn, inv, levels, offsets)
            for lab_h, img_h, loc, _, _ in shards.values()]
    (labs, imgs, work), = gs.spanner_groups(
        mesh, shards, torch.nonzero(multi).reshape(-1))
    return sums, (labs, imgs, band, work, mn, inv, levels, offsets)


def band_bytes(image, layout: bool = False) -> int:
    """The bytes of one band of an (H, W, C) float32 image: its own 4 a
    pixel, or with ``layout`` the 32-byte sectors that hold it in the
    interleaved image (all of the image for C <= 8)."""
    H, W, C = image.shape
    return H * W * (min(4 * C, 32) if layout else 4)


def sums_bound_ms(calls, layout: bool = False) -> float:
    """Least time of glcm_sums over ``calls``: labels, the band (see
    :func:`band_bytes`), boxes and quantisers read once, (A, K, 7) int64 +
    (A, K) float64 written once, at 3.35 TB/s (its integer work is far
    under the bytes)."""
    total = 0
    for labels, image, _, boxes, _, _, _, offsets in calls:
        K, A = boxes.shape[0], len(offsets)
        total += (4 * labels.numel() + band_bytes(image, layout) + 24 * K
                  + 64 * A * K)
    return total / HBM_BYTES_PER_MS


def hist_bound_ms(args, halo: int = 2, tables: bool = False) -> float:
    """Least time of one glcm_spanner_hist call as the main path makes it:
    the labels and the band of each piece's box and its ``halo``-pixel
    border, clipped to the block, read once (8 bytes a pixel), the work list
    and the spanners' quantisers read once, and the (A, M) int64 sums
    (C + C^T)^2 written once, at 3.35 TB/s; with ``tables`` also the
    (M, L, A*L) int32 summed tables written once, as a caller that asks for
    them makes it."""
    labs, _, _, work, _, _, levels, offsets = args
    H, W = labs[0].shape
    b = work.pieces[:, 1:].long().cpu()
    rows = ((b[:, 1] + halo).clamp(max=H - 1)
            - (b[:, 0] - halo).clamp(min=0) + 1).clamp(min=0)
    cols = ((b[:, 3] + halo).clamp(max=W - 1)
            - (b[:, 2] - halo).clamp(min=0) + 1).clamp(min=0)
    M, P, A = work.ids.numel(), work.pieces.shape[0], len(offsets)
    read = 8 * int((rows * cols).sum()) + 4 * (2 * M + 1) + 20 * P + 8 * M
    written = 8 * A * M + (4 * M * levels * A * levels if tables else 0)
    return (read + written) / HBM_BYTES_PER_MS


def qs_bound(x, radius: int, max_dist=None) -> dict:
    """Least time of a quickshift window scan over the (C, H, W) image:
    the density (``max_dist`` None) over its (2r+1)^2 - 1 window, the parent
    over the offsets of its max_dist disk, each counting the pixel-offset
    pairs whose neighbour lies in the image. The longest of: 3C + 4 float32
    operations a pair (d2, then the weight or the comparisons) over
    67 TFLOP/s ("fp32"); the density's one exponential a pair over the
    SFU's 4.18 T/s ("sfu"); the image and rho read and the outputs written
    once over 3.35 TB/s ("bytes"). Returns bound_ms, bound_by, bound_term
    and the pairs."""
    from obia_tpu_torch.ops import quickshift_kernel as qk
    C, H, W = x.shape
    if max_dist is None:
        offsets, outputs = qk.window_offsets(radius), 0
    else:
        offsets, outputs = qk.disk_offsets(radius, max_dist), 2
    offsets = np.abs(offsets.astype(np.int64))
    pairs = int((np.clip(H - offsets[:, 0], 0, None)
                 * np.clip(W - offsets[:, 1], 0, None)).sum())
    terms = {"fp32": pairs * (3 * C + 4) / FP32_OPS_PER_MS,
             "sfu": (pairs if max_dist is None else 0) / SFU_OPS_PER_MS,
             "bytes": 4 * H * W * (C + 1 + outputs) / HBM_BYTES_PER_MS}
    term = max(terms, key=terms.get)
    return {"bound_ms": terms[term],
            "bound_by": "bytes" if term == "bytes" else "operations",
            "bound_term": term, "pairs": pairs}


def compare_hist(args, what: str) -> int:
    """glcm_spanner_hist against its twin on one call, with its tables and
    without them (as the main path calls it), and two kernel runs against
    each other; returns the max abs difference of the tables and the sums
    (C + C^T)^2 (0 or it raises)."""
    import torch

    from obia_tpu_torch.ops import glcm_kernel
    before = glcm_kernel.hist_launches
    got, got_sq = glcm_kernel.glcm_spanner_hist(*args)
    again, again_sq = glcm_kernel.glcm_spanner_hist(*args)
    none, main_sq = glcm_kernel.glcm_spanner_hist(*args, tables=False)
    want, want_sq = glcm_kernel.glcm_spanner_hist_reference(*args)
    torch.cuda.synchronize()
    calls = glcm_kernel.hist_launches - before
    glcm_kernel.hist_launches = before  # comparison launches do not count
    work = args[3]
    M = work.ids.numel()
    err = (max(int((got.long() - want.long()).abs().max()),
               int((got_sq - want_sq).abs().max()),
               int((main_sq - want_sq).abs().max())) if M else 0)
    same = torch.equal(got, again) and torch.equal(got_sq, again_sq)
    log(f"  {what}: {M} spanners, {work.pieces.shape[0]} pieces on "
        f"{len(args[0])} shards, {int(want.sum())} pairs; tables and sums "
        f"(C+C^T)^2 max|diff| {err} (sums without tables included); two "
        f"runs identical: {same}")
    if err != 0 or M == 0 or none is not None:
        raise AssertionError(f"GLCM histogram kernel disagrees with its twin"
                             f" or saw no spanner ({what})")
    if not same or calls != 3:
        raise AssertionError(f"GLCM histogram kernel runs differ or "
                             f"miscount ({what})")
    return err


def hist_times(mesh_labels, image_sh, K, args) -> dict:
    """CUDA-event times of glcm_spanner_hist on one band of config 5, as the
    main path calls it (no tables) at L = 256, and beside it: with the
    tables stored, at L = 16 and 255, with every box emptied (launch,
    table zeroing and the epilogue, no walk), and the twin. Every kernel
    result is held to the twin first. Returns the glcm_hist JSON entry's
    numbers; the launches here are not counted."""
    import torch

    from obia_tpu_torch.ops import glcm_kernel
    before = glcm_kernel.hist_launches
    work = args[3]
    empty = work.pieces.clone()
    empty[:, 1], empty[:, 2] = 1, 0  # rmin > rmax: a box with no pixel
    no_walk = (*args[:3], glcm_kernel.SpannerPieces(work.ids, work.ptr,
                                                    empty), *args[4:])
    _, got = glcm_kernel.glcm_spanner_hist(*no_walk, tables=False)
    if int(got.abs().sum()) != 0:
        raise AssertionError("empty boxes gave a nonzero sum")
    by_level = {}
    for levels in (16, 255):
        a = shard_calls(mesh_labels.mesh, image_sh, mesh_labels, K, levels,
                        0)[1]
        compare_hist(a, f"config 5 band 0, L={levels}")
        by_level[levels] = time_ms(
            lambda: glcm_kernel.glcm_spanner_hist(*a, tables=False), 10,
            queued=True)
    out = {
        "ms": time_ms(lambda: glcm_kernel.glcm_spanner_hist(
            *args, tables=False), 10, queued=True),
        "plain_ms": time_ms(
            lambda: glcm_kernel.glcm_spanner_hist_reference(*args), 3),
        "bound_ms": hist_bound_ms(args),
        "ms_unqueued": time_ms(lambda: glcm_kernel.glcm_spanner_hist(
            *args, tables=False), 10),
        "ms_tables": time_ms(lambda: glcm_kernel.glcm_spanner_hist(*args),
                             10, queued=True),
        "bound_ms_tables": hist_bound_ms(args, tables=True),
        "ms_l16": by_level[16], "ms_l255": by_level[255],
        "ms_no_walk": time_ms(lambda: glcm_kernel.glcm_spanner_hist(
            *no_walk, tables=False), 10, queued=True)}
    glcm_kernel.hist_launches = before
    b = work.pieces[:, 1:].long().cpu()
    px = ((b[:, 1] - b[:, 0] + 1).clamp(min=0)
          * (b[:, 3] - b[:, 2] + 1).clamp(min=0))
    per = torch.zeros(work.ids.numel(), dtype=torch.int64).index_add_(
        0, torch.repeat_interleave(torch.arange(work.ids.numel()),
                                   (work.ptr[1:] - work.ptr[:-1]).long().cpu()),
        px)
    log(f"  the walk: {int(px.sum())} box pixels an angle, the largest "
        f"spanner's {int(per.max())}, the largest piece's {int(px.max())}, "
        f"median spanner {int(per.median())}")
    log(f"GLCM spanner histogram, one band of config 5 (one launch, "
        f"{work.ids.numel()} spanners, {work.pieces.shape[0]} pieces), as "
        f"the main path calls it (L=256, no tables), card time with the "
        f"launches queued: kernel {out['ms']:.4f} ms (unqueued "
        f"{out['ms_unqueued']:.4f}), plain torch {out['plain_ms']:.3f} ms, "
        f"bound {out['bound_ms']:.4f} ms; tables stored "
        f"{out['ms_tables']:.4f} ms "
        f"(bound {out['bound_ms_tables']:.4f}); L=16 {out['ms_l16']:.4f} "
        f"ms, L=255 {out['ms_l255']:.4f} ms; every box empty "
        f"{out['ms_no_walk']:.4f} ms ({card_line()})")
    return out


SPECTRAL = ("mean", "variance", "min", "max", "skewness", "kurtosis")


def check_spectral_runs(cold, warm, same_labels: bool, what: str) -> None:
    """The cold and warm runs' spectral columns bitwise equal (NaN slots
    included) when their label rasters are: the moment sums are float64,
    rounded once, so the card's atomics cannot move them."""
    if not same_labels:
        log(f"  {what}: label rasters differ; spectral columns not compared")
        return
    cols = [c for c in warm.columns if c.split("_", 1)[-1] in SPECTRAL]
    differ = [c for c in cols
              if not np.array_equal(cold[c], warm[c], equal_nan=True)]
    log(f"  {what}: {len(cols)} spectral columns of the cold and warm runs "
        f"identical: {not differ}")
    if differ or not cols:
        raise AssertionError(f"spectral columns differ between the cold and "
                             f"warm runs ({what}): {differ[:4]}")


def glcm_inputs(image_t, labels, K, band, levels=256, offsets=None):
    """The kernel's inputs for one band, as segment_glcm_props_packed
    builds them (the four default angles at distance 2 unless
    ``offsets``)."""
    from obia_tpu_torch.ops import glcm
    mins = glcm.bbox_minmax(image_t, labels, K, (band,))
    mn = mins[:, 4].contiguous()
    inv = glcm.quant_inv(-mins[:, 5] - mn, levels).contiguous()
    if offsets is None:
        offsets = glcm.angle_offsets(2, glcm.DEFAULT_ANGLES)
    return (labels, image_t, band, glcm._bboxes_from_mins(mins), mn, inv,
            levels, offsets)


def compare_kernel(args, what: str) -> float:
    """Kernel vs twin on the same CUDA inputs, and two kernel runs against
    each other; returns the max abs error."""
    import torch

    from obia_tpu_torch.ops import glcm_kernel
    before = glcm_kernel.launches
    isums, hsum = glcm_kernel.glcm_sums(*args)
    isums2, hsum2 = glcm_kernel.glcm_sums(*args)
    ri, rh = glcm_kernel.glcm_sums_reference(*args)
    torch.cuda.synchronize()
    calls = glcm_kernel.launches - before
    glcm_kernel.launches = before  # comparison launches do not count
    d_int = int((isums - ri).abs().max()) if isums.numel() else 0
    d_h = float((hsum - rh).abs().max()) if hsum.numel() else 0.0
    rel_h = (float(((hsum - rh).abs() / rh.abs().clamp(min=1e-300)).max())
             if hsum.numel() else 0.0)
    same = torch.equal(isums, isums2) and torch.equal(hsum, hsum2)
    log(f"  {what}: int sums max|diff| = {d_int}, sum 1/(1+d^2) "
        f"max|diff| = {d_h:.3e} (rel {rel_h:.3e}), pairs = "
        f"{int(isums[..., 0].sum())}; two runs identical: {same}")
    if d_int != 0 or not torch.allclose(hsum, rh, rtol=1e-6, atol=0):
        raise AssertionError(f"GLCM kernel disagrees with its twin ({what})")
    if not same or calls != 2:
        raise AssertionError(f"GLCM kernel runs differ or miscount ({what})")
    return max(float(d_int), d_h)


def kernel_split(fn, what: str) -> dict:
    """Device time of each CUDA kernel that one call of ``fn`` starts, from
    ``torch.profiler`` (us by kernel name); logs it, and logs that the
    trace held no device time if three traces in a row held none (a trace
    of a short call can come back empty)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    split = {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = getattr(e, "cuda_time_total", 0.0)
            if us > 0:
                split[e.key] = split.get(e.key, 0.0) + float(us)
        if split:
            break
    if split:
        log(f"  {what} (torch.profiler, one call): " + ", ".join(
            f"{k[:40]} {v:.1f} us" for k, v in sorted(
                split.items(), key=lambda kv: -kv[1])))
    else:
        log(f"  {what}: the profiler trace held no device time")
    return split


def small_objects_scene(seed: int = 5):
    """Many small objects: rectangles of 1-60 px with 10% of the pixels
    unlabelled, a constant one, and solid objects whose boxes hold 255 and
    256 px (the small class, up to 224 pairs at an angle) and 257 and 272 px
    (the large class)."""
    rng = np.random.default_rng(seed)
    H, W = 120, 300
    lab = np.full((H, W), -1, np.int64)
    lab[2:17, 2:19] = 0            # 15 x 17 = 255 px
    lab[20:36, 2:18] = 1           # 16 x 16 = 256 px
    lab[40, 5:262] = 2             # 1 x 257 px
    lab[44:60, 2:19] = 3           # 16 x 17 = 272 px
    nxt, r = 4, 62
    while r < H:                   # rows of random rectangles below them
        h = int(rng.integers(1, 7))
        c = 0
        while c < W:
            w = int(rng.integers(1, 11))
            lab[r:r + h, c:c + w] = nxt
            nxt, c = nxt + 1, c + w
        r += h
    for r0 in range(2, 34, 6):     # and beside them
        for c0 in range(25, W, 9):
            lab[r0:r0 + int(rng.integers(1, 7)),
                c0:c0 + int(rng.integers(1, 10))] = nxt
            nxt += 1
    lab[(rng.random((H, W)) < 0.1) & (lab > 3)] = -1
    ids, inv = np.unique(lab, return_inverse=True)
    lab = (inv.reshape(H, W) - int(ids[0] < 0)).astype(np.int32)
    img = rng.integers(0, 256, (H, W, 2)).astype(np.float32)
    img[lab == lab[70, 5]] = 9.0   # a constant object
    return img, lab, int(lab.max()) + 1


def big_object_scene(seed: int = 6):
    """One object over most of a 300 x 420 raster, values over all 256
    levels, a ring of unlabelled pixels and a few small objects."""
    rng = np.random.default_rng(seed)
    H, W = 300, 420
    lab = np.zeros((H, W), np.int32)
    lab[:3] = -1
    lab[:, -2:] = -1
    lab[100:104, 200:210] = 1
    lab[250:251, 20:40] = 2
    img = rng.uniform(0, 1000, (H, W, 1)).astype(np.float32)
    return img, lab, 3




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


def time_ms(fn, n: int, queued: bool = False) -> float:
    """Mean ms of ``fn`` over n calls between two CUDA events. With
    ``queued`` the stream first waits on a ~20 ms sleep kernel, so the n
    calls are all enqueued before the start event runs and the time is the
    card's alone, not the host's launch rate."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def partition_agreement(a: np.ndarray, b: np.ndarray) -> float:
    """Share of pixels whose segment is the same pixel set in both label
    rasters (ids may differ)."""
    a = np.unique(a.ravel(), return_inverse=True)[1]
    b = np.unique(b.ravel(), return_inverse=True)[1]
    pair = a.astype(np.int64) * (b.max() + 1) + b
    _, pinv, pcount = np.unique(pair, return_inverse=True,
                                return_counts=True)
    both = pcount[pinv]
    return float(((both == np.bincount(a)[a])
                  & (both == np.bincount(b)[b])).mean())


def check_column_means(gpu_table, cpu_table) -> None:
    """Each feature column's mean on the card within 1e-3 of the column's
    mean magnitude on the CPU, with the NaN slots equal (a plain relative
    bound is ill-conditioned for a mean near 0, e.g. skewness)."""
    worst = ("", 0.0)
    for c in cpu_table.columns:
        if not np.array_equal(np.isnan(gpu_table[c]),
                              np.isnan(cpu_table[c])):
            raise AssertionError(f"column {c}: NaN slots differ")
        if np.isnan(cpu_table[c]).all():
            continue  # the point-cloud slots: NaN by design
        a, b = np.nanmean(gpu_table[c]), np.nanmean(cpu_table[c])
        scale = np.nanmean(np.abs(cpu_table[c]))
        rel = abs(a - b) / max(scale, 1e-12)
        if rel > worst[1]:
            worst = (c, rel)
        if not rel <= 1e-3:
            raise AssertionError(f"column {c}: mean {a} (card) vs {b} (CPU)")
    log(f"  column means: worst |diff| / mean|value| {worst[1]:.3e} "
        f"({worst[0]})")


def cross_check(run, scene, what: str) -> None:
    """The slice on the card and on the CPU: counts within 1%, label
    partitions agreeing on >= 99.5% of the pixels, column means close."""
    image = as_image(scene)
    sg, _, _ = run(image, "cuda")
    sc, _, _ = run(image, "cpu")
    ng, nc = len(sg.table), len(sc.table)
    agree = partition_agreement(sg.label_raster, sc.label_raster)
    same = float((sg.label_raster == sc.label_raster).mean())
    log(f"cross-check {what}: {ng} objects on the card, {nc} on the CPU; "
        f"label rasters agree on {same:.6f} of the pixels, partitions on "
        f"{agree:.6f}")
    if abs(ng - nc) > 0.01 * nc:
        raise AssertionError("object counts differ by more than 1%")
    if agree < 0.995:
        raise AssertionError(f"partition agreement {agree} < 0.995")
    check_column_means(sg.table, sc.table)


def qs_scenes():
    """(C, H, W) edge-case scenes for the quickshift kernels."""
    rng = np.random.default_rng(11)
    return {
        "ragged 70x300 C=3": rng.random((3, 70, 300)).astype(np.float32),
        "96x80 C=1": rng.random((1, 96, 80)).astype(np.float32),
        "64x64 C=8": rng.random((8, 64, 64)).astype(np.float32),
        "plateau 64x64 C=3": np.full((3, 64, 64), 0.5, np.float32),
    }


def qs_compare(x, radius: int, k: float, md: float, noise, what: str):
    """Both quickshift kernels against their twins on the same CUDA inputs:
    the density within rtol 1e-6, the parent outputs equal given the twin's
    rho, and the kernel pipeline's roots against the twin pipeline's.
    Returns (density max abs err, parent max abs err, root agreement)."""
    import torch

    from obia_tpu_torch.ops import quickshift_kernel as qk
    from obia_tpu_torch.ops.quickshift import flatten_tree
    before = dict(qk.launches)
    rho_k = qk.quickshift_density(x, radius, k)
    rho_t = qk.quickshift_density_reference(x, radius, k)
    rn_t = rho_t + noise
    d2_k, off_k = qk.quickshift_parent(x, rn_t, radius, md)
    d2_t, off_t = qk.quickshift_parent_reference(x, rn_t, radius, md)
    # the pipelines end to end: kernel -> kernel vs twin -> twin
    root_k = flatten_tree(qk.quickshift_parent(x, rho_k + noise, radius,
                                               md)[1])[0]
    root_t = flatten_tree(off_t)[0]
    torch.cuda.synchronize()
    qk.launches.update(before)  # comparison launches do not count
    d_rho = float((rho_k - rho_t).abs().max())
    rel = float(((rho_k - rho_t).abs() / rho_t.abs()).max())
    same_d2 = torch.equal(d2_k, d2_t)
    same_off = torch.equal(off_k, off_t)
    fin = torch.isfinite(d2_t)
    d_d2 = (float((d2_k[fin] - d2_t[fin]).abs().max()) if bool(fin.any())
            else 0.0)
    agree = partition_agreement(root_k.cpu().numpy(), root_t.cpu().numpy())
    log(f"  {what}, r={radius}: density max|diff| {d_rho:.3e} (rel "
        f"{rel:.3e}); parent d2 equal {same_d2}, offsets equal {same_off} "
        f"({int((off_t != 0).sum())} linked); roots: partition agreement "
        f"{agree:.6f}")
    if not torch.allclose(rho_k, rho_t, rtol=1e-6, atol=0):
        raise AssertionError(f"density kernel disagrees ({what}, r={radius})")
    if not (same_d2 and same_off):
        raise AssertionError(f"parent kernel disagrees ({what}, r={radius})")
    if agree < 0.995:
        raise AssertionError(f"root partition agreement {agree} < 0.995 "
                             f"({what}, r={radius})")
    return d_rho, (0.0 if same_d2 else d_d2), agree


def qs_inputs(scene: np.ndarray):
    """The scaled (C, H, W) image and tie noise that config 2's segment()
    hands the quickshift kernels for this (H, W, C) scene: Lab of three
    bands, the normalised bands themselves otherwise (as ``quickshift``
    converts only a three-band image)."""
    import torch

    from obia_tpu_torch.ops.color import rgb_to_lab
    from obia_tpu_torch.ops.quickshift import _tie_noise
    from obia_tpu_torch.segmentation.segment_boundaries import \
        _normalize_select
    img = _normalize_select(torch.as_tensor(scene, device="cuda").float(),
                            list(range(scene.shape[2])))
    if scene.shape[2] == 3:
        img = rgb_to_lab(img)
    x = (img * QS_KW["ratio"]).permute(2, 0, 1).contiguous()
    return x, _tie_noise(42, scene.shape[:2], "cuda")


def qs_time(x, noise, what: str, n: int):
    """CUDA-event times of both kernels and both twins on the same inputs;
    returns (density err, parent err, ms density, plain ms density, ms
    parent, plain ms parent)."""
    from obia_tpu_torch.ops import quickshift_kernel as qk
    k, md, r = QS_KW["kernel_size"], QS_KW["max_dist"], 15
    errs = qs_compare(x, r, k, md, noise, what)
    rn = qk.quickshift_density_reference(x, r, k) + noise
    before = dict(qk.launches)
    t = (time_ms(lambda: qk.quickshift_density(x, r, k), n),
         time_ms(lambda: qk.quickshift_density_reference(x, r, k), 1),
         time_ms(lambda: qk.quickshift_parent(x, rn, r, md), n),
         time_ms(lambda: qk.quickshift_parent_reference(x, rn, r, md), 1))
    qk.launches.update(before)
    log(f"  {what}: density kernel {t[0]:.3f} ms, twin {t[1]:.3f} ms; "
        f"parent kernel {t[2]:.3f} ms, twin {t[3]:.3f} ms")
    return errs[0], errs[1], *t


def sharded_vs_single(r5, image, device: str = "cuda") -> None:
    """Config 5's sharded run against the single-device path on the card:
    SLIC on the same normalised image (partitions >= 99.5%), and every
    feature column of the mosaic against single-device ``create_objects``
    on the mosaic's own labels."""
    from obia_tpu_torch.ops.slic import slic_dense
    from obia_tpu_torch.segmentation.segment_boundaries import (
        SegmentLayer, _normalize_select)
    from obia_tpu_torch.segmentation.segment_statistics import create_objects
    norm = _normalize_select(image.device_tensor(device),
                             list(range(image.img_data.shape[2])))
    single, k_single = slic_dense(norm, n_segments=N_SEGMENTS,
                                  compactness=10.0, convert2lab=False)
    single = single.cpu().numpy()
    agree = partition_agreement(r5.label_raster, single)
    same = float((r5.label_raster == single).mean())
    log(f"sharded vs single-device SLIC: {len(r5.table)} vs {k_single} "
        f"objects; labels equal on {same:.6f} of the pixels, partitions on "
        f"{agree:.6f}")
    if agree < 0.995:
        raise AssertionError(f"sharded/single partition agreement {agree}")
    lay = r5.layer
    plain = SegmentLayer(len(lay), lay.geometry, lay.crs, lay.transform,
                         lay.affine_transformation, lay.label_raster,
                         lay.labels_dev)
    want = create_objects(plain, image)
    worst = ("", 0.0)
    for c in want.columns:
        a, b = r5.table[c], want[c]
        if not np.array_equal(np.isnan(a), np.isnan(b)):
            raise AssertionError(f"column {c}: NaN slots differ")
        if np.isnan(b).all():
            continue  # the point-cloud slots: NaN by design
        excess = np.nanmax(np.abs(a - b) / (1e-5 + 2e-4 * np.abs(b)))
        if excess > worst[1]:
            worst = (c, float(excess))
        if not excess <= 1.0:
            raise AssertionError(f"column {c}: sharded and single-device "
                                 f"features differ")
    log(f"  sharded vs single-device features: worst |diff| / (atol + "
        f"2e-4 |value|) {worst[1]:.3e} ({worst[0]})")


def profiled(run, image, what: str):
    """``run`` on the card with the telemetry on (the device synced at every
    stage); logs every stage and returns what ``run`` returns."""
    from obia_tpu_torch import telemetry
    telemetry.reset()
    telemetry.enable(True)
    try:
        out = run(image, "cuda")
    finally:
        telemetry.enable(False)
    log(f"{what} (device synced at every stage): {out[2]:.3f} s")
    for name, r in telemetry.report().items():
        log(f"  stage {name}: {1000 * r['total_s']:.1f} ms")
    return out


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False)")
    card = card_line()
    log(f"card: {card}")
    sys.path.insert(0, ROOT)
    from obia_tpu_torch import _build, native
    from obia_tpu_torch.classification import forest as tforest
    from obia_tpu_torch.ops import glcm_kernel
    from obia_tpu_torch.ops import quickshift_kernel as qk
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.build(verbose=True)
    _build.load()
    log(f"build: {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.2f} s"
        f" (nvcc {_build.build_seconds} s)")
    t0 = time.perf_counter()
    host_lib = native.build()
    native.load()
    log(f"native library built and loaded: {host_lib.relative_to(ROOT)} in "
        f"{time.perf_counter() - t0:.2f} s (g++)")
    for C in (1, 3, 8, 9):
        a = qk.kernel_attributes(C)
        log(f"quickshift kernels, C={C}: " + "; ".join(
            f"{k} {v['registers']} registers, {v['local_bytes']} B local, "
            f"P = {v['strip']}" for k, v in a.items()))
        if {v["strip"] for v in a.values()} != {qk.STRIP}:
            raise AssertionError(f"kernel strip {a} != the wrapper's "
                                 f"{qk.STRIP}")

    # -- 3. GLCM sums kernel vs twin: edge cases, small objects, one big ----
    img, lab, K = edge_case_scene()
    img_t = torch.as_tensor(img, device="cuda")
    lab_t = torch.as_tensor(lab, device="cuda")
    err = 0.0
    for band in range(img.shape[2]):
        err = max(err, compare_kernel(glcm_inputs(img_t, lab_t, K, band),
                                      f"edge-case scene band {band}"))
    from obia_tpu_torch.ops import glcm as tglcm
    offsets8 = tglcm.angle_offsets(2, [i * math.pi / 8 for i in range(8)])
    img, lab, K = small_objects_scene()
    img_t = torch.as_tensor(img, device="cuda")
    lab_t = torch.as_tensor(lab, device="cuda")
    for levels in (1, 2, 16, 256):
        for band in range(img.shape[2]):
            err = max(err, compare_kernel(
                glcm_inputs(img_t, lab_t, K, band, levels, offsets8),
                f"{K} small objects, L={levels}, 8 offsets, band {band}"))
    img, lab, K = big_object_scene()
    img_t = torch.as_tensor(img, device="cuda")
    lab_t = torch.as_tensor(lab, device="cuda")
    for levels, offs in ((256, offsets8), (256, None), (16, offsets8)):
        args = glcm_inputs(img_t, lab_t, K, 0, levels, offs)
        err = max(err, compare_kernel(
            args, f"one object over most of the raster, L={levels}, "
                  f"{len(args[-1])} offsets"))

    # -- 4. the config-4 slice at full width --------------------------------
    image = as_image(config4_scene(SIZE))
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
    check_spectral_runs(s_cold.table, s.table, same_runs, "config 4")
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
    profiled(run_slice, image, "profiled run")

    labels = s.layer.labels_dev
    args = glcm_inputs(image.device_tensor("cuda"), labels, n_obj, 0)
    err = max(err, compare_kernel(args, f"{SIZE}^2 scene band 0"))
    before = glcm_kernel.launches
    ms = time_ms(lambda: glcm_kernel.glcm_sums(*args), 10)
    plain_ms = time_ms(lambda: glcm_kernel.glcm_sums_reference(*args), 3)
    glcm_kernel.launches = before
    bound, bound_l = sums_bound_ms([args]), sums_bound_ms([args], True)
    log(f"GLCM sums one band at {SIZE}^2, K={n_obj}: kernel {ms:.3f} ms, "
        f"plain torch {plain_ms:.3f} ms, bound {bound:.4f} ms (band in "
        f"place: {bound_l:.4f} ms) ({card})")
    kernel_split(lambda: glcm_kernel.glcm_sums(*args), "GLCM sums kernels")
    glcm_kernel.launches = before

    # -- 5. cross-check against the CPU plain path ------------------------
    cross_check(run_slice, config4_scene(CROSS_SIZE), f"config 4 "
                f"{CROSS_SIZE}^2")

    # -- 6. quickshift kernels vs twins, edge cases -----------------------
    qs_err = [0.0, 0.0]
    for name, scene in qs_scenes().items():
        x = torch.as_tensor(scene, device="cuda")
        C, H, W = x.shape
        noise = torch.as_tensor(np.random.default_rng(C).normal(
            0, 1e-5, (H, W)).astype(np.float32), device="cuda")
        r_max = qk.max_radius(C)
        for r in (3, 15, r_max):
            e = qs_compare(x, r, r / 3.0, 0.6 * r, noise, name)
            qs_err = [max(qs_err[0], e[0]), max(qs_err[1], e[1])]
        rp_max = qk.max_radius(C, parent=True)
        for what, call in (
                (f"density r={r_max + 1}",
                 lambda: qk.quickshift_density(x, r_max + 1, 1.0)),
                (f"parent rp={rp_max + 1}",
                 lambda: qk.quickshift_parent(x, noise + 1.0, rp_max + 1,
                                              rp_max + 1.5))):
            try:
                call()
            except ValueError as exc:
                log(f"  {name}, {what}: raises ({exc})")
            else:
                raise AssertionError(f"{what} past the kernel's limit did "
                                     f"not raise ({name})")

    # -- 7. the config-2 slice at its own size ----------------------------
    image2 = as_image(build_scene(h=QS_SIZE, w=QS_SIZE))
    mp2 = QS_SIZE * QS_SIZE / 1e6
    s2_cold, _, cold2 = profiled(run_config2, image2, "cold run")
    glcm_kernel.launches = 0
    qk.launches.update(qs_density=0, qs_parent=0)
    s2, proba2, warm2 = run_config2(image2, "cuda")
    qs_launches = dict(qk.launches)
    glcm2 = glcm_kernel.launches
    n2 = len(s2.table)
    same2 = np.array_equal(s2_cold.label_raster, s2.label_raster)
    log(f"cold and warm label rasters identical: {same2}")
    log(f"config-2 slice {QS_SIZE}^2 RGB: {n2} objects, cold {cold2:.3f} s,"
        f" warm {warm2:.3f} s, {mp2 / warm2:.3f} MP/s warm; launches "
        f"{qs_launches}, GLCM {glcm2}")
    if min(qs_launches.values()) < 1 or glcm2 < 3:
        raise AssertionError(f"config-2 run missed a kernel: {qs_launches},"
                             f" GLCM {glcm2}")
    if proba2.shape[0] != n2 or not np.allclose(proba2.sum(1), 1.0,
                                                atol=1e-5):
        raise AssertionError("MLP predict_proba rows do not sum to 1")
    if not np.isfinite(proba2).all() or len(s2.table.geometry) != n2:
        raise AssertionError("non-finite probabilities or missing geometry")
    for b in range(3):
        if np.isnan(s2.table[f"b{b}_mean"]).any():
            raise AssertionError(f"b{b}_mean holds NaN")
    tforest._FIT_CACHE.clear()  # the split shows the fit, not a cache hit
    profiled(run_config2, image2, "profiled warm run")

    x2, noise2 = qs_inputs(build_scene(h=QS_SIZE, w=QS_SIZE))
    e_rho, e_par, qs_ms, qs_plain, qp_ms, qp_plain = qs_time(
        x2, noise2, f"{QS_SIZE}^2 C=3 r=15", 20)
    qs_err = [max(qs_err[0], e_rho), max(qs_err[1], e_par)]
    xb, noiseb = qs_inputs(build_scene(h=QS_BIG, w=QS_BIG))
    qs_big = qs_time(xb, noiseb, f"{QS_BIG}^2 C=3 r=15", 5)
    del xb, noiseb
    x8, noise8 = qs_inputs(config4_scene(QS_SIZE))
    qs_c8 = qs_time(x8, noise8, f"{QS_SIZE}^2 C=8 r=15", 20)
    qs_err = [max(qs_err[0], qs_c8[0]), max(qs_err[1], qs_c8[1])]
    args2 = glcm_inputs(image2.device_tensor("cuda"), s2.layer.labels_dev,
                        n2, 0)
    err = max(err, compare_kernel(args2, f"config-2 {QS_SIZE}^2 band 0"))
    before = glcm_kernel.launches
    g_ms = time_ms(lambda: glcm_kernel.glcm_sums(*args2), 10)
    g_plain = time_ms(lambda: glcm_kernel.glcm_sums_reference(*args2), 3)
    glcm_kernel.launches = before
    bound2, bound2_l = sums_bound_ms([args2]), sums_bound_ms([args2], True)
    log(f"GLCM sums one band at {QS_SIZE}^2, K={n2}: kernel {g_ms:.3f} ms, "
        f"plain torch {g_plain:.3f} ms, bound {bound2:.4f} ms (band in "
        f"place: {bound2_l:.4f} ms) ({card})")
    kernel_split(lambda: glcm_kernel.glcm_sums(*args2), "GLCM sums kernels")
    glcm_kernel.launches = before

    # -- 8. config-2 cross-check against the CPU plain path ---------------
    cross_check(run_config2, build_scene(h=QS_CROSS_SIZE, w=QS_CROSS_SIZE),
                f"config 2 {QS_CROSS_SIZE}^2")

    # -- 9. the seam-spanner histogram kernel vs its twin, edge cases ------
    from obia_tpu_torch.parallel import mesh as pmesh
    cmesh = pmesh.make_mesh(C5_SHARDS, ["cuda"])
    himg, hlab, hK = seam_scene()
    hist_err = 0
    for levels in (16, 180, 255, 256):
        for band in range(himg.shape[2]):
            hist_err = max(hist_err, compare_hist(shard_calls(
                cmesh, pmesh.shard_raster(cmesh, himg)[0],
                pmesh.shard_raster(cmesh, hlab, fill=-1)[0], hK, levels,
                band)[1], f"edge-case sharded scene, L={levels}, band {band}"))
    dimg, dlab, dK = dense_scene()
    for levels in (100, 180, 255, 256):
        hist_err = max(hist_err, compare_hist(shard_calls(
            cmesh, pmesh.shard_raster(cmesh, dimg)[0],
            pmesh.shard_raster(cmesh, dlab, fill=-1)[0], dK, levels, 0)[1],
            f"dense scene (cell lists overflow), L={levels}"))

    # -- 10. config 5 at its real size on a 2 x 4 mesh on the card ---------
    from obia_tpu_torch.parallel.sharded import count_shard_spanning
    image5 = as_image(build_scene(h=C5_SIZE, w=C5_SIZE))
    mp5 = C5_SIZE * C5_SIZE / 1e6
    r5_cold, _, cold5 = run_config5(image5, "cuda")
    glcm_kernel.launches = 0
    glcm_kernel.hist_launches = 0
    r5, _, warm5 = run_config5(image5, "cuda")
    sums5, hist5 = glcm_kernel.launches, glcm_kernel.hist_launches
    n5 = len(r5.table)
    lab5 = r5.layer.shards
    n_span, _ = count_shard_spanning(lab5.mesh, lab5, n5)
    img5_sh = pmesh.shard_raster(lab5.mesh, image5.device_tensor("cuda"))[0]
    sums5_calls, hist5_args = shard_calls(lab5.mesh, img5_sh, lab5, n5, 256,
                                          0)
    same5 = np.array_equal(r5_cold.label_raster, r5.label_raster)
    log(f"cold and warm label rasters identical: {same5}")
    check_spectral_runs(r5_cold.table, r5.table, same5, "config 5")
    log(f"config 5 {C5_SIZE}^2 RGB on a {lab5.mesh.ty} x {lab5.mesh.tx} "
        f"mesh: {n5} objects, {n_span} seam spanners in "
        f"{hist5_args[3].pieces.shape[0]} pieces, cold {cold5:.3f} s, warm "
        f"{warm5:.3f} s, {mp5 / warm5:.3f} MP/s warm; launches glcm_sums "
        f"{sums5}, glcm_hist {hist5}")
    if sums5 < C5_SHARDS * 3 or hist5 != 3 or n_span < 1:
        raise AssertionError(f"config-5 run missed a kernel: glcm_sums "
                             f"{sums5}, glcm_hist {hist5} (one a band)")
    for c in r5.table.columns:
        if c.startswith("b") and np.isnan(r5.table[c]).all():
            raise AssertionError(f"column {c} is all NaN")
    if np.isnan(r5.table["b0_mean"]).any() or len(r5.table.geometry) != n5:
        raise AssertionError("NaN means or missing geometry in config 5")
    profiled(run_config5, image5, "config 5 profiled warm run")
    hist_err = max(hist_err, compare_hist(
        hist5_args, f"config 5 {C5_SIZE}^2 band 0"))
    before = glcm_kernel.hist_launches
    h = hist_times(lab5, img5_sh, n5, hist5_args)
    kernel_split(lambda: glcm_kernel.glcm_spanner_hist(*hist5_args,
                                                       tables=False),
                 "GLCM spanner histogram kernel")
    glcm_kernel.hist_launches = before
    for i, a in enumerate(sums5_calls):
        err = max(err, compare_kernel(a, f"config 5 shard {i} band 0"))
    before = glcm_kernel.launches
    s5_ms = time_ms(lambda: [glcm_kernel.glcm_sums(*a)
                             for a in sums5_calls], 10)
    s5_plain = time_ms(lambda: [glcm_kernel.glcm_sums_reference(*a)
                                for a in sums5_calls], 3)
    glcm_kernel.launches = before
    bound5 = sums_bound_ms(sums5_calls)
    bound5_l = sums_bound_ms(sums5_calls, True)
    log(f"GLCM sums, one band of config 5 ({len(sums5_calls)} launches, "
        f"K={n5}): kernel {s5_ms:.3f} ms, plain torch {s5_plain:.3f} ms, "
        f"bound {bound5:.4f} ms (band in place: {bound5_l:.4f} ms) "
        f"({card})")
    kernel_split(lambda: [glcm_kernel.glcm_sums(*a) for a in sums5_calls],
                 "GLCM sums kernels, 8 launches")
    glcm_kernel.launches = before

    # -- 11. sharded vs single-device on the card --------------------------
    sharded_vs_single(r5, image5)
    del r5, r5_cold, hist5_args, sums5_calls, img5_sh

    # -- 12. config-5 cross-check against the CPU plain path --------------
    cross_check(run_config5, build_scene(h=C5_CROSS_SIZE, w=C5_CROSS_SIZE),
                f"config 5 {C5_CROSS_SIZE}^2")

    log(card_line())
    qs_r, qs_md = 15, QS_KW["max_dist"]  # as qs_time measures
    qd_bound, qp_bound = qs_bound(x2, qs_r), qs_bound(x2, qs_r, qs_md)
    log(f"quickshift bounds at {QS_SIZE}^2: density {qd_bound}, parent "
        f"{qp_bound}")
    log(json.dumps({"kernels": [
        {"name": "glcm_sums", "route": "cuda",
         "source": "obia_tpu_torch/csrc/glcm.cu",
         "replaces": "obia_tpu/ops/glcm_pallas.py:220",
         "launches": launches, "max_abs_err": err, "ms": ms,
         "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
         "bound_ms_layout": bound_l, "library_ms": None, "ms_config2": g_ms,
         "plain_ms_config2": g_plain, "bound_ms_config2": bound2,
         "bound_ms_layout_config2": bound2_l, "launches_config2": glcm2,
         "ms_config5": s5_ms, "plain_ms_config5": s5_plain,
         "bound_ms_config5": bound5, "bound_ms_layout_config5": bound5_l,
         "launches_config5": sums5},
        {"name": "qs_density", "route": "cuda",
         "source": "obia_tpu_torch/csrc/quickshift.cu",
         "replaces": "obia_tpu/ops/quickshift_pallas.py:118",
         "launches": qs_launches["qs_density"], "max_abs_err": qs_err[0],
         "ms": qs_ms, "plain_ms": qs_plain,
         "bound_ms": qd_bound["bound_ms"], "bound_by": qd_bound["bound_by"],
         "bound_term": qd_bound["bound_term"], "library_ms": None,
         "ms_4096": qs_big[2], "plain_ms_4096": qs_big[3],
         "ms_c8": qs_c8[2], "plain_ms_c8": qs_c8[3]},
        {"name": "qs_parent", "route": "cuda",
         "source": "obia_tpu_torch/csrc/quickshift.cu",
         "replaces": "obia_tpu/ops/quickshift_pallas.py:144",
         "launches": qs_launches["qs_parent"], "max_abs_err": qs_err[1],
         "ms": qp_ms, "plain_ms": qp_plain,
         "bound_ms": qp_bound["bound_ms"], "bound_by": qp_bound["bound_by"],
         "bound_term": qp_bound["bound_term"], "library_ms": None,
         "ms_4096": qs_big[4], "plain_ms_4096": qs_big[5],
         "ms_c8": qs_c8[4], "plain_ms_c8": qs_c8[5]},
        {"name": "glcm_hist", "route": "cuda",
         "source": "obia_tpu_torch/csrc/glcm.cu",
         "function": "glcm_spanner_hist_kernel",
         "replaces": "obia_tpu/ops/glcm_pallas.py:258",
         "launches": hist5, "max_abs_err": float(hist_err),
         "bound_by": "bytes", "library_ms": None, **h}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
