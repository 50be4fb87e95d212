#!/usr/bin/env python3
"""Smoke run of obia_tpu_torch on one NVIDIA GPU: build, check, drive.

    python3 chip_smoke.py [--seed N]

``--seed`` (default 0) seeds the canopy phase's scene. Phases, in order;
any failure raises and exits non-zero:

1. require a CUDA device and print its name and power limit (nvidia-smi);
2. build the CUDA kernels from ``obia_tpu_torch/csrc`` with nvcc, one
   process per source, all started together, and the port's host library
   (``obia_tpu_torch/native``: polygoniser, union-find, TreeSHAP) with g++;
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
5. classify the config-4 table with ``classify(method="mlp",
   hidden_layer_sizes=(64,), max_iter=60, compute_shap=True,
   sample_shap=True)``, once cold and once warm: the training table is the
   seeded 20% subset of the objects with a median-split target, and Kernel
   SHAP's synthetic rows go through the MLP on the card; checks: local
   accuracy (base + sum(phi) == f(x) to 1e-6 against the card's own
   predictions), the SHAP values of 4 rows with the same model on the CPU
   (atol 1e-5), predicted classes among the training classes, probability
   rows summing to 1, the classified GeoTIFF read back equal to the
   label-raster render, and TreeSHAP (the g++ build of the native library)
   on the stand-in forest with local accuracy to 1e-9 (the forest route of
   ``classify`` needs sklearn to fit, and runs only where it is installed);
6. cross-check: the same slice at 512^2 on the card and on the CPU (the
   plain path the CPU tests hold against the JAX reference): object counts
   within 1%, each feature column's mean within 1e-3 of the column's mean
   magnitude; then the ``sigma=1`` pre-blur: the blurred float32 Lab image
   on the card within rtol 1e-6 of the CPU's (and the blur alone on the
   CPU's Lab image copied to the card), with no convolution op in the
   card's blur, and the slice with ``sigma=1`` cross-checked as above with
   label partitions agreeing on >= 99.5% of the pixels;
7. hold the quickshift density and parent kernels against their twins on
   edge-case scenes (ragged 70x300 C=3, 96x80 C=1, 64x64 C=8, a constant
   plateau) at radii 3, 15 and the density's largest, max_dist 0.6 r:
   density within rtol 1e-6, parent outputs exactly equal given the twin's
   rho, and the kernel pipeline's roots against the twin pipeline's
   (partition agreement >= 0.995); each kernel one past its own limit must
   raise (the density on r, the parent on its disk's radius rp);
8. drive the config-2 slice of ``bench.py`` at 1024^2 RGB on the card:
   ``segment(method="quickshift", ratio=1.0, kernel_size=5, max_dist=10.0)``
   (spectral + GLCM features of the 3 bands) and a (64,) MLP fitted for
   max_iter=60, then ``predict_proba``, once cold (profiled) and once warm,
   with the launch counts read around the warm run; a profiled warm run;
   both quickshift kernels against their twins at 1024^2 and at
   4096^2, and on the 8 bands of the config-4 scene at 1024^2 (the same
   radius and max_dist), and the GLCM sums kernel at this slice's object
   count, all timed with CUDA events;
9. cross-check: the config-2 slice at 256^2 on the card and on the CPU:
   object counts within 1%, label partitions agreeing on >= 99.5% of the
   pixels, column means as in phase 6; then the ``sigma=1`` pre-blur as in
   phase 6;
10. hold the seam-spanner histogram kernel (``glcm_spanner_hist``: every
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
11. drive config 5 of ``bench.py`` at its real size (``OBIA_BENCH5_REAL=1``:
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
12. sharded against single-device on the card, on the same normalised
   image: SLIC labels (convert2lab=False) as partitions agreeing on
   >= 99.5% of the pixels, and every feature column of the mosaic against
   single-device ``create_objects`` on the mosaic's labels (rtol 2e-4,
   atol 1e-5);
13. cross-check: config 5 at 768^2 (``bench.py``'s default size for it) on
   the card and on the CPU, as in phase 9;
14. drive config 3 of ``bench.py`` at its default size: ``build_scene(2048,
   2048)`` written as an uncompressed GeoTIFF, then
   ``create_tiled_segments(raster, out, tile_size=512, buffer=64,
   n_segments=700)`` on the card, once (host-bound: a second run took the
   same time), with its stage split (host clock, not synced) and MP/s;
   checks: every tile ``done`` and none ``failed`` in the manifest (after
   every run of config 3), ``segments.gpkg`` read back with N rows and ``segment_id`` 1..N,
   the polygons covering more than 93% and at most 100% of the raster's
   area, and more than 99.5% of the pixels covered at most once (each
   polygon rasterised over its own bounding box); then ``create_objects``
   on that layer, which carries no label raster, over
   ``open_geotiff(raster)``: N rows, ``b0_mean`` finite on >= 99% of them;
15. cross-check: config 3 at 1024^2 with the same tiling on the card and on
   the CPU: segment counts within 1%, rasterised label partitions agreeing
   on >= 99.5% of the pixels, the two layers' ``create_objects`` column
   means as in phase 6; then the card's run resumed
   (``resume=True``), which must segment no tile and give the same count
   (resumed here and not at 2048^2, where pass 2's host predicates would
   add ~3 minutes to the script);
16. drive the canopy seed workflow at 2048^2 (a 4.2 km^2 plot at 1 m,
   ~10.5 k crowns; ``canopy_rasters``) on the card, once cold, once warm
   and once with the stage times synced: ``make_chm_seeds`` (defaults),
   ``make_density_seeds(d_min=4.5, min_dist_px=4, gauss_sigma=2)``,
   ``make_cost_surface`` with the port's SLIC layer written in EPSG:4326
   and weights (0.4, 0.2, 0.2, 0.2), ``make_canonical_seeds`` (defaults,
   its distance matrix on the card); checks: stage 1 holds 15-25 k seeds,
   the cost raster in [0, 1] with its nodata, the canonical layer read
   back; then ``local_entropy`` alone, timed with CUDA events;
17. cross-check: the canopy workflow at 512^2 on the card and on the CPU
   on the same files: peak sets and canonical rows equal, cost rasters
   within atol 1e-6 with equal nodata, the distance matrix within rtol
   1e-6, DBSCAN labels equal (a pair within 1e-6 of eps excepted, and
   printed);
18. ``create_objects``' other inputs on phase 4's config-4 layer and table
   (4096^2 x 8): (a) every other object (``table.take``) through the
   rasterise path, cold, then warm under ``telemetry.trace``, with the
   launch counts read around the warm call (``glcm_sums`` > 0, and its
   kernels in the Chrome trace), then once with the stages synced; every
   column equal to the unfiltered table's rows within rtol 1e-6 / atol
   1e-6; (b) the structural and radiometric families
   (``voxel_resolution=1.0``) with a seeded cloud of 33,554,432 points
   (USGS 3DEP QL2's 2 points/m^2 over the 16.8 km^2 scene at 1 m: 30%
   ground returns below 1 m, the rest 1-30 m, uint16 intensity), cold and
   warm with the stages synced, each column finite on >= 99% of the rows;
   ``segment_pointcloud_stats`` on the card against the CPU on the same
   points and labels: CH and the NaN slots equal, the rest within rtol
   1e-12;
19. at 256^2 (config 4's bands, n_segments=100): a LAS round trip
   (``write_las`` then ``create_objects(pointcloud=path)``) equal to the
   dict input, on points that LAS stores exactly; ``strict_reference_glcm``
   with bands 0/3/6 on a ``Features`` table, on the card and on the CPU:
   the rasterised labels and the strict columns equal, NaNs included;
   ``slic()`` on the card equal to ``slic_dense``'s labels + 1;
20. detection at full width: ``build_detection_model(num_classes=2,
   in_channels=10)`` (ResNet-50 (3, 4, 6, 3) at width 64, FPN 256, P3-P7,
   9 anchors; 36.4 M parameters) on the card, ``train_model`` for 2 epochs
   of ``DataLoader(TreeDetectionDataset(..., get_transforms(True)),
   batch_size=2, seed=0)`` over 8 seeded crown tiles of 512^2 x 10 bands
   (uint16 GeoTIFFs, ``crown_raster``) with a checkpoint an epoch: each
   step's time (host clock, the loss read each step), the peak device
   memory, each epoch's loss (finite), ``epoch_2.npz`` loaded back equal on
   every tensor, one step traced (kernels, device busy and idle), and the
   step of ``make_train_step`` (cuDNN's deterministic algorithms) against
   the same step with cuDNN's defaults, 10 each in alternating blocks;
   ``predict`` on a 4096^2 x 10 uint16 scene, cold and warm, then with the
   stages synced (read, scale, forward, decode, NMS) at scores >= 0.5 and
   >= 0.05, every box inside the raster; the scene's uint8 raster scaled
   on the card equal to numpy's float64 scaling; the forward alone by CUDA
   events and traced; ``evaluate_model`` on the tiles;
21. (a) the trained model on the card and a copy on the CPU, 2 x 10 x
   256^2 inputs: eval class logits and box deltas, the running statistics
   after one train-mode forward and one train step's loss within 1e-4 of
   their largest magnitudes; the same train step in float64 on both, loss
   and every gradient within 1e-9; the float32 gradients measured against
   the CPU's float64 ones, the card's relative L2 error within 4x the
   CPU's (float32 train-mode gradients are ill-conditioned here: both are
   a few % from float64); (b) tests/test_detection.py:243's overfit run
   on the card (two 128^2 scenes, width 8, FPN 32, stages (1, 1, 1, 1),
   Adam 2e-3, 400 steps): the loss below 10% of its first value and
   AP@0.5 >= 0.9 through ``evaluate_model``.
22. the fused model (``models/pipeline.py``): ``make_flagship()`` at the
   JAX driver's 512^2 x 4, 256 segments, 8 classes, on the card cold and
   warm, then on the CPU: labels equal (or partitions >= 99.99%) and
   logits within 1e-5 of their largest magnitude; then ``obia_forward`` at
   config 4's scene (4096^2 x 8, scaled to [0, 1)) with 3000 segments (a
   55 x 55 grid, K = 3,025), hidden 64, 8 classes, 5 iterations: cold,
   warm (synced and by CUDA events), the peak device memory, and one
   traced run's kernel count and device idle share;
23. ``make_sharded_train_step`` on a 2 x 4 mesh of shards on the card at
   config 5's 4096^2 RGB scene (``train_inputs``: ``build_scene`` / 256,
   seeded targets), K = 3,025 (Kpad 3,032), 20 SGD steps: the first and
   the median warm step, every loss finite and the last below the first;
   then 3 steps at 512^2 (256 segments) on the card and on the CPU: loss
   rtol 1e-5, parameters within 1e-5 of each tensor's largest magnitude,
   centres within 1e-5 in colour and 1e-3 px;
24. two ranks on the one card: two new interpreters
   (``chip_smoke.py --two-rank-worker``) join a gloo group on a free port,
   check ``process_info()``/``is_coordinator()`` (the shared card counts
   once), all-reduce (1, 4) tensors of rank + 1 on the card (total 12.0),
   check the shards each holds and the mosaic's refusal of a mesh that
   spans ranks, and run 3 steps at 1024^2 with one shard row each
   (``make_mesh(8, ["cuda:0"], distributed=True)``): parameters, losses and centres equal bit for bit
   to the same steps in this process; each rank's wall and step times;
25. the bench command (``obia_tpu_torch/bench.py``), one new process a
   configuration: ``python -m obia_tpu_torch.bench --config N`` for configs
   1, 4, 2 and 5 at their default sizes (4096^2, 4096^2 x 8, 1024^2,
   4096^2 on the 2 x 4 mesh; the stand-in forest) and config 3 at 1024^2
   with ``OBIA_BENCH_RUNS=1``: each exits 0 and its last line is a row with
   MP/s > 0, the card's name and power limit, and a launch of each of its
   path's kernels; configs 4, 2, 5 and 3 count the objects of phases 4, 8,
   11 and 15 (the card's run) on the same scene, size and device;
26. the north-star scene, ``config4_scene(10000)`` (100 MP x 8 bands),
   built once: (path 1) config 4 and (path 3) config 5's ``mosaic_pipeline``
   on a 2 x 4 mesh of 5000 x 2500 blocks on the card, each cold, warm (the
   card's peak memory, reset before each run, and the launches) and
   profiled (each stage synced, with its peak memory), logging K (path 1's
   beside the JAX package's 2,610 on this scene, a TPU run) and the host's
   peak RSS; checks of each: every pixel owned and the labels dense
   0..K-1, K polygons whose areas add up to the raster's within 1e-6
   relative and equal each object's pixel count, K table rows with no NaN
   in a spectral or GLCM column, the forest's rows adding up to 1 (path
   1), the cold and warm spectral columns identical; path 1's moment
   passes in blocks of a quarter, one and four times ``stats.SUM_BLOCK``
   pixels and in one block, in turns, each timed with its peak memory, the
   moments within rtol 1e-6 of one block's; ``glcm_sums`` against
   its twin on band 0 (path 1) and ``glcm_spanner_hist`` against its twin
   on band 0 (path 3), as in phases 3 and 10, timed with CUDA events
   beside their bounds; sharded against single-device as in phase 12;
   then (path 2) ``python -m obia_tpu_torch.bench 10000 --config 1`` with
   ``OBIA_BENCH_RUNS=2``, its row checked as in phase 25;
27. the reference's import paths over the port: (a) config 1's scene
   (``build_scene``, 4096^2 RGB, phase 25's config-1 size) written as a
   GeoTIFF, then README.md's headline through ``obia_torch``
   (``open_geotiff``, ``segment(method="slic", n_segments=3000,
   compactness=10)``, ``classify(method="mlp")`` on the table with the
   bench's seeded training rows, ``write_geotiff``, read back), cold and
   warm, the launches counted around the warm run; checks: the
   ``obia_torch`` objects are the port's, K equals phase 25's config-1
   row, the labels equal a direct ``obia_tpu_torch`` call's, no NaN in a
   spectral or GLCM column, the GeoTIFF equals the label-raster render,
   ``glcm_sums`` launched; (b) ``glcm_table`` and ``spectral_stats_table``
   on (a)'s labels bitwise the packed paths, and on a 1024^2 corner within
   rtol 2e-4 / 1e-4, atol 1e-5 of the CPU's; ``polygonize_labels``' areas
   adding up to H * W; the join pairs of ``contains`` (polygons, 300
   seeded points) equal to ``within`` (points, polygons) swapped, every
   point in a polygon; (c) ``python -m obia_tpu_torch.bench 1024 --config
   detection`` in a new process: the tool's keys with ``device`` and
   ``launches``, a finite loss, its walls logged. The whole script's time
   is logged.

After the build a line gives the quickshift kernels' registers, spilled
bytes and pixels a thread (P) as the library reports them. The last two
lines are a JSON object of the kernels' launches, errors, times and
bounds, and ``{"ok": true, "device": {...}}``. A kernel's ``bound_ms``
is the larger of the bytes it must move (each input read once, each
output written once; a band counts its own 4 bytes a pixel) over 3.35
TB/s and its operations over 67 TFLOP/s float32, from this run's shapes.
The quickshift scans count the pixel-offset pairs whose neighbour lies
in the image (the parent's offsets only those of the max_dist disk) at
3C + 4 float32 operations, and the density's exponentials apart, over
the SFU's 16 a clock per SM (4.18 T/s at 1.98 GHz); their ``bound_term``
names the larger term ("fp32", "sfu" or "bytes"; ``bound_by`` says
"operations" for either of the first two). ``glcm_hist``'s bound charges
the labels and band of each piece's box and its 2-pixel halo (8 bytes a
pixel), the work list, and the sums written once, as the main path
launches it (no tables); ``bound_ms_tables`` adds the summed tables
written once. ``glcm_sums`` also reports ``launches_rasterised`` (phase
18's warm call) and ``bound_ms_layout``: the same with the band charged
the 32-byte sectors that hold it in the interleaved (H, W, C) image, the
least a kernel that reads the band in place can take. No one PyTorch
call computes any of the four, so ``library_ms`` is null;
``launches_bench`` gives each kernel's launches in phase 25's rows, by
config, and ``launches_phase27`` in phase 27 (a)'s warm run. The script needs no network, JAX, pandas or sklearn (configs 4
and 1 predict with the bench's seeded stand-in forest, chosen and not
probed for; the MLP and ``classify(method="mlp")`` need neither), and
imports nothing of the JAX package.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

from obia_tpu_torch import bench as tbench
from obia_tpu_torch.bench import (C3_KW, N_SEGMENTS, N_TREES, QS_KW,
                                  as_image, build_scene, card_line,
                                  config4_scene, forest_fields,
                                  reset_launches, training_table,
                                  write_scene)

ROOT = os.path.dirname(os.path.abspath(__file__))
SIZE = 4096
CROSS_SIZE = 512
BANDS = 8
QS_SIZE = 1024          # config 2's own size (bench.py)
QS_CROSS_SIZE = 256
QS_BIG = 4096           # the kernels alone, as the JAX package timed them
C5_SIZE = 4096          # bench.py config 5 with OBIA_BENCH5_REAL=1
C5_CROSS_SIZE = 768     # bench.py's default size for config 5
C5_SHARDS = 8           # the 2 x 4 mesh
C3_SIZE = 2048          # bench.py's default run of config 3
C3_CROSS_SIZE = 1024
CANOPY_SIZE = 2048      # a 4.2 km^2 plot at 1 m
CANOPY_CROSS_SIZE = 512
CANOPY_PITCH = 20       # px between crown centres: ~10.5 k crowns at 2048^2
N_POINTS = 2 * SIZE * SIZE  # USGS 3DEP QL2: 2 points/m^2 over 4096^2 m
OBJ_SMALL_SIZE = 256
DET_TILES = 8           # training tiles, 512^2 x 10 bands (uint16)
DET_TILE = 512
DET_BANDS = 10          # build_detection_model's default in_channels
DET_SCENE = 4096        # config 4's scene size
DET_PITCH = 32          # px between crown centres
DET_CROSS = 256         # card vs CPU at full width
DET_SMALL = dict(num_classes=2, in_channels=3, backbone_width=8,
                 fpn_channels=32, stage_sizes=(1, 1, 1, 1))
PC_COLUMNS = ("pai", "fhd", "ch", "mean_intensity", "variance_intensity")
FUSED_CLASSES = 8       # the fused model's head: 64 hidden, 8 classes
TRAIN_STEPS = 20        # phase 23's steps at 4096^2
CROSS_SEGMENTS = 256    # the flagship's segments, for the 512^2 and
                        # 1024^2 checks of phases 23-24
TWO_RANK_SIZE = 1024
TWO_RANK_STEPS = 3
NS_SIZE = 10000         # the north-star scene: 10000^2 x 8 bands, 100 MP
NS_JAX_OBJECTS = 2610   # BASELINE.md: the JAX package's K there (a TPU run)
HBM_BYTES_PER_MS = 3.35e9   # H100 SXM: 3.35 TB/s
FP32_OPS_PER_MS = 67e9      # H100 SXM: 67 TFLOP/s float32 outside the MMAs
SFU_OPS_PER_MS = 132 * 16 * 1.98e6  # 132 SMs x 16 exponentials a clock


def log(msg: str) -> None:
    print(msg, flush=True)


def sklearn_like_forest(fields: dict, seed: int = 1):
    """The forest of :func:`forest_fields` with sklearn's fields
    (``estimators_[i].tree_`` and ``classes_``), for TreeSHAP: -1 children
    at the leaves, a random positive cover at each leaf and the sum of its
    children's at each inner node, each leaf's value its class distribution
    in float64 (summing to 1, as TreeSHAP normalises it) and each inner
    node's the cover-weighted mean of its children's."""
    import types
    rng = np.random.default_rng(seed)
    n_int = 2 ** fields["max_depth"] - 1
    trees = []
    for t in range(len(fields["feature"])):
        n = fields["feature"].shape[1]
        cover = np.zeros(n)
        cover[n_int:] = rng.integers(1, 50, n - n_int)
        value = fields["leaf_proba"][t].astype(np.float64)
        value /= value.sum(axis=1, keepdims=True)  # as TreeSHAP reads it
        for i in range(n_int - 1, -1, -1):  # children before parents
            a, b = 2 * i + 1, 2 * i + 2
            cover[i] = cover[a] + cover[b]
            value[i] = (cover[a] * value[a] + cover[b] * value[b]) / cover[i]
        leaf = np.arange(n) >= n_int
        trees.append(types.SimpleNamespace(tree_=types.SimpleNamespace(
            node_count=n, feature=fields["feature"][t],
            threshold=fields["threshold"][t].astype(np.float64),
            children_left=np.where(leaf, -1, fields["left"][t]),
            children_right=np.where(leaf, -1, fields["right"][t]),
            value=value[:, None, :], weighted_n_node_samples=cover,
            max_depth=fields["max_depth"])))
    return types.SimpleNamespace(estimators_=trees,
                                 classes_=fields["classes"])


def forest_walk(rf, X: np.ndarray):
    """(rows, classes) mean leaf value over the trees and the trees' mean
    expected value (root value), walked in float64 on the host."""
    proba = np.zeros((len(X), len(rf.classes_)))
    base = np.zeros(len(rf.classes_))
    for est in rf.estimators_:
        t = est.tree_
        node = np.zeros(len(X), np.int64)
        for _ in range(t.max_depth):
            f = t.feature[node]
            inner = f >= 0
            go_left = X[np.arange(len(X)), np.maximum(f, 0)] <= \
                t.threshold[node]
            node = np.where(inner, np.where(go_left, t.children_left[node],
                                            t.children_right[node]), node)
        proba += t.value[node, 0, :]
        base += t.value[0, 0, :]
    return proba / len(rf.estimators_), base / len(rf.estimators_)


def classified_render(lab: np.ndarray, table):
    """What ``write_geotiff`` of a classified ``table`` must give over the
    0-based label raster ``lab``: each object's class code (1, 2, ... in
    first-appearance order of ``predicted_class``) on its pixels, 0 where
    no object is. Returns (raster, number of classes)."""
    pred = np.asarray(table["predicted_class"])
    code = {c: i + 1 for i, c in enumerate(dict.fromkeys(pred.tolist()))}
    lut = np.zeros(int(lab.max()) + 2, np.int32)
    lut[np.asarray(table["segment_id"])] = [code[c] for c in pred]
    return np.where(lab >= 0, lut[lab + 1], 0), len(code)


def classify_phase(table, device: str = "cuda") -> None:
    """``classify`` on a config-4 table (the MLP route, Kernel SHAP evaluated
    on ``device``), once cold and once warm, then its checks."""
    import tempfile

    import torch

    from obia_tpu_torch import native, telemetry
    from obia_tpu_torch.classification import forest as tforest
    from obia_tpu_torch.classification.classify import classify
    from obia_tpu_torch.classification.kernel_shap import kernel_shap
    from obia_tpu_torch.io.tiff import TiffReader

    _, y, idx = training_table(table)
    training = table.take(idx).with_columns(feature_class=y[idx])
    kw = dict(method="mlp", hidden_layer_sizes=(64,), max_iter=60,
              random_state=0, compute_shap=True, sample_shap=True,
              device=device)
    for run in ("cold", "warm"):
        tforest._FIT_CACHE.clear()  # each run fits
        telemetry.reset()
        telemetry.enable(True)
        try:
            t0 = time.perf_counter()
            res = classify(table, training, **kw)
            wall = time.perf_counter() - t0
        finally:
            telemetry.enable(False)
        rep = telemetry.report()
        st = {k: 1000 * rep[f"classify.{k}"]["last_s"]
              for k in ("fit", "shap", "predict")}
        log(f"classify {run} (mlp, (64,), max_iter=60, Kernel SHAP on the "
            f"card): {wall:.3f} s; classify.fit {st['fit']:.1f} ms, "
            f"classify.shap {st['shap']:.1f} ms, classify.predict "
            f"{st['predict']:.1f} ms")
    Xs, bg = res.shap_inputs
    phi = res.shap_values
    n, M = Xs.shape
    B = len(bg)
    S = min(2 * M + 2 ** 11, 2 ** min(M, 30) - 2)  # kernel_shap's default
    rows = n * S * B
    log(f"  Kernel SHAP: n={n} rows explained, M={M} features, S={S} "
        f"coalitions, B={B} background rows: {rows} synthetic rows, "
        f"{rows / (st['shap'] / 1000):.4g} rows/s")

    # local accuracy against the card's own predictions
    clf = res.classifier
    dev_rows = torch.as_tensor(Xs, dtype=torch.float32, device=device)
    f = clf.proba_tensor(dev_rows).double().cpu().numpy()
    base = clf.proba_tensor(torch.as_tensor(
        bg, dtype=torch.float32, device=device)).double().mean(0).cpu().numpy()
    la = float(np.abs(base + phi.sum(axis=1) - f).max())
    # the same fitted model on the CPU, 4 rows
    phi_cpu = kernel_shap(clf.to("cpu").proba_tensor, torch.as_tensor(
        Xs[:4], dtype=torch.float32), bg)
    cc = float(np.abs(phi_cpu - phi[:4]).max())
    log(f"  SHAP local accuracy max|base + sum(phi) - f(x)| = {la:.3e} "
        f"(bar 1e-6); card vs CPU, 4 rows: max|diff| = {cc:.3e} (bar 1e-5)")
    if not la <= 1e-6 or not cc <= 1e-5 or not np.isfinite(phi).all():
        raise AssertionError(f"Kernel SHAP check failed: local accuracy "
                             f"{la}, card vs CPU {cc}")
    # where the card's time goes: 64 of the rows, the device's busy share,
    # and the host's share in building the coalitions
    from obia_tpu_torch.classification.kernel_shap import _build_coalitions
    t0 = time.perf_counter()
    _build_coalitions(M, S, np.random.default_rng(0))
    coal = time.perf_counter() - t0

    def some_rows():
        return kernel_shap(clf.proba_tensor, dev_rows[:64], bg)

    some_rows()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    some_rows()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    busy = sum(kernel_split(some_rows, "Kernel SHAP, 64 rows").values())
    log(f"  Kernel SHAP, 64 rows: {1000 * wall:.1f} ms wall, of which "
        f"{1000 * coal:.1f} ms building the coalitions on the host; device "
        f"busy {busy / 1e3:.1f} ms ({busy / 1e4 / wall:.1f}% of the wall)")

    pred = np.asarray(res.table["predicted_class"])
    if len(pred) != len(table) or not set(np.unique(pred)) <= set(y[idx]):
        raise AssertionError("predicted_class outside the training classes")
    if (not np.isfinite(res.proba).all()
            or not np.allclose(res.proba.sum(1), 1.0, atol=1e-5)):
        raise AssertionError("classify probabilities do not sum to 1")

    # the classified GeoTIFF against the label-raster render
    lab = np.asarray(table.layer.label_raster)
    want, n_classes = classified_render(lab, res.table)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "classified.tif")
        t0 = time.perf_counter()
        res.write_geotiff(path)
        got = TiffReader(path).read()[:, :, 0]
        tif_s = time.perf_counter() - t0
    if not np.array_equal(got, want):
        raise AssertionError("classified GeoTIFF != the label-raster render")
    log(f"  GeoTIFF {got.shape[0]}x{got.shape[1]} written and read back in "
        f"{tif_s:.2f} s, equal to the render ({n_classes} classes)")

    # TreeSHAP (the g++ build of the native library) on the stand-in forest
    X, _, _ = training_table(table)
    rf = sklearn_like_forest(forest_fields(X[idx], N_TREES))
    t0 = time.perf_counter()
    tphi = native.tree_shap_forest(rf, X[:32])
    tree_s = time.perf_counter() - t0
    fx, tbase = forest_walk(rf, X[:32])
    tla = float(np.abs(tbase + tphi.sum(axis=1) - fx).max())
    log(f"  TreeSHAP, {N_TREES}-tree depth-8 stand-in forest, 32 rows: "
        f"{tree_s:.2f} s, local accuracy max|diff| = {tla:.3e} (bar 1e-9)")
    if not tla <= 1e-9:
        raise AssertionError(f"TreeSHAP local accuracy {tla}")
    try:
        import sklearn  # noqa: F401
    except ImportError:
        log("  classify(method='rf') not run: sklearn, which fits the "
            "forest, is not installed; config 4 keeps the stand-in forest")


def run_slice(image, device, **seg_kw):
    """Config 4 (``bench.run_config4``, the stand-in forest); returns
    (segments, proba, seconds). ``seg_kw`` (``sigma``) go to SLIC."""
    t0 = time.perf_counter()
    s, proba = tbench.run_config4(image, device, tbench.STAND_IN, **seg_kw)
    return s, proba, time.perf_counter() - t0


def run_config2(image, device, **seg_kw):
    """Config 2 (``bench.run_config2``); returns (segments, proba,
    seconds). ``seg_kw`` (``sigma``) go to quickshift."""
    t0 = time.perf_counter()
    s, proba = tbench.run_config2(image, device, **seg_kw)
    return s, proba, time.perf_counter() - t0


def run_config5(image, device):
    """Config 5 (``bench.run_config5``: ``mosaic_pipeline`` over a 2 x 4
    mesh of shards on ``device``); returns (result, None, seconds), the
    result with the object table, the layer and the host label raster."""
    import types
    t0 = time.perf_counter()
    objects = tbench.run_config5(image, device)
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


def stage_report() -> dict:
    """The telemetry's report of stages, without its counters."""
    from obia_tpu_torch import telemetry
    return {k: v for k, v in telemetry.report().items() if "total_s" in v}


def launch_count(key: str) -> int:
    """The launches of the kernel ``key`` (a key of the bench's
    ``launches``) in this process, from the telemetry's counters."""
    from obia_tpu_torch import telemetry
    return telemetry.counters().get(tbench.LAUNCH_COUNTERS[key], 0)


def compare_hist(args, what: str) -> int:
    """glcm_spanner_hist against its twin on one call, with its tables and
    without them (as the main path calls it), and two kernel runs against
    each other; returns the max abs difference of the tables and the sums
    (C + C^T)^2 (0 or it raises)."""
    import torch

    from obia_tpu_torch.ops import glcm_kernel
    before = launch_count("glcm_hist")
    got, got_sq = glcm_kernel.glcm_spanner_hist(*args)
    again, again_sq = glcm_kernel.glcm_spanner_hist(*args)
    none, main_sq = glcm_kernel.glcm_spanner_hist(*args, tables=False)
    want, want_sq = glcm_kernel.glcm_spanner_hist_reference(*args)
    torch.cuda.synchronize()
    calls = launch_count("glcm_hist") - before
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
    numbers; no launch count read elsewhere includes these launches."""
    import torch

    from obia_tpu_torch.ops import glcm_kernel
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
    before = launch_count("glcm_sums")
    isums, hsum = glcm_kernel.glcm_sums(*args)
    isums2, hsum2 = glcm_kernel.glcm_sums(*args)
    ri, rh = glcm_kernel.glcm_sums_reference(*args)
    torch.cuda.synchronize()
    calls = launch_count("glcm_sums") - before
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


def sums_times(args, size: int, card: str):
    """``glcm_sums`` on one band's ``args`` from a size^2 scene: held to
    its twin (:func:`compare_kernel`), then the kernel (10 calls) and the
    twin (3) timed with CUDA events, its bounds, and its kernels' split;
    no launch count read elsewhere includes these launches. Returns (max
    abs error, ms, plain ms, bound ms, bound ms with the band in place)."""
    from obia_tpu_torch.ops import glcm_kernel
    err = compare_kernel(args, f"{size}^2 scene band {args[2]}")
    ms = time_ms(lambda: glcm_kernel.glcm_sums(*args), 10)
    plain_ms = time_ms(lambda: glcm_kernel.glcm_sums_reference(*args), 3)
    bound, bound_l = sums_bound_ms([args]), sums_bound_ms([args], True)
    log(f"GLCM sums one band at {size}^2, K={args[3].shape[0]}: kernel "
        f"{ms:.3f} ms, plain torch {plain_ms:.3f} ms, bound {bound:.4f} ms "
        f"(band in place: {bound_l:.4f} ms) ({card})")
    kernel_split(lambda: glcm_kernel.glcm_sums(*args), "GLCM sums kernels")
    return err, ms, plain_ms, bound, bound_l


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


def blurred_input(scene: np.ndarray, bands, device: str):
    """The float32 image SLIC / quickshift cluster with ``sigma=1``: the
    scene's ``bands`` normalised, converted to Lab, then blurred."""
    import torch

    from obia_tpu_torch.ops.color import rgb_to_lab
    from obia_tpu_torch.ops.filters import gaussian_filter
    from obia_tpu_torch.segmentation.segment_boundaries import \
        _normalize_select
    lab = rgb_to_lab(_normalize_select(torch.as_tensor(
        scene, dtype=torch.float32, device=device), bands))
    return lab, gaussian_filter(lab, 1.0)


def sigma_check(run, scene, bands, what: str) -> None:
    """The ``sigma=1`` pre-blur on the card and on the CPU: the blurred
    float32 image within rtol 1e-6 (the blur alone, on the CPU's Lab image
    copied to the card, too), no convolution op in the card's blur, then
    the slice with ``sigma=1`` cross-checked as :func:`cross_check` does."""
    import torch

    from obia_tpu_torch.ops.filters import gaussian_filter
    lab_c, blur_c = blurred_input(scene, bands, "cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        lab_g, blur_g = blurred_input(scene, bands, "cuda")
        alone = gaussian_filter(lab_c.cuda(), 1.0).cpu()
    convs = [e.key for e in prof.key_averages()
             if "conv" in e.key.lower() or "cudnn" in e.key.lower()]
    d_lab = float((lab_g.cpu() - lab_c).abs().max())
    diff = (blur_g.cpu() - blur_c).abs()
    rel = float((diff / blur_c.abs().clamp(min=1e-30)).max())
    d_alone = float((alone - blur_c).abs().max())
    log(f"sigma=1 blur {what}, card vs CPU: Lab max |diff| {d_lab:.3e}, "
        f"blurred max |diff| {float(diff.max()):.3e} (max rel {rel:.3e}); "
        f"the blur alone on the same Lab image {d_alone:.3e}; convolution "
        f"ops {convs}")
    if convs:
        raise AssertionError(f"the blur ran a convolution: {convs}")
    torch.testing.assert_close(blur_g.cpu(), blur_c, rtol=1e-6, atol=0)
    torch.testing.assert_close(alone, blur_c, rtol=1e-6, atol=0)
    cross_check(lambda im, dev: run(im, dev, sigma=1.0), scene,
                f"{what}, sigma=1")


def config3_scene(size: int, root: str) -> str:
    """bench.py's config-3 raster: ``build_scene(size, size)`` written as
    an uncompressed GeoTIFF; returns its path."""
    return write_scene(os.path.join(root, f"scene_{size}.tif"),
                       build_scene(h=size, w=size))


def run_config3(raster: str, out_dir: str, device: str, **kw):
    """Config 3 (``bench.run_config3``: tile 512, buffer 64, n_segments
    700; raises if the manifest marks any tile failed or not done).
    Returns (segments, seconds)."""
    t0 = time.perf_counter()
    out = tbench.run_config3(raster, out_dir, device, **kw)
    return out, time.perf_counter() - t0


def coverage(geoms, size: int):
    """(label map, cover count) of polygons over a size^2 raster whose
    transform is Affine(1, 0, 0, 0, -1, size), each polygon rasterised over
    its own bounding box only: label k where polygon k covers a pixel
    centre (-1 where none), and how many polygons cover it."""
    from obia_tpu_torch.geometry.affine import Affine
    from obia_tpu_torch.geometry.rasterize import rasterize
    labels = np.full((size, size), -1, np.int64)
    counts = np.zeros((size, size), np.int32)
    for k, g in enumerate(geoms):
        x0, y0, x1, y1 = g.bounds
        c0, c1 = max(0, math.floor(x0)), min(size, math.ceil(x1))
        r0, r1 = max(0, math.floor(size - y1)), min(size,
                                                    math.ceil(size - y0))
        if c1 <= c0 or r1 <= r0:
            continue
        m = rasterize([(g, 1)], (r1 - r0, c1 - c0),
                      transform=Affine(1, 0, c0, 0, -1, size - r0),
                      dtype=np.uint8).astype(bool)
        counts[r0:r1, c0:c1] += m
        labels[r0:r1, c0:c1][m] = k
    return labels, counts


def config3_phase(size: int, root: str, card: str) -> None:
    """Config 3 at size^2 on the card, once (host-bound: a cold and a warm
    run were within 0.2 s of 128 s on the H100, and the tiles' SLIC is warm
    from the earlier phases): its stage split, the output read back, and
    its coverage."""
    from obia_tpu_torch import telemetry
    from obia_tpu_torch.io.gpkg import read_gpkg
    raster = config3_scene(size, root)
    mp = size * size / 1e6
    telemetry.reset()
    reset_launches()
    out_dir = os.path.join(root, "out")
    out, secs = run_config3(raster, out_dir, "cuda")
    launches = tbench.kernel_launches()
    split = stage_report()
    n = len(out)
    log(f"config 3 {size}^2 RGB ({C3_KW}): {n} segments, {secs:.3f} s, "
        f"{mp / secs:.4f} MP/s ({card}); hand-kernel launches {launches} "
        f"(none on this path)")
    for name in sorted(split):
        r = split[name]
        log(f"  stage {name}: {1000 * r['total_s']:.1f} ms in {r['count']} "
            f"calls")
    cols, geoms, _ = read_gpkg(os.path.join(out_dir, "segments.gpkg"))
    if cols["segment_id"] != list(range(1, n + 1)) or len(geoms) != n:
        raise AssertionError("segments.gpkg: rows or segment_id 1..N wrong")
    area = sum(g.area for g in geoms) / (size * size)
    t0 = time.perf_counter()
    _, counts = coverage(geoms, size)
    once = float((counts <= 1).mean())
    log(f"  coverage {area:.6f} of the raster's area, pixels covered at "
        f"most once {once:.6f} (rasterised in "
        f"{time.perf_counter() - t0:.1f} s)")
    if not 0.93 < area <= 1.0 + 1e-9 or once <= 0.995:
        raise AssertionError("config 3 coverage outside its bars")
    features = config3_objects(out, raster, "cuda")
    finite = float(np.isfinite(features["b0_mean"]).mean())
    log(f"  b0_mean finite on {finite:.6f} of the rows")
    if len(features) != n or finite < 0.99:
        raise AssertionError("config 3 features: rows or b0_mean wrong")


def config3_objects(layer, raster: str, device: str):
    """``create_objects`` on a config-3 layer (it carries no label raster,
    so the polygons are rasterised) over ``open_geotiff(raster)`` on
    ``device``, the stages synced; logs the time, the stages and the
    ``glcm_sums`` launches, and returns the table."""
    import torch

    from obia_tpu_torch import telemetry
    from obia_tpu_torch.handlers.geotif import open_geotiff
    from obia_tpu_torch.segmentation.segment_statistics import create_objects
    image = open_geotiff(raster)
    telemetry.reset()
    telemetry.enable(True)
    reset_launches()
    try:
        t0 = time.perf_counter()
        objs = create_objects(layer, image, device=device)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        telemetry.enable(False)
    log(f"  create_objects on the {len(layer)}-row layer ({device}, "
        f"rasterised): {seconds:.3f} s, glcm_sums launches "
        f"{tbench.kernel_launches()['glcm_sums']}; " + ", ".join(
            f"{k} {1000 * v['total_s']:.1f} ms"
            for k, v in stage_report().items()))
    if torch.device(device).type == "cuda" \
            and tbench.kernel_launches()["glcm_sums"] < 1:
        raise AssertionError("config 3 features launched no glcm_sums")
    return objs


def config3_cross_check(size: int, root: str) -> int:
    """Config 3 at size^2 on the card and on the CPU: segment counts within
    1%, rasterised partitions agreeing on >= 99.5% of the pixels; then the
    card's run resumed, which must segment no tile. Returns the card's
    segment count."""
    from obia_tpu_torch.utils import tiling
    raster = config3_scene(size, root)
    gpu_dir = os.path.join(root, f"gpu_{size}")
    gpu, g_s = run_config3(raster, gpu_dir, "cuda")
    cpu, c_s = run_config3(raster, os.path.join(root, f"cpu_{size}"), "cpu")
    lab_g, _ = coverage(gpu.geometry, size)
    lab_c, _ = coverage(cpu.geometry, size)
    agree = partition_agreement(lab_g, lab_c)
    log(f"cross-check config 3 {size}^2: {len(gpu)} segments on the card "
        f"({g_s:.3f} s), {len(cpu)} on the CPU ({c_s:.3f} s); partitions "
        f"agree on {agree:.6f} of the pixels")
    if abs(len(gpu) - len(cpu)) > 0.01 * len(cpu) or agree < 0.995:
        raise AssertionError("config 3 card vs CPU outside its bars")
    check_column_means(config3_objects(gpu, raster, "cuda"),
                       config3_objects(cpu, raster, "cpu"))
    calls = []
    real = tiling.create_segments
    tiling.create_segments = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        again, resumed = run_config3(raster, gpu_dir, "cuda", resume=True)
    finally:
        tiling.create_segments = real
    log(f"  the card's run resumed: {len(calls)} tiles segmented, "
        f"{len(again)} segments, {resumed:.3f} s")
    if calls or len(again) != len(gpu):
        raise AssertionError("the resumed run segmented a tile")
    return len(gpu)


def canopy_rasters(size: int, seed: int = 0):
    """A plot of tree crowns at 1 m: (CHM float32 with NaN nodata,
    density float32, 8-band WorldView-3-like uint16 stack with 0 nodata).
    Crowns sit on a jittered grid of pitch ``CANOPY_PITCH`` px, heights
    5-35 m, radii 3-8 px; the CHM is the tallest crown at each pixel, the
    density the sum of the crowns' kernels; a hole and a 3-px border are
    nodata in the CHM, another hole in the stack."""
    rng = np.random.default_rng(seed)
    g = np.arange(CANOPY_PITCH // 2, size, CANOPY_PITCH, dtype=np.float64)
    cy, cx = (a.ravel() for a in np.meshgrid(g, g, indexing="ij"))
    jit = CANOPY_PITCH / 4
    cy = cy + rng.uniform(-jit, jit, cy.size)
    cx = cx + rng.uniform(-jit, jit, cx.size)
    height = rng.uniform(5.0, 35.0, cy.size)
    radius = rng.uniform(3.0, 8.0, cy.size)
    chm = np.zeros((size, size), np.float32)
    den = np.zeros((size, size), np.float32)
    for y, x, h, r in zip(cy, cx, height, radius):
        reach = int(3 * r) + 1
        r0, r1 = max(0, int(y) - reach), min(size, int(y) + reach + 1)
        c0, c1 = max(0, int(x) - reach), min(size, int(x) + reach + 1)
        yy, xx = np.mgrid[r0:r1, c0:c1]
        k = np.exp(-((yy - y) ** 2 + (xx - x) ** 2) / (2 * r * r))
        np.maximum(chm[r0:r1, c0:c1], (h * k).astype(np.float32),
                   out=chm[r0:r1, c0:c1])
        den[r0:r1, c0:c1] += (10.0 * k).astype(np.float32)
    chm += rng.normal(0, 0.05, chm.shape).astype(np.float32)
    chm = np.maximum(chm, 0)
    hole = slice(size // 4, size // 4 + size // 16)
    chm[hole, hole] = np.nan
    chm[:3], chm[-3:], chm[:, :3], chm[:, -3:] = (np.nan,) * 4
    veg = np.clip(np.nan_to_num(chm) / 35.0, 0, 1)
    wv3 = np.empty((size, size, 8), np.uint16)
    for b, (soil, leaf) in enumerate(((300, 250), (350, 300), (450, 500),
                                      (500, 450), (600, 200), (900, 1900),
                                      (1000, 3200), (950, 3000))):
        band = soil + (leaf - soil) * veg + rng.normal(0, 20, veg.shape)
        wv3[:, :, b] = np.clip(band, 1, 65535).astype(np.uint16)
    far = slice(size // 2, size // 2 + size // 32)
    wv3[far, far] = 0
    return chm, den, wv3


def write_canopy_inputs(root: str, size: int, seed: int, device: str,
                        n_segments: int = 3000) -> dict:
    """The canopy workflow's inputs at size^2 in EPSG:32633, written with
    the port's own writers: chm.tif and density.tif (float32, -9999
    nodata), wv3.tif (uint16, 0 nodata) and slic.gpkg, the port's SLIC
    segments of the stack (``create_segments`` on ``device``) reprojected
    to EPSG:4326. Returns their paths."""
    from obia_tpu_torch.geometry.affine import Affine
    from obia_tpu_torch.geometry.transform_crs import (Transformer,
                                                       transform_geom)
    from obia_tpu_torch.handlers.geotif import image_from_array
    from obia_tpu_torch.io.gpkg import write_features
    from obia_tpu_torch.io.tiff import write_tiff
    from obia_tpu_torch.segmentation.segment_boundaries import \
        create_segments
    chm, den, wv3 = canopy_rasters(size, seed)
    t = Affine(1.0, 0.0, 500000.0, 0.0, -1.0, 5100000.0)
    paths = {k: os.path.join(root, f"{k}.tif") for k in ("chm", "density",
                                                        "wv3")}
    write_tiff(paths["chm"], np.where(np.isnan(chm), -9999.0, chm).astype(
        np.float32), transform=t, crs="EPSG:32633", nodata=-9999.0,
        compression="none")
    write_tiff(paths["density"], den, transform=t, crs="EPSG:32633",
               nodata=-9999.0, compression="none")
    write_tiff(paths["wv3"], wv3, transform=t, crs="EPSG:32633", nodata=0,
               compression="none")
    layer = create_segments(image_from_array(wv3, t, crs="EPSG:32633"),
                            segmentation_bands=[4, 6, 2],
                            n_segments=n_segments, device=device)
    tr = Transformer.from_crs(32633, 4326, always_xy=True)
    paths["slic"] = os.path.join(root, "slic.gpkg")
    write_features(paths["slic"], [("segment_id", layer.segment_id)],
                   [transform_geom(g, tr) for g in layer.geometry],
                   "slic", "EPSG:4326")
    return paths


def run_canopy(paths: dict, out_dir: str, device: str):
    """The canopy workflow on ``device``, each call as a user makes it:
    ``make_chm_seeds`` (defaults), ``make_density_seeds(d_min=4.5,
    min_dist_px=4, gauss_sigma=2)``, ``make_cost_surface`` with the SLIC
    layer and weights (0.4, 0.2, 0.2, 0.2), ``make_canonical_seeds``
    (defaults), synchronised. Returns (canonical table, output paths,
    seconds)."""
    import torch

    from obia_tpu_torch.utils.cost import make_cost_surface
    from obia_tpu_torch.utils.seeds import (make_canonical_seeds,
                                            make_chm_seeds,
                                            make_density_seeds)
    os.makedirs(out_dir, exist_ok=True)
    out = {k: os.path.join(out_dir, k) for k in (
        "chm_seeds.gpkg", "den_seeds.gpkg", "cost.tif", "canonical.gpkg")}
    t0 = time.perf_counter()
    make_chm_seeds(paths["chm"], out["chm_seeds.gpkg"], device=device)
    make_density_seeds(paths["density"], out["den_seeds.gpkg"], d_min=4.5,
                       min_dist_px=4, gauss_sigma=2, device=device)
    make_cost_surface(paths["wv3"], paths["chm"], out["cost.tif"],
                      slic=paths["slic"], weights=(0.4, 0.2, 0.2, 0.2),
                      device=device)
    table = make_canonical_seeds(out["chm_seeds.gpkg"], out["den_seeds.gpkg"],
                                 paths["chm"], out["cost.tif"],
                                 out["canonical.gpkg"], device=device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return table, out, time.perf_counter() - t0


def canopy_outputs(out: dict):
    """(stage-1 seed coordinates, cost raster and its reader, canonical
    rows) of a canopy run, read back from its files."""
    from obia_tpu_torch.io.gpkg import read_gpkg
    from obia_tpu_torch.io.tiff import TiffReader
    xy = [(g.x, g.y) for name in ("chm_seeds.gpkg", "den_seeds.gpkg")
          for g in read_gpkg(out[name])[1]]
    reader = TiffReader(out["cost.tif"])
    cols, geoms, _ = read_gpkg(out["canonical.gpkg"],
                               layer="canonical_seeds")
    rows = list(zip(*cols.values(), [(g.x, g.y) for g in geoms]))
    return np.array(xy), reader.read()[:, :, 0], reader, rows


def canopy_phase(size: int, root: str, seed: int, card: str) -> None:
    """The canopy workflow at size^2 on the card, cold, warm and profiled
    (stage times synced), with its outputs checked, and ``local_entropy``
    timed alone."""
    import torch

    from obia_tpu_torch import telemetry
    from obia_tpu_torch.ops.filters import disk_footprint, local_entropy
    t0 = time.perf_counter()
    paths = write_canopy_inputs(root, size, seed, "cuda")
    log(f"canopy {size}^2 inputs (CHM, density, 8-band stack, SLIC layer "
        f"in EPSG:4326) written in {time.perf_counter() - t0:.1f} s")
    _, _, cold = run_canopy(paths, os.path.join(root, "cold"), "cuda")
    torch.cuda.reset_peak_memory_stats()
    table, out, warm = run_canopy(paths, os.path.join(root, "warm"), "cuda")
    peak = torch.cuda.max_memory_allocated()
    telemetry.reset()
    telemetry.enable(True)
    try:
        _, _, profiled_s = run_canopy(paths, os.path.join(root, "profiled"),
                                      "cuda")
    finally:
        telemetry.enable(False)
    xy, cost, reader, rows = canopy_outputs(out)
    n = len(xy)
    log(f"canopy {size}^2 (seed {seed}): stage-1 seeds n = {n}, D "
        f"{n * n * 4:,} bytes ({n} x {n} float32), canonical seeds "
        f"{len(table)} in {len(set(table['cluster']))} clusters; cold "
        f"{cold:.3f} s, warm {warm:.3f} s, profiled {profiled_s:.3f} s; "
        f"peak device memory {peak / 2**30:.2f} GiB ({card})")
    for name, r in sorted(stage_report().items()):
        log(f"  stage {name}: {1000 * r['total_s']:.1f} ms in {r['count']} "
            f"calls")
    if not 15000 <= n <= 25000:
        raise AssertionError(f"stage 1 holds {n} seeds, not 15-25 k")
    nodata = cost == -9999.0
    if not (nodata.any() and (~nodata).mean() > 0.9
            and np.isfinite(cost).all()
            and 0 <= cost[~nodata].min() and cost[~nodata].max() <= 1):
        raise AssertionError("cost raster outside [0, 1] or nodata wrong")
    if (len(rows) != len(table) or not 0 < len(table) <= n
            or [r[0] for r in rows] != list(range(len(rows)))):
        raise AssertionError("canonical_seeds layer does not match its run")
    q = torch.as_tensor(np.random.default_rng(seed).integers(
        0, 256, (size, size), dtype=np.uint8), device="cuda")
    ms = time_ms(lambda: local_entropy(q, disk_footprint(3)), 3)
    log(f"  local_entropy alone at {size}^2 (256 levels x 29 taps, "
        f"~{256 * 33} launches): {ms:.1f} ms (CUDA events, {card})")


def canopy_cross_check(size: int, root: str, seed: int) -> None:
    """The canopy workflow at size^2 on the card and on the CPU, on the
    same input files: peak sets and canonical tables equal, cost rasters
    within atol 1e-6 with equal nodata, D within rtol 1e-6, and the DBSCAN
    labels equal (a difference is allowed only for a pair within 1e-6 of
    eps relative to eps, which is printed)."""
    import torch

    from obia_tpu_torch.utils.seeds import dbscan_labels, distance_matrix
    paths = write_canopy_inputs(root, size, seed, "cuda")
    res = {}
    for device in ("cuda", "cpu"):
        _, out, s = run_canopy(paths, os.path.join(root, device), device)
        res[device] = canopy_outputs(out) + (s,)
    (xy_g, cost_g, reader, rows_g, s_g), (xy_c, cost_c, _, rows_c, s_c) = \
        res["cuda"], res["cpu"]
    same_peaks = np.array_equal(xy_g, xy_c)
    cost_err = float(np.abs(cost_g - cost_c).max())
    same_nodata = np.array_equal(cost_g == -9999.0, cost_c == -9999.0)
    cost_in = np.where(cost_c == -9999.0, 1.0, cost_c)
    args = (xy_c[:, 0], xy_c[:, 1], cost_in, reader.transform, 0.5, 0.8, 12)
    d_g = distance_matrix(*args, device="cuda")
    d_c = distance_matrix(*args, device="cpu")
    d_err = float((d_g.cpu() - d_c).abs().max())
    d_ok = torch.allclose(d_g.cpu(), d_c, rtol=1e-6, atol=0)
    lab_g, lab_c = dbscan_labels(d_g, 1.5), dbscan_labels(d_c, 1.5)
    labels_ok = np.array_equal(lab_g, lab_c)
    if not labels_ok:
        near = torch.nonzero((d_c - 1.5).abs() <= 1.5e-6)
        log(f"  DBSCAN labels differ; pairs within 1e-6 of eps: "
            f"{near.tolist()}")
        labels_ok = len(near) > 0
    log(f"cross-check canopy {size}^2: {len(xy_g)} stage-1 seeds on the "
        f"card ({s_g:.3f} s), {len(xy_c)} on the CPU ({s_c:.3f} s); peak "
        f"sets equal {same_peaks}; cost max |diff| {cost_err:.3g}, nodata "
        f"equal {same_nodata}; D max |diff| {d_err:.3g} (rtol 1e-6: {d_ok}),"
        f" D bitwise {bool(torch.equal(d_g.cpu(), d_c))}; DBSCAN labels "
        f"equal {np.array_equal(lab_g, lab_c)}; canonical tables equal "
        f"{rows_g == rows_c} ({len(rows_g)} rows)")
    if not (same_peaks and cost_err <= 1e-6 and same_nodata and d_ok
            and labels_ok and rows_g == rows_c):
        raise AssertionError("canopy card vs CPU outside its bars")


def ql2_cloud(size: int, n: int, seed: int) -> dict:
    """A lidar cloud over a size^2 scene at 1 m (the transform
    Affine(1, 0, 0, 0, -1, size)): n points uniform in X and Y, about 30%
    ground returns (Z in [0, 1) m), the rest Z in [1, 30) m, uint16
    intensity."""
    rng = np.random.default_rng(seed)
    ground = rng.random(n) < 0.3
    return {"X": rng.uniform(0, size, n), "Y": rng.uniform(0, size, n),
            "Z": np.where(ground, rng.uniform(0, 1, n),
                          rng.uniform(1, 30, n)),
            "Intensity": rng.integers(0, 65536, n, dtype=np.uint16)}


def trace_kernels(log_dir: str) -> dict:
    """Device time (us) of each CUDA kernel in the Chrome trace that
    ``telemetry.trace`` wrote to ``log_dir``."""
    (name,) = os.listdir(log_dir)
    with open(os.path.join(log_dir, name)) as f:
        events = json.load(f)["traceEvents"]
    busy = {}
    for e in events:
        if e.get("cat") == "kernel":
            busy[e["name"]] = busy.get(e["name"], 0.0) + float(e["dur"])
    return busy


def trace_span(log_dir: str, top: int = 4) -> str:
    """One line on the Chrome trace in ``log_dir``: its CUDA kernels'
    count, their summed device time, the span from the first kernel's
    start to the last one's end, the device's idle share of that span, and
    the ``top`` kernels by device time."""
    (name,) = os.listdir(log_dir)
    with open(os.path.join(log_dir, name)) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "kernel"]
    if not events:
        raise AssertionError(f"no CUDA kernel in the trace {log_dir}")
    busy = sum(float(e["dur"]) for e in events)
    t0 = min(float(e["ts"]) for e in events)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in events)
    by_name = {}
    for e in events:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"])
    heads = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return (f"{len(events)} kernels, {busy / 1000:.1f} ms busy of a "
            f"{(t1 - t0) / 1000:.1f} ms span (idle {1 - busy / (t1 - t0):.1%})"
            f"; top: " + "; ".join(f"{n[:60]} {v / 1000:.1f} ms"
                                   for n, v in heads))


def compare_pc_stats(got: dict, want: dict, what: str) -> None:
    """Point-cloud columns card vs CPU: CH and the NaN slots equal, the
    rest within rtol 1e-12."""
    worst = 0.0
    for c in PC_COLUMNS:
        a, b = np.asarray(got[c]), np.asarray(want[c])
        if not np.array_equal(np.isnan(a), np.isnan(b)):
            raise AssertionError(f"{what} {c}: NaN slots differ")
        if c == "ch" and not np.array_equal(a, b, equal_nan=True):
            raise AssertionError(f"{what}: CH differs")
        ok = ~np.isnan(b)
        rel = np.abs(a[ok] - b[ok]) / np.maximum(np.abs(b[ok]), 1e-300)
        worst = max(worst, float(rel.max()) if rel.size else 0.0)
        if not np.allclose(a[ok], b[ok], rtol=1e-12, atol=0):
            raise AssertionError(f"{what} {c}: beyond rtol 1e-12")
    log(f"  {what}: CH and NaN slots equal, largest relative difference "
        f"{worst:.3e}")


def objects_phase(image, s, card: str, seed: int) -> int:
    """Phase 18, config 4 at full width on phase 4's layer and table:
    (a) every other object through the rasterise path, cold and warm, the
    warm call under ``telemetry.trace``; (b) the point-cloud families with
    a QL2 cloud, cold and warm, synced, and the statistics card vs CPU.
    Returns the warm (a) call's ``glcm_sums`` launches."""
    import tempfile

    import torch

    from obia_tpu_torch import telemetry
    from obia_tpu_torch.ops.pointcloud import segment_pointcloud_stats
    from obia_tpu_torch.segmentation.segment_statistics import create_objects
    full = s.table
    kept = full.take(np.arange(0, len(full), 2))

    def featurise():
        t0 = time.perf_counter()
        out = create_objects(kept, image)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    _, cold = featurise()
    with tempfile.TemporaryDirectory() as tdir:
        reset_launches()
        with telemetry.trace(tdir):
            out, warm = featurise()
        launches = tbench.kernel_launches()["glcm_sums"]
        busy = trace_kernels(tdir)
    sums_us = sum(v for k, v in busy.items()
                  if "glcm_small_kernel" in k or "glcm_large_kernel" in k)
    log(f"config 4 {SIZE}^2, create_objects on every other object ({len(kept)}"
        f" of {len(full)} rows, rasterised): cold {cold:.3f} s, warm "
        f"{warm:.3f} s under the trace ({card}); glcm_sums launches "
        f"{launches}; trace: {len(busy)} kernels, device busy "
        f"{sum(busy.values()) / 1e3:.1f} ms, glcm_sums kernels "
        f"{sums_us / 1e3:.2f} ms")
    if len(out) != len(kept) or launches < 1 or sums_us <= 0:
        raise AssertionError("rasterise path: rows, launches or the trace's "
                             "glcm_sums kernels missing")
    same = 0
    for c in full.columns:
        a, b = np.asarray(full[c][kept.rows], np.float64), np.asarray(
            out[c], np.float64)
        if not np.allclose(a, b, rtol=1e-6, atol=1e-6, equal_nan=True):
            raise AssertionError(f"rasterised column {c} != the unfiltered "
                                 "table's rows")
        same += np.array_equal(a, b, equal_nan=True)
    log(f"  every column equal to the unfiltered rows within rtol 1e-6 "
        f"({same} of {len(full.columns)} bitwise)")
    telemetry.reset()
    telemetry.enable(True)
    try:
        featurise()
    finally:
        telemetry.enable(False)
    log("  synced stages: " + ", ".join(
        f"{k} {1000 * v['total_s']:.1f} ms"
        for k, v in stage_report().items()))

    pc = ql2_cloud(SIZE, N_POINTS, seed)
    kw = dict(calculate_structural=True, calculate_radiometric=True,
              voxel_resolution=1.0, pointcloud=pc)
    times = []
    for _ in range(2):
        telemetry.reset()
        telemetry.enable(True)
        try:
            t0 = time.perf_counter()
            objs = create_objects(s.layer, image, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            telemetry.enable(False)
        times.append((wall, telemetry.report()["objects.pointcloud"][
            "total_s"]))
    labels = s.layer.labels_dev
    base = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    card_pc = segment_pointcloud_stats(pc, labels, image.transform, len(full),
                                       voxel_resolution=1.0)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    cpu_pc = segment_pointcloud_stats(pc, labels.cpu(), image.transform,
                                      len(full), voxel_resolution=1.0)
    cpu_s = time.perf_counter() - t0
    n_layers = int(np.floor(np.nanmax(card_pc["ch"]))) + 1
    log(f"config 4 {SIZE}^2 with {N_POINTS:,} points (QL2, 2 points/m^2; "
        f"{4 * N_POINTS * 8 / 1e9:.2f} GB as float64): create_objects cold "
        f"{times[0][0]:.3f} s (objects.pointcloud {1000 * times[0][1]:.1f} "
        f"ms), warm {times[1][0]:.3f} s (objects.pointcloud "
        f"{1000 * times[1][1]:.1f} ms), synced ({card}); FHD table about "
        f"{len(full)} x {n_layers} float64 "
        f"({len(full) * n_layers * 8 / 1e6:.2f} MB); the statistics alone: "
        f"card {1000 * card_s:.1f} ms (peak device memory {peak:.2f} GiB, "
        f"{base:.2f} GiB held before), CPU {1000 * cpu_s:.1f} ms")
    for c in PC_COLUMNS:
        if not np.array_equal(objs[c], card_pc[c], equal_nan=True):
            raise AssertionError(f"create_objects {c} != the card's stats "
                                 "(two runs on the card differ)")
        if np.isfinite(objs[c]).mean() < 0.99:
            raise AssertionError(f"{c} is NaN on more than 1% of the rows")
    compare_pc_stats(card_pc, cpu_pc, f"{N_POINTS:,} points card vs CPU")
    kernel_split(lambda: segment_pointcloud_stats(
        pc, labels, image.transform, len(full), voxel_resolution=1.0),
        "point-cloud statistics, one call")
    return launches


def objects_small_phase(seed: int) -> None:
    """Phase 19 at 256^2 (config 4's bands, n_segments=100): a LAS round
    trip into create_objects, the strict GLCM hatch on the card against the
    CPU, and ``slic()`` against ``slic_dense``."""
    import tempfile

    import torch

    from obia_tpu_torch.io.las import read_las, write_las
    from obia_tpu_torch.ops.slic import slic, slic_dense
    from obia_tpu_torch.segmentation.segment import segment
    from obia_tpu_torch.segmentation.segment_statistics import create_objects
    from obia_tpu_torch.vector.features import Features
    size = OBJ_SMALL_SIZE
    scene = config4_scene(size)
    image = as_image(scene)
    s = segment(image, segmentation_bands=[0, 3, 6],
                statistics_bands=list(range(BANDS)), n_segments=100,
                compactness=10, device="cuda")
    layer = s.layer
    rng = np.random.default_rng(seed)
    n = 40000
    eighths = {"X": rng.integers(0, 8 * size, n) / 8,
               "Y": rng.integers(0, 8 * size, n) / 8,
               "Z": rng.integers(0, 8 * 30, n) / 8,
               "Intensity": rng.integers(0, 65536, n, dtype=np.uint16)}
    kw = dict(calculate_structural=True, calculate_radiometric=True,
              voxel_resolution=1.0, calculate_textural=False)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "points.las")
        write_las(path, eighths, point_format=1, scale=(0.125,) * 3,
                  offset=(0.0,) * 3, crs="EPSG:32633")
        back = read_las(path)
        from_path = create_objects(layer, image, pointcloud=path, **kw)
    from_dict = create_objects(layer, image, pointcloud=eighths, **kw)
    for k in eighths:
        if not np.array_equal(back[k], eighths[k]):
            raise AssertionError(f"LAS round trip changed {k}")
    for c in PC_COLUMNS:
        if not np.array_equal(from_path[c], from_dict[c], equal_nan=True):
            raise AssertionError(f"create_objects(pointcloud=path) {c} != "
                                 "the dict input's")
    log(f"phase 19, {size}^2: LAS round trip of {n} points exact, "
        f"create_objects from the path equal to the dict input")

    table = Features({"segment_id": list(layer.segment_id)}, layer.geometry,
                     crs=layer.crs)
    def strict(dev):
        t0 = time.perf_counter()
        out = create_objects(table, image, strict_reference_glcm=True,
                             textural_bands=[0, 3, 6], device=dev)
        return out, time.perf_counter() - t0

    (g, g_s), (c, c_s) = strict("cuda"), strict("cpu")
    if not np.array_equal(g.label_raster, c.label_raster):
        raise AssertionError("rasterised label rasters differ")
    for col in g.columns:
        if col.startswith(("b0_", "b3_", "b6_")) and col.split("_", 1)[
                1] not in ("mean", "variance", "min", "max", "skewness",
                           "kurtosis"):
            if not np.array_equal(g[col], c[col], equal_nan=True):
                raise AssertionError(f"strict {col}: card != CPU")
    log(f"  strict_reference_glcm, {len(g)} objects, bands 0/3/6: card and "
        f"CPU columns equal, NaNs included ({g_s:.2f} s / {c_s:.2f} s)")
    check_column_means(g, c)

    x = np.ascontiguousarray(scene[:, :, [0, 3, 6]], np.float32) / 255.0
    labels = slic(x, n_segments=100, compactness=10)
    dense, k = slic_dense(torch.as_tensor(x, device="cuda"), n_segments=100,
                          compactness=10)
    if not np.array_equal(labels, dense.cpu().numpy() + 1):
        raise AssertionError("slic() != slic_dense labels + 1")
    log(f"  slic() on the card: {k} segments, labels equal to slic_dense's "
        "+ 1")


def crown_raster(size: int, bands: int, seed: int):
    """A forest plot at 1 m: crowns on a jittered grid of pitch
    ``DET_PITCH`` px with radii 5-12 px over soil, as ``bands`` uint16
    bands (soil and leaf reflectance per band plus noise), and each
    crown's box (x0, y0, x1, y1) at 1.5 radii, clipped to the raster."""
    rng = np.random.default_rng(seed)
    g = np.arange(DET_PITCH // 2, size, DET_PITCH, dtype=np.float64)
    cy, cx = (a.ravel() for a in np.meshgrid(g, g, indexing="ij"))
    jit = DET_PITCH / 4
    cy = cy + rng.uniform(-jit, jit, cy.size)
    cx = cx + rng.uniform(-jit, jit, cx.size)
    radius = rng.uniform(5.0, 12.0, cy.size)
    veg = np.zeros((size, size), np.float32)
    for y, x, r in zip(cy, cx, radius):
        reach = int(2 * r) + 1
        r0, r1 = max(0, int(y) - reach), min(size, int(y) + reach + 1)
        c0, c1 = max(0, int(x) - reach), min(size, int(x) + reach + 1)
        yy, xx = np.mgrid[r0:r1, c0:c1]
        k = np.exp(-((yy - y) ** 2 + (xx - x) ** 2) / (2 * (r / 1.5) ** 2))
        np.maximum(veg[r0:r1, c0:c1], k.astype(np.float32),
                   out=veg[r0:r1, c0:c1])
    soil = rng.uniform(300, 1000, bands)
    leaf = rng.uniform(200, 3200, bands)
    img = np.empty((size, size, bands), np.uint16)
    for b in range(bands):
        band = soil[b] + (leaf[b] - soil[b]) * veg + rng.normal(
            0, 25, veg.shape).astype(np.float32)
        img[:, :, b] = np.clip(band, 1, 65535).astype(np.uint16)
    half = 1.5 * radius
    boxes = np.stack([cx - half, cy - half, cx + half, cy + half], axis=1)
    boxes = np.clip(boxes, 0, size).round(1)
    return img, boxes


def conv_flops(model, size: int, probe: int = 256) -> int:
    """Multiply-add operations x 2 of every convolution in one forward of
    a size^2 image, counted by hooks on a forward at probe^2 and scaled by
    (size / probe)^2: exact when both are multiples of 128 (each level's
    map then scales by the same factor)."""
    import torch
    total = [0]

    def hook(m, inp, out):
        kh, kw = m.kernel_size
        total[0] += 2 * out.numel() * (m.in_channels // m.groups) * kh * kw

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, torch.nn.Conv2d)]
    try:
        with torch.inference_mode():
            model.eval()(torch.zeros(1, model.in_channels, probe, probe,
                                     device=model.device))
    finally:
        for h in hooks:
            h.remove()
    return total[0] * (size // probe) ** 2


def check_boxes(res: dict, size: int) -> None:
    """predict's output: finite scores, one label a box, every box inside
    the size x size raster."""
    boxes = res["boxes"]
    if not (np.isfinite(res["scores"]).all() and len(res["labels"]) ==
            len(boxes) == len(res["scores"]) and boxes.shape[1:] == (4,)):
        raise AssertionError("predict's output is malformed")
    if len(boxes) and not ((boxes >= 0).all() and (boxes <= size).all()):
        raise AssertionError("a predicted box leaves the raster")


def write_detection_tiles(root: str, n: int, size: int, seed: int) -> str:
    """``n`` crown tiles as uint16 GeoTIFFs and their ``annotations.json``
    (file_name, boxes, labels: the reference's layout). Returns the
    annotations' path."""
    from obia_tpu_torch.geometry.affine import Affine
    from obia_tpu_torch.io.tiff import write_tiff
    ann = {}
    for i in range(n):
        img, boxes = crown_raster(size, DET_BANDS, seed + i)
        name = f"tile_{i:02d}.tif"
        write_tiff(os.path.join(root, name), img,
                   transform=Affine(1.0, 0.0, 500000.0 + i * size, 0.0,
                                    -1.0, 5100000.0),
                   crs="EPSG:32633", compression="none")
        ann[f"tile_{i:02d}"] = {"file_name": name,
                                "boxes": boxes.tolist(),
                                "labels": [1] * len(boxes)}
    path = os.path.join(root, "annotations.json")
    with open(path, "w") as f:
        json.dump(ann, f)
    return path


class StepClock:
    """A loader for ``train_model`` that reads each epoch's batches first
    and then times each step on the host clock: from one batch handed out
    to the next (``train_model`` reads each step's loss, which waits for
    the card)."""

    def __init__(self, loader):
        self.loader = loader
        self.epochs = []

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        import torch
        batches = list(self.loader)
        times = []
        torch.cuda.synchronize()
        t = time.perf_counter()
        for batch in batches:
            yield batch
            now = time.perf_counter()
            times.append(now - t)
            t = now
        self.epochs.append(times)


def detection_phase(root: str, card: str, seed: int):
    """Phase 20: the full-width RetinaNet (``build_detection_model(
    num_classes=2, in_channels=10)``) trained for 2 epochs of 4 steps on 8
    crown tiles, its checkpoint read back, ``predict`` on a 4096^2 x 10
    scene (cold, warm, and with the stages synced) and ``evaluate_model`` on
    the tiles. Returns the trained model."""
    import contextlib
    import copy
    import io

    import torch

    from obia_tpu_torch import telemetry
    from obia_tpu_torch.detection import (build_detection_model, predict,
                                          train_model)
    from obia_tpu_torch.detection.train import (_pad_batch, batch_loss,
                                                make_train_step)
    from obia_tpu_torch.detection.dataset import (DataLoader,
                                                  TreeDetectionDataset)
    from obia_tpu_torch.detection.metrics import evaluate_model
    from obia_tpu_torch.detection.models import load_detection_checkpoint
    from obia_tpu_torch.detection.utils import get_transforms
    from obia_tpu_torch.geometry.affine import Affine
    from obia_tpu_torch.io.tiff import write_tiff

    t0 = time.perf_counter()
    ann = write_detection_tiles(root, DET_TILES, DET_TILE, seed)
    n_boxes = sum(len(v["boxes"]) for v in json.load(open(ann)).values())
    model = build_detection_model(num_classes=2, in_channels=DET_BANDS,
                                  seed=seed)
    n_par = sum(p.numel() for p in model.parameters())
    log(f"phase 20: {DET_TILES} tiles {DET_TILE}^2 x {DET_BANDS} bands, "
        f"{n_boxes} boxes; RetinaNet ResNet-50 (3, 4, 6, 3) width 64, FPN "
        f"256, {n_par} parameters, built on {model.device} "
        f"({time.perf_counter() - t0:.1f} s with the tiles)")
    ds = TreeDetectionDataset(root, ann, transforms=get_transforms(True))
    clock = StepClock(DataLoader(ds, batch_size=2, seed=0))
    ckpt = os.path.join(root, "ckpt")
    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train_model(model, clock, num_epochs=2, checkpoint_dir=ckpt)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(ln.split("Loss: ")[1])
              for ln in out.getvalue().splitlines() if "Loss: " in ln]
    for ln in out.getvalue().splitlines():
        log(f"  {ln}")
    steps = [s * 1000 for e in clock.epochs for s in e]
    warm = float(np.median(clock.epochs[1])) * 1000
    step_ops = 3 * 2 * conv_flops(model, DET_TILE)
    log(f"  train steps (ms, batch 2 x {DET_TILE}^2, synced): "
        f"{', '.join(f'{s:.1f}' for s in steps)}; warm step (median of "
        f"epoch 2) {warm:.1f} ms, ~{step_ops / 1e12:.3f} TFLOP of "
        f"convolutions (3x the forward's), {step_ops / warm / 1e9:.1f} "
        f"TFLOP/s; peak device memory {peak:.2f} GiB ({card})")
    if len(losses) != 2 or not np.isfinite(losses).all():
        raise AssertionError(f"epoch losses {losses}")
    back = load_detection_checkpoint(os.path.join(ckpt, "epoch_2.npz"),
                                     num_classes=2, in_channels=DET_BANDS)
    sd, sb = model.state_dict(), back.state_dict()
    if set(sd) != set(sb) or not all(torch.equal(sd[k], sb[k]) for k in sd):
        raise AssertionError("epoch_2.npz does not load back equal")
    log(f"  epoch_2.npz loads into a fresh model equal on all {len(sd)} "
        "tensors")
    del back
    twin = copy.deepcopy(model)
    opt = torch.optim.Adam(twin.parameters(), lr=1e-4)
    step = make_train_step(twin, opt)
    images, targets = next(iter(DataLoader(ds, batch_size=2, seed=1)))
    step(images, targets)
    torch.cuda.synchronize()
    with telemetry.trace(os.path.join(root, "trace_step")):
        step(images, targets)
    log(f"  one traced train step: "
        f"{trace_span(os.path.join(root, 'trace_step'))}")

    def default_step():
        """The same step with cuDNN's default (atomic) algorithms."""
        imgs, boxes, labels, hw = _pad_batch(list(images), list(targets),
                                             twin.device)
        loss = batch_loss(twin, imgs, boxes, labels, hw)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach()

    times = {"deterministic": [], "default": []}
    default_step()
    for _ in range(2):
        for what, fn in (("deterministic", lambda: step(images, targets)),
                         ("default", default_step)):
            for _ in range(5):
                t0 = time.perf_counter()
                float(fn())
                times[what].append(1000 * (time.perf_counter() - t0))
    med = {k: float(np.median(v)) for k, v in times.items()}
    log(f"  train step (batch 2 x {DET_TILE}^2, the loss read each step), "
        f"median of 10 alternating in blocks of 5: make_train_step "
        f"(cuDNN deterministic) {med['deterministic']:.1f} ms, cuDNN's "
        f"default algorithms {med['default']:.1f} ms: the flag costs "
        f"{med['deterministic'] - med['default']:+.1f} ms a step ({card})")
    del twin, step, opt

    scene, _ = crown_raster(DET_SCENE, DET_BANDS, seed + 100)
    path = os.path.join(root, "scene.tif")
    write_tiff(path, scene, transform=Affine(1.0, 0.0, 500000.0, 0.0, -1.0,
                                             5100000.0),
               crs="EPSG:32633", compression="none")
    del scene
    walls = []
    for what in ("cold", "warm"):
        t0 = time.perf_counter()
        res = predict(model, path)
        walls.append(time.perf_counter() - t0)
        check_boxes(res, DET_SCENE)
    log(f"  predict {DET_SCENE}^2 x {DET_BANDS} (score >= 0.5): cold "
        f"{walls[0]:.3f} s, warm {walls[1]:.3f} s, {len(res['boxes'])} "
        f"boxes ({card})")
    for thr in (0.5, 0.05):
        telemetry.reset()
        telemetry.enable(True)
        try:
            t0 = time.perf_counter()
            res = predict(model, path, score_threshold=thr)
            synced = time.perf_counter() - t0
        finally:
            telemetry.enable(False)
        check_boxes(res, DET_SCENE)
        log(f"  predict, score >= {thr}, stages synced: {synced:.3f} s: "
            + ", ".join(f"{k} {1000 * v['total_s']:.1f} ms"
                        for k, v in stage_report().items())
            + f"; {len(res['boxes'])} boxes")

    from obia_tpu_torch.detection.predict import scale_to_uint8
    from obia_tpu_torch.io.tiff import TiffReader
    raw = TiffReader(path).read()
    u8 = scale_to_uint8(raw, "cuda")
    lo, hi = float(raw.min()), float(raw.max())
    want = np.clip(255.0 * (raw.astype(np.float64) - lo) / (hi - lo + 1e-8),
                   0, 255).astype(np.uint8)
    if not np.array_equal(u8.cpu().numpy(), want):
        raise AssertionError("predict's uint8 raster on the card != numpy's")
    log(f"  predict's uint8 raster scaled on the card equal to numpy's "
        f"float64 scaling on the host ({DET_SCENE}^2 x {DET_BANDS})")
    del raw, want
    x = u8.to(torch.float32).permute(2, 0, 1)[None].contiguous()
    del u8
    model.eval()
    with torch.inference_mode():
        fwd = time_ms(lambda: model(x), 3)
        with telemetry.trace(os.path.join(root, "trace_forward")):
            model(x)
    del x
    ops = conv_flops(model, DET_SCENE)
    log(f"  forward alone at {DET_SCENE}^2 (CUDA events, mean of 3): "
        f"{fwd:.1f} ms ({card}); its convolutions {ops / 1e12:.3f} TFLOP: "
        f"{ops / fwd / 1e9:.1f} TFLOP/s, {ops / FP32_OPS_PER_MS / fwd:.1%} "
        f"of the 67 TFLOP/s float32 peak (bound {ops / FP32_OPS_PER_MS:.1f} "
        f"ms); traced: {trace_span(os.path.join(root, 'trace_forward'))}")
    t0 = time.perf_counter()
    ev = evaluate_model(model, TreeDetectionDataset(root, ann))
    log(f"  evaluate_model on the {DET_TILES} tiles: AP@0.5 {ev['AP']:.4f}, "
        f"{ev['n_predictions']} predictions of {ev['n_ground_truth']} "
        f"crowns ({time.perf_counter() - t0:.2f} s)")
    return model


def _gap(a, b) -> float:
    """max |a - b| over max |b| (b the reference side)."""
    b = b.detach().cpu().double()
    return float((a.detach().cpu().double() - b).abs().max()
                 / b.abs().max().clamp_min(1e-30))


def _l2_gap(a: dict, b: dict) -> float:
    """||a - b|| / ||b|| over every tensor of two gradient dicts."""
    num = sum(float((a[k].detach().cpu().double()
                     - b[k].detach().cpu().double()).pow(2).sum())
              for k in b)
    den = sum(float(b[k].detach().cpu().double().pow(2).sum()) for k in b)
    return math.sqrt(num / den)


def detection_cross_check(model) -> None:
    """Phase 21 (a): the trained full-width model on the card and a copy
    on the CPU, on the same 2 x 10 x 256^2 inputs: the eval forward, the
    running statistics after one train-mode forward, and one train step's
    loss and gradients, in float32 and in float64 (the float64 CPU
    gradient is the reference both float32 gradients are measured
    against)."""
    import torch

    from obia_tpu_torch.detection.models import (detection_model_from_jax,
                                                 detection_state_to_jax_tree)
    from obia_tpu_torch.detection.train import batch_loss
    tree = detection_state_to_jax_tree(model)
    cfg = dict(num_classes=2, in_channels=DET_BANDS)

    def pair(dtype=torch.float32):
        return [detection_model_from_jax(tree["params"], tree["batch_stats"],
                                         device=d, **cfg).to(dtype)
                for d in ("cuda", "cpu")]

    rng = np.random.default_rng(21)
    x = torch.as_tensor((rng.random((2, DET_BANDS, DET_CROSS, DET_CROSS))
                         * 255).astype(np.float32))
    x[:, :, 60:110, 80:130] *= 0.3
    boxes = [torch.tensor([[80.0, 60.0, 130.0, 110.0],
                           [10.0, 150.0, 40.0, 190.0]]),
             torch.tensor([[80.0, 60.0, 130.0, 110.0]])]
    labels = [torch.tensor([1, 1]), torch.tensor([1])]

    def step(m):
        """One train step's loss and gradients on the model's device."""
        dt = next(m.parameters()).dtype
        loss = batch_loss(m, x.to(m.device, dt),
                          [b.to(m.device, dt) for b in boxes],
                          [lb.to(m.device) for lb in labels],
                          (DET_CROSS, DET_CROSS))
        loss.backward()
        return float(loss.detach()), {n: p.grad.detach().cpu()
                                      for n, p in m.named_parameters()}

    card, cpu = pair()
    with torch.no_grad():
        outs = [m.eval()(x.to(m.device)) for m in (card, cpu)]
        fwd = [_gap(a, b) for a, b in zip(*outs)]
        for m in (card, cpu):
            m.train()(x.to(m.device))
    cpu_bufs = dict(cpu.named_buffers())
    bufs = {n: _gap(b, cpu_bufs[n]) for n, b in card.named_buffers()}
    mean_gap = max(v for n, v in bufs.items() if n.endswith("running_mean"))
    var_gap = max(v for n, v in bufs.items() if n.endswith("running_var"))
    (l32c, g32c), (l32p, g32p) = (step(m) for m in pair())
    (l64c, g64c), (l64p, g64p) = (step(m) for m in pair(torch.float64))
    del card, cpu, outs
    loss_gap = abs(l32c - l32p) / abs(l32p)
    loss64 = abs(l64c - l64p) / abs(l64p)
    grad64 = max(_gap(g64c[n], g64p[n]) for n in g64p)
    per = {who: {n: _gap(g[n], g64p[n]) for n in g64p}
           for who, g in (("card", g32c), ("cpu", g32p))}
    worst = {who: max(v.items(), key=lambda kv: kv[1])
             for who, v in per.items()}
    l2 = {who: _l2_gap(g, g64p) for who, g in (("card", g32c),
                                                ("cpu", g32p))}
    l2_32 = _l2_gap(g32c, g32p)
    log(f"phase 21 (a), full width, 2 x {DET_BANDS} x {DET_CROSS}^2, card vs "
        f"CPU (gaps over each tensor's largest magnitude): eval class "
        f"logits {fwd[0]:.2e}, box deltas {fwd[1]:.2e}; running means "
        f"{mean_gap:.2e}, variances {var_gap:.2e}; train-step loss "
        f"{loss_gap:.2e} (float64 {loss64:.2e}); gradients in float64 "
        f"{grad64:.2e}")
    log(f"  float32 gradients against the CPU's float64: card worst "
        f"{worst['card'][1]:.2e} ({worst['card'][0]}), CPU worst "
        f"{worst['cpu'][1]:.2e} ({worst['cpu'][0]}); relative L2 over all "
        f"gradients card {l2['card']:.2e}, CPU {l2['cpu']:.2e}; card vs "
        f"CPU float32 {l2_32:.2e}")
    bars = dict(forward=(max(fwd), 1e-4), running_var=(var_gap, 1e-4),
                running_mean=(mean_gap, 1e-4), loss=(loss_gap, 1e-4),
                float64=(max(loss64, grad64), 1e-9),
                float32_l2=(l2["card"], max(4 * l2["cpu"], 1e-4)))
    for what, (got, bar) in bars.items():
        if not got <= bar:
            raise AssertionError(f"card vs CPU {what}: {got:.3e} > {bar}")


def detection_overfit_on_card() -> list:
    """Phase 21 (b): tests/test_detection.py:243's overfit run on the card
    (two 128^2 scenes, width 8, FPN 32, stages (1, 1, 1, 1), Adam 2e-3, 400
    steps): the loss below 10% of its first value, AP@0.5 >= 0.9 through
    ``evaluate_model``. ``make_train_step`` runs cuDNN's deterministic
    algorithms (its default weight gradients add with atomics, so two runs
    of the 400 float32 steps would part ways). Returns the losses."""
    import torch

    from obia_tpu_torch.detection import build_detection_model
    from obia_tpu_torch.detection.metrics import evaluate_model
    from obia_tpu_torch.detection.train import make_train_step
    S = 128
    imgs, targets = [], []
    for seed, coords in ((0, [(20, 30), (70, 80)]), (1, [(40, 16), (90, 60)])):
        r = np.random.default_rng(seed)
        img = r.normal(0.0, 0.05, (S, S, 3)).astype(np.float32)
        for (x0, y0) in coords:
            img[y0:y0 + 24, x0:x0 + 24] += 1.0
        imgs.append(np.transpose(img, (2, 0, 1)))
        targets.append({"boxes": np.array([[x0, y0, x0 + 24, y0 + 24]
                                           for x0, y0 in coords],
                                          np.float32),
                        "labels": np.array([1, 1], np.int64)})

    class Scenes:
        def __len__(self):
            return 2

        def __getitem__(self, i):
            return imgs[i], targets[i]

    model = build_detection_model(seed=0, image_size=(S, S), **DET_SMALL)
    step = make_train_step(model, torch.optim.Adam(model.parameters(),
                                                   lr=2e-3))
    t0 = time.perf_counter()
    losses = [float(step(imgs, targets)) for _ in range(400)]
    secs = time.perf_counter() - t0
    res = evaluate_model(model, Scenes(), score_threshold=0.05)
    log(f"phase 21 (b), overfit on the card: loss {losses[0]:.4f} -> "
        f"{losses[-1]:.6f} in 400 steps ({1000 * secs / 400:.2f} ms a "
        f"step), AP@0.5 {res['AP']:.4f} ({res['n_predictions']} "
        f"predictions of {res['n_ground_truth']})")
    if not losses[-1] < 0.1 * losses[0] or res["AP"] < 0.9:
        raise AssertionError(f"overfit bar missed: {losses[0]} -> "
                             f"{losses[-1]}, AP {res['AP']}")
    return losses


def detection_phases(seed: int, card: str) -> None:
    """Phases 20-21 in a scratch directory."""
    import shutil
    import tempfile
    root = tempfile.mkdtemp(prefix="obia_detection_")
    try:
        model = detection_phase(root, card, seed)
        detection_cross_check(model)
        del model
        detection_overfit_on_card()
    finally:
        shutil.rmtree(root, ignore_errors=True)


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
    t = (time_ms(lambda: qk.quickshift_density(x, r, k), n),
         time_ms(lambda: qk.quickshift_density_reference(x, r, k), 1),
         time_ms(lambda: qk.quickshift_parent(x, rn, r, md), n),
         time_ms(lambda: qk.quickshift_parent_reference(x, rn, r, md), 1))
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
    for name, r in stage_report().items():
        peak = (f", peak {r['peak_bytes'] / 2 ** 30:.2f} GiB"
                if "peak_bytes" in r else "")
        log(f"  stage {name}: {1000 * r['total_s']:.1f} ms{peak}")
    return out


def train_inputs(size: int, n_segments: int, n_classes: int = FUSED_CLASSES,
                 seed: int = 0, width: int | None = None):
    """Phases 23-24's inputs: config 5's RGB scene (``build_scene``, size
    x ``width`` or square) as float32 scaled to [0, 1), and seeded fixed
    targets for the K objects of the sharded step's grid."""
    from obia_tpu_torch.ops.slic import _grid_shape
    width = size if width is None else width
    gh, gw = _grid_shape(size, width, n_segments)
    scene = build_scene(h=size, w=width, c=3).astype(np.float32) / 256.0
    return scene, np.random.default_rng(seed).integers(0, n_classes,
                                                       gh * gw)


def run_train_steps(mesh, scene: np.ndarray, targets: np.ndarray,
                    steps: int, n_segments: int) -> dict:
    """``steps`` sharded training steps over ``mesh`` from the seeded
    head: each step's loss (float32) and host-clock time (synced by
    reading the loss), and the parameters and centres after the last. The
    image is sharded from the host, so a rank of a mesh that spans ranks
    holds only its own blocks."""
    import torch
    from obia_tpu_torch.models.pipeline import (initial_centers,
                                                make_sharded_train_step,
                                                params_to_jax)
    from obia_tpu_torch.parallel.mesh import shard_raster
    step, init, (gh, gw, K) = make_sharded_train_step(
        mesh, *scene.shape, n_segments, FUSED_CLASSES)
    host = torch.as_tensor(scene)
    image = shard_raster(mesh, host)[0]
    centers = initial_centers(host, gh, gw).to(mesh.home)
    t = torch.as_tensor(targets).to(mesh.home)
    model, opt = init()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        model, opt, loss, centers = step(image, t, centers, model, opt)
        losses.append(loss.cpu().numpy())
        times.append(time.perf_counter() - t0)
    return {"losses": np.stack(losses), "times": times, "K": K,
            "centers": centers.cpu().numpy(), **params_to_jax(model)}


def fused_phase(card: str) -> None:
    """Phase 22: the fused forward (``make_flagship``) at the JAX driver's
    shape on the card, cold and warm, against the CPU; then at config 4's
    size at full width, timed, its peak memory read and one run traced."""
    import tempfile

    import torch
    from obia_tpu_torch import telemetry
    from obia_tpu_torch.models.pipeline import (init_mlp_params,
                                                make_flagship, obia_forward)
    from obia_tpu_torch.ops.slic import _grid_shape

    fn, (image, model) = make_flagship()

    def run():
        t0 = time.perf_counter()
        out = fn(image, model)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    _, cold = run()
    (logits, labels), warm = run()
    K = logits.shape[0]
    if (logits.shape != (256, FUSED_CLASSES) or labels.shape != (512, 512)
            or not bool(torch.isfinite(logits).all())):
        raise AssertionError(f"flagship: logits {tuple(logits.shape)}, "
                             f"labels {tuple(labels.shape)}")
    cfn, (cimage, cmodel) = make_flagship(device="cpu")
    clogits, clabels = cfn(cimage, cmodel)
    lab, clab = labels.cpu().numpy(), clabels.numpy()
    same = float((lab == clab).mean())
    agree = 1.0 if same == 1.0 else partition_agreement(lab, clab)
    gap = _gap(logits, clogits)
    log(f"phase 22, make_flagship() 512^2 x 4, K={K}: cold {cold:.3f} s, "
        f"warm {warm * 1e3:.2f} ms ({card}); card vs CPU labels equal on "
        f"{same:.6f} of the pixels (partitions {agree:.6f}), logits "
        f"{gap:.2e} of their largest magnitude")
    if agree < 0.9999 or gap > 1e-5:
        raise AssertionError("flagship card vs CPU past its bars")

    scene = config4_scene(SIZE).astype(np.float32) / 256.0
    img = torch.as_tensor(scene, device="cuda")
    gh, gw = _grid_shape(SIZE, SIZE, N_SEGMENTS)
    head = init_mlp_params(0, 2 * BANDS + 1, FUSED_CLASSES, device="cuda")

    def forward():
        return obia_forward(img, head, gh=gh, gw=gw)

    t0 = time.perf_counter()
    forward()
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, labels = forward()
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ev = time_ms(forward, 3)
    with tempfile.TemporaryDirectory() as tdir:
        with telemetry.trace(tdir):
            forward()
        span = trace_span(tdir)
    K = gh * gw
    if (logits.shape != (K, FUSED_CLASSES)
            or not bool(torch.isfinite(logits).all())
            or labels.shape != (SIZE, SIZE) or int(labels.min()) < 0
            or int(labels.max()) >= K):
        raise AssertionError("the fused forward at config 4's size gave "
                             "bad logits or labels")
    log(f"phase 22, obia_forward at {SIZE}^2 x {BANDS} (config 4's scene / "
        f"256), {gh} x {gw} grid (K={K}), hidden 64, {FUSED_CLASSES} "
        f"classes, 5 iterations: cold {cold:.3f} s, warm {warm * 1e3:.1f} ms"
        f" synced, {ev:.1f} ms by CUDA events, peak device memory "
        f"{peak:.2f} GiB; traced: {span} ({card})")


def sharded_train_phase(card: str) -> None:
    """Phase 23: ``make_sharded_train_step`` on a 2 x 4 mesh of shards on
    the card at config 5's 4096^2 RGB, TRAIN_STEPS steps; then 3 steps at
    512^2 on the card against the same on the CPU."""
    import torch
    from obia_tpu_torch.parallel.mesh import make_mesh
    scene, targets = train_inputs(C5_SIZE, N_SEGMENTS)
    r = run_train_steps(make_mesh(C5_SHARDS, ["cuda:0"]), scene, targets,
                        TRAIN_STEPS, N_SEGMENTS)
    K = r["K"]
    kpad = -(-K // C5_SHARDS) * C5_SHARDS
    losses = r["losses"]
    log(f"phase 23, sharded train step at {C5_SIZE}^2 RGB on a 2 x 4 mesh "
        f"on the card, K={K} (Kpad {kpad}), {TRAIN_STEPS} steps: first "
        f"{r['times'][0]:.3f} s, median warm step "
        f"{float(np.median(r['times'][1:])) * 1e3:.1f} ms, warm steps "
        f"{min(r['times'][1:]) * 1e3:.1f}-{max(r['times'][1:]) * 1e3:.1f} "
        f"ms; loss {float(losses[0]):.6f} -> {float(losses[-1]):.6f} "
        f"({card})")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"sharded step losses {losses.tolist()}")

    scene, targets = train_inputs(CROSS_SIZE, CROSS_SEGMENTS)
    got = run_train_steps(make_mesh(C5_SHARDS, ["cuda:0"]), scene, targets,
                          3, CROSS_SEGMENTS)
    want = run_train_steps(make_mesh(C5_SHARDS, ["cpu"]), scene, targets, 3,
                           CROSS_SEGMENTS)
    loss_gap = float(np.abs(got["losses"] / want["losses"] - 1.0).max())
    gaps = {k: _gap(torch.as_tensor(got[k]), torch.as_tensor(want[k]))
            for k in ("w1", "b1", "w2", "b2")}
    C = scene.shape[2]
    colour = float(np.abs(got["centers"][..., :C]
                          - want["centers"][..., :C]).max())
    px = float(np.abs(got["centers"][..., C:]
                      - want["centers"][..., C:]).max())
    log(f"phase 23, card vs CPU at {CROSS_SIZE}^2 RGB, {CROSS_SEGMENTS} "
        f"segments, 3 steps: loss rtol {loss_gap:.2e}, parameters "
        + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items())
        + f" of their largest magnitudes, centres {colour:.2e} in colour, "
        f"{px:.2e} px")
    if (loss_gap > 1e-5 or max(gaps.values()) > 1e-5 or colour > 1e-5
            or px > 1e-3):
        raise AssertionError("sharded step card vs CPU past its bars")


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def two_rank_worker(rank: int, port: int, out_dir: str, device: str,
                    size: int, width: int, steps: int) -> None:
    """One rank of phase 24 (``chip_smoke.py --two-rank-worker``): join a
    two-rank gloo group, read the process info, all-reduce a (1, 4)
    tensor of rank + 1 on ``device``, note the shards and blocks it holds
    and what a mesh that spans ranks refuses, run ``steps`` sharded steps
    with shard row ``rank`` of the mesh, save them to ``out_dir`` and
    print one RESULT line."""
    t0 = time.perf_counter()
    import torch
    import torch.distributed as dist
    from obia_tpu_torch.parallel.distributed import (initialize,
                                                     is_coordinator,
                                                     process_info)
    from obia_tpu_torch.parallel.mesh import make_mesh, shard_raster
    from obia_tpu_torch.parallel.mosaic import (mosaic_pipeline,
                                                segment_mosaic_device)
    initialize(coordinator_address=f"127.0.0.1:{port}", num_processes=2,
               process_id=rank, backend="gloo", timeout_s=60)
    initialize(coordinator_address="127.0.0.1:1", num_processes=2,
               process_id=rank)  # already initialised: a no-op
    try:
        res = {"rank": rank, "info": process_info(),
               "coordinator": is_coordinator()}
        t = torch.full((1, 4), float(rank + 1), device=device)
        dist.all_reduce(t)
        res["total"] = float(t.sum())
        scene, targets = train_inputs(size, CROSS_SEGMENTS, width=width)
        mesh = make_mesh(C5_SHARDS, [device], distributed=True)
        res["held"] = [list(ij) for ij in mesh.shards()]
        res["blocks"] = [[b is not None for b in row] for row in
                         shard_raster(mesh, torch.as_tensor(scene))[0].blocks]
        try:
            make_mesh(3, [device], distributed=True)
        except ValueError:
            res["ragged_rows_refused"] = True
        res["mosaic_refused"] = []
        for call in (lambda: mosaic_pipeline(None, mesh=mesh),
                     lambda: segment_mosaic_device(scene, mesh=mesh)):
            try:
                call()
            except ValueError as exc:
                res["mosaic_refused"].append(str(exc))
        r = run_train_steps(mesh, scene, targets, steps, CROSS_SEGMENTS)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 **{k: v for k, v in r.items() if k not in ("times", "K")})
    finally:
        dist.destroy_process_group()
    print("RESULT " + json.dumps(dict(res, times=r["times"],
                                      wall=time.perf_counter() - t0)),
          flush=True)


def two_rank_check(card: str, device: str = "cuda:0",
                   size: int = TWO_RANK_SIZE, steps: int = TWO_RANK_STEPS,
                   timeout: float = 300.0, width: int | None = None
                   ) -> list:
    """Phase 24: two worker processes (new interpreters), one shard row
    each, sharing ``device``: their 12.0 reduction, process info, held
    shards and refusals, and their parameters, losses and centres equal
    bit for bit to the same steps in this process. Returns the workers'
    RESULT dicts, each with ``bitwise``: the saved arrays found equal."""
    import subprocess
    import tempfile

    import torch
    from obia_tpu_torch.parallel.mesh import make_mesh
    width = size if width is None else width
    scene, targets = train_inputs(size, CROSS_SEGMENTS, width=width)
    one = run_train_steps(make_mesh(C5_SHARDS, [device]), scene, targets,
                          steps, CROSS_SEGMENTS)
    # the visible cards, all shared by both ranks; with none, each rank's
    # CPU is its own device
    cards = torch.cuda.device_count()
    port = free_port()
    with tempfile.TemporaryDirectory() as d:
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--two-rank-worker",
             str(r), str(port), d, device, str(size), str(width),
             str(steps)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in (0, 1)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                p.kill()
                p.wait()
        for r, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise AssertionError(f"rank {r} exited {p.returncode}:\n"
                                     f"{out[-3000:]}")
        results = [json.loads(next(line for line in out.splitlines()
                                   if line.startswith("RESULT "))[7:])
                   for out in outs]
        saved = [dict(np.load(os.path.join(d, f"rank{r}.npz")))
                 for r in (0, 1)]
    for r, (res, got) in enumerate(zip(results, saved)):
        if res["total"] != 12.0:
            raise AssertionError(f"rank {r}: all_reduce total {res['total']}")
        info = {"process_index": r, "process_count": 2,
                "local_devices": max(cards, 1),
                "global_devices": cards or 2}
        if res["info"] != info or res["coordinator"] is not (r == 0):
            raise AssertionError(f"rank {r}: {res['info']}, coordinator "
                                 f"{res['coordinator']}; want {info}")
        if (res["held"] != [[r, j] for j in range(C5_SHARDS // 2)]
                or res["blocks"] != [[i == r] * (C5_SHARDS // 2)
                                     for i in range(2)]):
            raise AssertionError(f"rank {r} holds {res['held']}, blocks "
                                 f"{res['blocks']}")
        if not res.get("ragged_rows_refused") or len(
                res["mosaic_refused"]) != 2 or not all(
                "spans ranks" in m for m in res["mosaic_refused"]):
            raise AssertionError(f"rank {r}: a mesh across ranks not "
                                 f"refused: {res}")
        res["bitwise"] = sorted(k for k in got
                                if np.array_equal(got[k], one[k]))
        if res["bitwise"] != sorted(got):
            raise AssertionError(f"rank {r}: only {res['bitwise']} of "
                                 f"{sorted(got)} equal the one-process run")
        log(f"phase 24, rank {r} of 2 (gloo, {device}): all_reduce total "
            f"{res['total']}, {res['info']}, wall {res['wall']:.2f} s, steps "
            + ", ".join(f"{t * 1e3:.1f}" for t in res["times"]) + " ms")
    log(f"phase 24, two ranks at {size} x {width} RGB, {steps} steps: "
        f"parameters, "
        f"losses and centres equal bit for bit to one process (steps "
        + ", ".join(f"{t * 1e3:.1f}" for t in one["times"])
        + f" ms) ({card})")
    return results


def bench_row(card: str, config: int, size=None, env=None,
              want=None, tag: str = "phase 25") -> dict:
    """``python -m obia_tpu_torch.bench [size] --config N`` in a new
    process, with ``env`` added to the environment: it exits 0, its last
    line is a row with ``value`` > 0 on this card whose path's kernels
    launched, and its ``n_objects`` equals ``want`` unless that is None.
    Logs the row after ``tag``; returns it."""
    need = {1: ("glcm_sums",), 4: ("glcm_sums",),
            2: ("glcm_sums", "qs_density", "qs_parent"),
            5: ("glcm_sums", "glcm_hist"), 3: ()}
    cmd = [sys.executable, "-m", "obia_tpu_torch.bench", "--config",
           str(config), *([str(size)] if size else [])]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=400, env={**os.environ, **(env or {})})
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(cmd[1:])} exited "
                             f"{proc.returncode}: {proc.stderr[-3000:]}")
    row = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"{tag}, {' '.join(cmd[2:])}: {row['config']}, "
        f"{row['n_objects']} objects, {row['value']:.4f} MP/s (best "
        f"{row['elapsed_s']:.3f} s, first {row['first_run_s']:.3f} s, "
        f"{row['megapixels']:.3f} MP), forest {row['forest']}, "
        f"launches {row['launches']}; process {wall:.1f} s "
        f"({row['device']})")
    missed = [k for k in need[config] if row["launches"][k] < 1]
    if not row["value"] > 0 or row["device"] != card or missed:
        raise AssertionError(f"config {config}'s row: value "
                             f"{row['value']}, device {row['device']},"
                             f" no launches of {missed}")
    if want is not None and row["n_objects"] != want:
        raise AssertionError(f"config {config}: {row['n_objects']} "
                             f"objects, the earlier phase {want}")
    return row


def bench_phase(card: str, want: dict) -> dict:
    """Phase 25: :func:`bench_row` for configs 1, 4, 2 and 5 at their
    default sizes and config 3 at ``C3_CROSS_SIZE``^2 with
    ``OBIA_BENCH_RUNS=1``, configs 4, 2, 5 and 3 counting ``want[config]``
    objects (the same scene, size and device in an earlier phase). Returns
    the rows by config."""
    rows = {}
    for config, size, env in ((1, None, {}), (4, None, {}), (2, None, {}),
                              (5, None, {}),
                              (3, C3_CROSS_SIZE, {"OBIA_BENCH_RUNS": "1"})):
        rows[config] = bench_row(card, config, size, env, want.get(config))
    return rows


# -- phase 26: the north-star scene ------------------------------------------

def pixel_counts(geometry, transform) -> np.ndarray:
    """Each polygon's area in pixels of the affine ``transform``."""
    a, b, _, d, e = tuple(transform)[:5]
    return np.array([g.area for g in geometry]) / abs(a * e - b * d)


def check_north_star(labels, K: int, pixels: np.ndarray, table, proba,
                     what: str) -> None:
    """Phase 26's checks of one run, none of which needs a CPU run at the
    same size: every pixel owned and the labels dense 0..K-1 (each id
    present); K polygons whose areas (``pixels``, in pixels) add up to the
    raster's within 1e-6 relative and, object by object, equal the labels'
    bincount within 1e-6 relative; a table of K rows with no NaN in a
    spectral or GLCM column (every object is non-empty); with ``proba``,
    K probability rows adding up to 1."""
    import torch
    lab = labels.reshape(-1)
    N = lab.numel()
    unowned = int((lab < 0).sum())
    if unowned:
        raise AssertionError(f"{what}: {unowned} pixels belong to no object")
    counts = torch.bincount(lab.long(), minlength=K).cpu().numpy()
    if len(counts) != K or not (counts > 0).all():
        raise AssertionError(f"{what}: labels are not dense 0..{K - 1} "
                             f"(max {len(counts) - 1}, "
                             f"{int((counts == 0).sum())} ids unused)")
    pixels = np.asarray(pixels, np.float64)
    if len(pixels) != K:
        raise AssertionError(f"{what}: {len(pixels)} polygons for {K} "
                             f"objects")
    total = float(pixels.sum())
    if not abs(total - N) <= 1e-6 * N:
        raise AssertionError(f"{what}: the polygons' areas add up to "
                             f"{total} px, the raster holds {N}")
    off = np.flatnonzero(~(np.abs(pixels - counts) <= 1e-6 * counts))
    if off.size:
        raise AssertionError(f"{what}: {off.size} objects' polygon areas "
                             f"differ from their pixel counts (object "
                             f"{off[0]}: {pixels[off[0]]} vs "
                             f"{counts[off[0]]})")
    cols = [c for c in table.columns if c.startswith("b")]
    short = [c for c in cols if len(table[c]) != K]
    if len(table) != K or short or not cols:
        raise AssertionError(f"{what}: the table has {len(table)} rows "
                             f"(columns of another length: {short[:4]}), "
                             f"expected {K}")
    nan = [c for c in cols if np.isnan(np.asarray(table[c], float)).any()]
    if nan:
        raise AssertionError(f"{what}: NaN in {len(nan)} spectral or GLCM "
                             f"columns of non-empty objects: {nan[:4]}")
    if proba is not None and (proba.shape[0] != K or not np.allclose(
            proba.sum(1), 1.0, atol=1e-5)):
        raise AssertionError(f"{what}: {proba.shape[0]} probability rows "
                             f"for {K} objects, or rows not adding up to 1")


def north_star_runs(run, image, what: str):
    """One path of phase 26: ``run`` cold, then warm with the card's peak
    memory (reset before each run), the kernels' launches and the CCL
    sweeps (the telemetry's counters), then a profiled warm run (each
    stage synced, with its peak memory). Logs the walls, K, both peaks,
    the sweeps and the host's peak RSS; returns (cold result,
    warm result, warm peak bytes, the warm run's launches, the warm run's
    probabilities or None)."""
    import resource

    import torch

    from obia_tpu_torch import telemetry
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cold = run(image, "cuda")
    cold_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    sweeps = telemetry.counters().get("ccl.sweeps", 0)
    warm = run(image, "cuda")
    launches = tbench.kernel_launches()
    sweeps = telemetry.counters().get("ccl.sweeps", 0) - sweeps
    peak = torch.cuda.max_memory_allocated()
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    H, W = image.img_data.shape[:2]
    log(f"{what}: {len(warm[0].table)} objects, first run {cold[2]:.3f} s, "
        f"warm {warm[2]:.3f} s ({H * W / 1e6 / warm[2]:.3f} MP/s);"
        f" peak device memory {cold_peak / 2 ** 30:.2f} GiB cold, "
        f"{peak / 2 ** 30:.2f} GiB warm; host peak RSS {rss:.2f} GiB; "
        f"launches {launches}; CCL sweeps {sweeps} ({card_line()})")
    profiled(run, image, f"{what}, profiled warm run")
    return cold[0], warm[0], peak, launches, warm[1]


def moment_blocks(image_t, labels, K: int) -> dict:
    """``objects.spectral``'s passes (float64 rows built and added
    ``stats.SUM_BLOCK`` pixels at a time) at a quarter of the block they
    run with, at it, at four times it and in one block of every pixel (the
    arithmetic before the blocking), in turns, forward then back: each
    size's best time (host clock, synced) and peak memory. Every size's
    moments agree with the one block's within rtol 1e-6 with the same NaN
    slots (the card's float64 atomics may order the sums otherwise).
    Returns {block: (best s, peak bytes)}."""
    import torch

    from obia_tpu_torch.ops import stats
    block = stats.SUM_BLOCK
    sizes = (block // 4, block, 4 * block, labels.numel())
    out, packed = {}, {}
    try:
        for size in sizes + sizes[::-1]:
            stats.SUM_BLOCK = size
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            _, packed[size] = stats.spectral_moments_packed(image_t, labels,
                                                            K)
            sec = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            best, top = out.get(size, (sec, peak))
            out[size] = (min(best, sec), max(top, peak))
    finally:
        stats.SUM_BLOCK = block
    whole = packed[sizes[-1]]
    log("  the moment passes by block size (" + "; ".join(
        f"{'one block' if b == sizes[-1] else b}"
        f"{' (as shipped)' if b == block else ''}: best "
        f"{1000 * t:.1f} ms, peak {m / 2 ** 30:.2f} GiB, moments equal to "
        f"one block's: {np.array_equal(packed[b], whole, equal_nan=True)}"
        for b, (t, m) in out.items()) + ")")
    for b in sizes:
        if not (np.array_equal(np.isnan(packed[b]), np.isnan(whole))
                and np.allclose(packed[b], whole, rtol=1e-6, atol=0,
                                equal_nan=True)):
            raise AssertionError(f"moments in blocks of {b} pixels differ "
                                 f"from one block's")
    return out


def north_star_slice(image, card: str) -> dict:
    """Phase 26, path 1: config 4 (``bench.run_config4``) on the north-star
    scene, its checks, and ``glcm_sums`` against its twin on band 0, timed.
    Returns the glcm_sums numbers for the kernels line."""
    import torch

    what = f"phase 26, path 1: config 4 at {NS_SIZE}^2 x {BANDS}"
    cold, s, peak, launches, proba = north_star_runs(run_slice, image, what)
    K = len(s.table)
    log(f"  K = {K}; the JAX package's {NS_JAX_OBJECTS} on this scene "
        f"(BASELINE.md, a TPU run): {100 * (K / NS_JAX_OBJECTS - 1):+.2f}%")
    labels = s.layer.labels_dev
    check_north_star(labels, K, pixel_counts(s.table.geometry,
                                             s.layer.transform),
                     s.table, proba, what)
    same = (np.array_equal(cold.layer.label_raster.values,
                           s.layer.label_raster.values)
            and np.array_equal(cold.layer.label_raster.lengths,
                               s.layer.label_raster.lengths))
    log(f"  cold and warm label rasters identical: {same}")
    check_spectral_runs(cold.table, s.table, same, what)
    if launches["glcm_sums"] < BANDS:
        raise AssertionError(f"{what}: {launches['glcm_sums']} glcm_sums "
                             f"launches, expected >= {BANDS}")
    del cold
    moment_blocks(image.device_tensor("cuda"), labels, K)
    err, ms, plain_ms, bound, _ = sums_times(glcm_inputs(
        image.device_tensor("cuda"), labels, K, 0), NS_SIZE, card)
    del labels, s
    torch.cuda.empty_cache()
    return {"ms_north_star": ms, "plain_ms_north_star": plain_ms,
            "bound_ms_north_star": bound, "max_abs_err_north_star": err,
            "launches_north_star": launches["glcm_sums"],
            "peak_gib_north_star": peak / 2 ** 30}


def north_star_mosaic(image, card: str) -> dict:
    """Phase 26, path 3: config 5's ``mosaic_pipeline`` on a 2 x 4 mesh of
    5000 x 2500 blocks on the card, on the north-star scene; its checks,
    sharded against single-device (phase 12's bars), and
    ``glcm_spanner_hist`` against its twin on band 0, timed. Returns the
    glcm_hist numbers for the kernels line and the run's glcm_sums
    launches."""
    import torch

    from obia_tpu_torch.ops import glcm_kernel
    from obia_tpu_torch.parallel import mesh as pmesh
    what = (f"phase 26, path 3: the mosaic at {NS_SIZE}^2 x {BANDS} on a "
            f"2 x 4 mesh")
    cold, r5, peak, launches, _ = north_star_runs(run_config5, image, what)
    K = len(r5.table)
    lay = r5.layer
    check_north_star(lay.labels_dev, K, pixel_counts(r5.table.geometry,
                                                     lay.transform),
                     r5.table, None, what)
    same = np.array_equal(cold.label_raster, r5.label_raster)
    log(f"  cold and warm label rasters identical: {same}")
    check_spectral_runs(cold.table, r5.table, same, what)
    if launches["glcm_sums"] < C5_SHARDS * BANDS \
            or launches["glcm_hist"] != BANDS:
        raise AssertionError(f"{what} missed a kernel: {launches} (glcm_hist"
                             f" one a band)")
    del cold
    sharded_vs_single(r5, image)
    img_sh = pmesh.shard_raster(lay.shards.mesh,
                                image.device_tensor("cuda"))[0]
    args = shard_calls(lay.shards.mesh, img_sh, lay.shards, K, 256, 0)[1]
    err = compare_hist(args, f"{NS_SIZE}^2 mosaic band 0")
    ms = time_ms(lambda: glcm_kernel.glcm_spanner_hist(*args, tables=False),
                 10, queued=True)
    plain_ms = time_ms(
        lambda: glcm_kernel.glcm_spanner_hist_reference(*args), 3)
    bound = hist_bound_ms(args)
    log(f"GLCM spanner histogram, one band at {NS_SIZE}^2 ({args[3].ids.numel()}"
        f" spanners, {args[3].pieces.shape[0]} pieces), as the main path "
        f"calls it: kernel {ms:.4f} ms, plain torch {plain_ms:.3f} ms, "
        f"bound {bound:.4f} ms ({card})")
    del args, img_sh, r5
    torch.cuda.empty_cache()
    return {"ms_north_star": ms, "plain_ms_north_star": plain_ms,
            "bound_ms_north_star": bound, "max_abs_err_north_star": err,
            "launches_north_star": launches["glcm_hist"],
            "sums_launches_north_star": launches["glcm_sums"],
            "peak_gib_north_star": peak / 2 ** 30}


def north_star_phase(card: str):
    """Phase 26: the north-star scene (config 4's 8 bands at 10000^2,
    100 MP) built once through paths 1 and 3, then path 2 (config 1 at
    10000^2 RGB) as one bench process. Returns (glcm_sums numbers,
    glcm_hist numbers, path 2's row)."""
    t0 = time.perf_counter()
    image = as_image(config4_scene(NS_SIZE))
    log(f"phase 26: config4_scene({NS_SIZE}) built in "
        f"{time.perf_counter() - t0:.1f} s")
    sums = north_star_slice(image, card)
    hist = north_star_mosaic(image, card)
    del image
    row = bench_row(card, 1, NS_SIZE, {"OBIA_BENCH_RUNS": "2"},
                    tag="phase 26, path 2")
    return sums, hist, row


# -- phase 27: the reference import paths, the new functions, detection ------

# the keys of tools/bench_detection.py's row
TOOL_DETECTION_KEYS = ("tile", "batch", "backbone", "train_step_s",
                       "train_step_first_s", "train_images_per_s", "loss",
                       "predict_s", "predict_first_s", "predict_mp_s",
                       "n_detections")
JOIN_POINTS = 300       # seeded points joined to (a)'s polygons
SURFACE_CROSS = 1024    # the corner of (a)'s raster that the CPU reruns


def alias_flow(path: str, out: str, device: str,
               n_segments: int = N_SEGMENTS):
    """README.md's headline flow through the ``obia_torch`` import paths,
    pandas- and sklearn-free: ``open_geotiff(path)``, SLIC
    (``n_segments``, compactness 10) with its features, ``classify`` of the
    table by the MLP route (the bench's seeded training rows and
    median-split target), ``write_geotiff(out)`` and the GeoTIFF read back.
    Returns (segments, classify result, the raster read back, seconds); the
    clock stops after the polygons are joined and the card synchronised."""
    import torch

    from obia_torch.classification.classify import classify
    from obia_torch.handlers.geotif import open_geotiff
    from obia_torch.segmentation.segment import segment
    t0 = time.perf_counter()
    s = segment(open_geotiff(path), method="slic", n_segments=n_segments,
                compactness=10, device=device)
    _, y, idx = training_table(s.table)
    res = classify(s.table, s.table.take(idx).with_columns(
        feature_class=y[idx]), method="mlp", hidden_layer_sizes=(64,),
        max_iter=60, random_state=0, device=device)
    res.write_geotiff(out)
    back = open_geotiff(out).img_data
    s.table.geometry
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return s, res, back, time.perf_counter() - t0


def check_alias_flow(s, res, back, direct, want_k, what: str) -> None:
    """Phase 27 (a)'s checks: K objects (``want_k``, unless None), the
    labels of ``direct`` (the same call through ``obia_tpu_torch``), no
    NaN in the table's spectral and GLCM columns (the point-cloud columns
    are NaN without a cloud), and the classified GeoTIFF ``back`` equal to
    the label-raster render."""
    K = len(s.table)
    rle, d = s.layer.label_raster, direct.layer.label_raster
    if want_k is not None and K != want_k:
        raise AssertionError(f"{what}: {K} objects, the bench's row "
                             f"{want_k}")
    if not (np.array_equal(rle.values, d.values)
            and np.array_equal(rle.lengths, d.lengths)):
        raise AssertionError(f"{what}: labels differ from a direct "
                             "obia_tpu_torch call's")
    cols = [c for c in s.table.columns if c[:1] == "b" and c[1:2].isdigit()]
    nan = [c for c in cols
           if not np.isfinite(np.asarray(s.table[c], np.float64)).all()]
    if nan or not cols:
        raise AssertionError(f"{what}: NaN in columns {nan}")
    want, n_classes = classified_render(np.asarray(rle), res.table)
    if back.shape[:2] != want.shape or not np.array_equal(back[:, :, 0],
                                                          want):
        raise AssertionError(f"{what}: the classified GeoTIFF "
                             f"{back.shape} differs from the render")
    log(f"  {what}: {K} objects, labels equal to obia_tpu_torch's, no NaN "
        f"in {len(cols)} spectral and GLCM columns, GeoTIFF {want.shape} "
        f"equal to the render ({n_classes} classes)")


def _same_tables(got: dict, want: dict, rtol: float, atol: float,
                 what: str) -> float:
    """Raise unless two {name: array} tables have the same names, the same
    NaN slots and values within ``rtol``/``atol`` (0/0: bitwise); returns
    the largest absolute difference."""
    if list(got) != list(want):
        raise AssertionError(f"{what}: names {list(got)} != {list(want)}")
    worst = 0.0
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if g.shape != w.shape or not np.array_equal(np.isnan(g),
                                                    np.isnan(w)):
            raise AssertionError(f"{what}: {k} shapes or NaN slots differ")
        ok = ~np.isnan(w)
        if not np.allclose(g[ok], w[ok], rtol=rtol, atol=atol):
            raise AssertionError(f"{what}: {k} beyond rtol {rtol}, atol "
                                 f"{atol}")
        if ok.any():
            worst = max(worst, float(np.abs(g[ok] - w[ok]).max()))
    return worst


def surface_check(image_t, labels, K: int, cross: int, what: str) -> None:
    """Phase 27 (b) on (a)'s image and labels where they lie:
    ``glcm_table`` and ``spectral_stats_table`` bitwise the packed paths'
    columns, and on the ``cross``^2 corner within test_torch_glcm.py's and
    test_torch_stats.py's bars (rtol 2e-4 / 1e-4, atol 1e-5) of the same
    corner on the CPU; ``polygonize_labels``' areas adding up to H * W."""
    from obia_tpu_torch.geometry.polygonize import polygonize_labels
    from obia_tpu_torch.ops import glcm as tglcm
    from obia_tpu_torch.ops import stats as tstats
    t0 = time.perf_counter()
    names, packed = tglcm.segment_glcm_props_packed(image_t, labels, K)
    _same_tables(tglcm.glcm_table(image_t, labels, K),
                 dict(zip(names, packed)), 0, 0, f"{what} glcm_table")
    names, packed = tstats.spectral_moments_packed(image_t, labels, K)
    _same_tables(tstats.spectral_stats_table(image_t, labels, K),
                 dict(zip(names, packed)), 0, 0,
                 f"{what} spectral_stats_table")
    img_c = image_t[:cross, :cross].contiguous()
    lab_c = labels[:cross, :cross].contiguous()
    dg = _same_tables(tglcm.glcm_table(img_c, lab_c, K),
                      tglcm.glcm_table(img_c.cpu(), lab_c.cpu(), K),
                      2e-4, 1e-5, f"{what} glcm_table vs the CPU")
    ds = _same_tables(tstats.spectral_stats_table(img_c, lab_c, K),
                      tstats.spectral_stats_table(img_c.cpu(), lab_c.cpu(),
                                                  K),
                      1e-4, 1e-5, f"{what} spectral_stats_table vs the CPU")
    polys = polygonize_labels(labels)
    H, W = labels.shape
    area = sum(p.area for plist in polys.values() for p in plist)
    if len(polys) != K or area != H * W:
        raise AssertionError(f"{what}: polygonize_labels gave {len(polys)} "
                             f"labels and {area} px of {K} and {H * W}")
    log(f"  {what}: glcm_table and spectral_stats_table bitwise the packed "
        f"paths; on the {cross}^2 corner, against the CPU, max|diff| "
        f"{dg:.3g} (GLCM) and {ds:.3g} (moments); polygonize_labels: {K} "
        f"labels, areas add up to {H} x {W}; "
        f"{time.perf_counter() - t0:.2f} s")


def join_check(geometry, transform, shape, n_points: int, seed: int,
               what: str) -> None:
    """Phase 27 (b)'s join: ``n_points`` seeded points inside the raster;
    ``contains`` of the polygons against them (the points fast path) gives
    the pairs of ``within`` of the points against the polygons (the general
    path) with the sides swapped, and every point lies in a polygon."""
    from obia_tpu_torch.geometry.geom import Point
    from obia_tpu_torch.vector.features import join_pairs
    rng = np.random.default_rng(seed)
    H, W = shape
    col, row = rng.uniform(0, W, n_points), rng.uniform(0, H, n_points)
    a, b, c, d, e, f = tuple(transform)[:6]
    pts = [Point(a * x + b * y + c, d * x + e * y + f)
           for x, y in zip(col, row)]
    t0 = time.perf_counter()
    contains = join_pairs(geometry, pts, "contains")
    t1 = time.perf_counter()
    within = join_pairs(pts, geometry, "within")
    t2 = time.perf_counter()
    if sorted(contains) != sorted((p, q) for q, p in within):
        raise AssertionError(f"{what}: contains(L, R) != within(R, L)")
    hits = np.bincount([q for _, q in contains], minlength=n_points)
    if (hits < 1).any():
        raise AssertionError(f"{what}: {int((hits < 1).sum())} points in "
                             "no polygon")
    log(f"  {what}: sjoin pairs, contains(polygons, points) == "
        f"within(points, polygons): {len(contains)} pairs of {len(geometry)}"
        f" polygons and {n_points} points; contains {1000 * (t1 - t0):.0f} "
        f"ms, within {1000 * (t2 - t1):.0f} ms")


def alias_phase(card: str, want_k, size: int = tbench.DEFAULT_SIZE,
                device: str = "cuda", n_segments: int = N_SEGMENTS,
                cross: int = SURFACE_CROSS, n_points: int = JOIN_POINTS,
                seed: int = 0) -> dict:
    """Phase 27 (a) and (b): config 1's scene at size^2 (phase 25's config-1
    row's scene and size) written as a GeoTIFF, the headline flow through
    ``obia_torch`` cold and warm with the launches counted around the warm
    run, its checks, then the new functions on its labels. Returns the
    warm run's launches."""
    import tempfile

    import torch

    import obia_tpu_torch.classification.classify as real_c
    import obia_tpu_torch.handlers.geotif as real_h
    import obia_tpu_torch.segmentation.segment as real_s
    from obia_torch.classification import classify as alias_c
    from obia_torch.handlers import geotif as alias_h
    from obia_torch.segmentation import segment as alias_s
    if not (alias_s.segment is real_s.segment
            and alias_c.classify is real_c.classify
            and alias_h.open_geotiff is real_h.open_geotiff):
        raise AssertionError("obia_torch re-exports copies, not the port's "
                             "objects")
    what = f"phase 27 (a), the headline through obia_torch at {size}^2 RGB"
    scene = build_scene(h=size, w=size)
    with tempfile.TemporaryDirectory() as tmp:
        path = write_scene(os.path.join(tmp, "scene.tif"), scene)
        walls = {}
        for run in ("cold", "warm"):
            reset_launches()
            s, res, back, walls[run] = alias_flow(
                path, os.path.join(tmp, f"classified_{run}.tif"), device,
                n_segments)
            launches = tbench.kernel_launches()
    image = as_image(scene)
    direct = real_s.segment(image, method="slic", n_segments=n_segments,
                            compactness=10, device=device)
    log(f"{what}: cold {walls['cold']:.3f} s, warm {walls['warm']:.3f} s "
        f"(open, segment, classify mlp, write and read the GeoTIFF); "
        f"launches {launches} ({card})")
    check_alias_flow(s, res, back, direct, want_k, what)
    if torch.device(device).type == "cuda" and launches["glcm_sums"] < 3:
        raise AssertionError(f"{what}: glcm_sums launched "
                             f"{launches['glcm_sums']} times")
    labels = s.layer.labels_dev
    surface_check(image.device_tensor(device), labels, len(s.table),
                  min(cross, size), "phase 27 (b), the new functions")
    join_check(s.table.geometry, s.layer.transform, tuple(labels.shape),
               n_points, seed, "phase 27 (b)")
    return launches


def check_detection_row(row: dict, card: str) -> dict:
    """Phase 27 (c)'s row: tools/bench_detection.py's keys with ``device``
    (this card) and ``launches``, a finite loss and positive times; returns
    the row's fields."""
    got = row["detection_bench"]
    want = set(TOOL_DETECTION_KEYS) | {"device", "launches"}
    if set(got) != want:
        raise AssertionError(f"detection row keys {sorted(got)} != "
                             f"{sorted(want)}")
    if got["device"] != card or not math.isfinite(got["loss"]):
        raise AssertionError(f"detection row: device {got['device']}, "
                             f"loss {got['loss']}")
    if not (got["train_step_s"] > 0 and got["predict_s"] > 0):
        raise AssertionError(f"detection row times: {got}")
    return got


def detection_bench_phase(card: str, size: int = tbench.DETECTION_SIZE
                          ) -> dict:
    """Phase 27 (c): ``python -m obia_tpu_torch.bench size --config
    detection`` (batch 2) in a new process; its row checked and logged."""
    cmd = [sys.executable, "-m", "obia_tpu_torch.bench", str(size),
           "--config", "detection"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=400)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(cmd[1:])} exited "
                             f"{proc.returncode}: {proc.stderr[-3000:]}")
    got = check_detection_row(
        json.loads(proc.stdout.strip().splitlines()[-1]), card)
    log(f"phase 27 (c), {' '.join(cmd[2:])}: tile {got['tile']}, batch "
        f"{got['batch']}, train step best {got['train_step_s']:.4f} s "
        f"(first {got['train_step_first_s']:.3f} s, "
        f"{got['train_images_per_s']:.2f} images/s), loss {got['loss']:.4f}"
        f"; predict best {got['predict_s']:.4f} s (first "
        f"{got['predict_first_s']:.3f} s, {got['predict_mp_s']:.3f} MP/s), "
        f"{got['n_detections']} detections; process {wall:.1f} s "
        f"({got['device']})")
    return got


def main() -> None:
    import argparse

    import torch
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the canopy phase's scene")
    parser.add_argument("--two-rank-worker", nargs=7,
                        metavar=("RANK", "PORT", "DIR", "DEVICE", "HEIGHT",
                                 "WIDTH", "STEPS"),
                        help="run one rank of phase 24 and exit")
    args = parser.parse_args()
    seed = args.seed
    if args.two_rank_worker:
        sys.path.insert(0, ROOT)
        rank, port, out_dir, device, size, width, steps = \
            args.two_rank_worker
        two_rank_worker(int(rank), int(port), out_dir, device, int(size),
                        int(width), int(steps))
        return
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False)")
    t_start = time.perf_counter()
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
    reset_launches()
    s, proba, warm = run_slice(image, "cuda")
    launches = tbench.kernel_launches()["glcm_sums"]
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
    e, ms, plain_ms, bound, bound_l = sums_times(glcm_inputs(
        image.device_tensor("cuda"), labels, n_obj, 0), SIZE, card)
    err = max(err, e)

    # -- 5. classify() on the config-4 table ------------------------------
    classify_phase(s.table)

    # -- 6. cross-check against the CPU plain path ------------------------
    cross_check(run_slice, config4_scene(CROSS_SIZE), f"config 4 "
                f"{CROSS_SIZE}^2")
    sigma_check(run_slice, config4_scene(CROSS_SIZE), [0, 3, 6],
                f"config 4 {CROSS_SIZE}^2")

    # -- 7. quickshift kernels vs twins, edge cases -----------------------
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

    # -- 8. the config-2 slice at its own size ----------------------------
    image2 = as_image(build_scene(h=QS_SIZE, w=QS_SIZE))
    mp2 = QS_SIZE * QS_SIZE / 1e6
    s2_cold, _, cold2 = profiled(run_config2, image2, "cold run")
    reset_launches()
    s2, proba2, warm2 = run_config2(image2, "cuda")
    counted = tbench.kernel_launches()
    qs_launches = {k: counted[k] for k in ("qs_density", "qs_parent")}
    glcm2 = counted["glcm_sums"]
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
    e, g_ms, g_plain, bound2, bound2_l = sums_times(glcm_inputs(
        image2.device_tensor("cuda"), s2.layer.labels_dev, n2, 0), QS_SIZE,
        card)
    err = max(err, e)

    # -- 9. config-2 cross-check against the CPU plain path ---------------
    cross_check(run_config2, build_scene(h=QS_CROSS_SIZE, w=QS_CROSS_SIZE),
                f"config 2 {QS_CROSS_SIZE}^2")
    sigma_check(run_config2, build_scene(h=QS_CROSS_SIZE, w=QS_CROSS_SIZE),
                [0, 1, 2], f"config 2 {QS_CROSS_SIZE}^2")

    # -- 10. the seam-spanner histogram kernel vs its twin, edge cases ------
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

    # -- 11. config 5 at its real size on a 2 x 4 mesh on the card ---------
    from obia_tpu_torch.parallel.sharded import count_shard_spanning
    image5 = as_image(build_scene(h=C5_SIZE, w=C5_SIZE))
    mp5 = C5_SIZE * C5_SIZE / 1e6
    r5_cold, _, cold5 = run_config5(image5, "cuda")
    reset_launches()
    r5, _, warm5 = run_config5(image5, "cuda")
    counted = tbench.kernel_launches()
    sums5, hist5 = counted["glcm_sums"], counted["glcm_hist"]
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
    h = hist_times(lab5, img5_sh, n5, hist5_args)
    kernel_split(lambda: glcm_kernel.glcm_spanner_hist(*hist5_args,
                                                       tables=False),
                 "GLCM spanner histogram kernel")
    for i, a in enumerate(sums5_calls):
        err = max(err, compare_kernel(a, f"config 5 shard {i} band 0"))
    s5_ms = time_ms(lambda: [glcm_kernel.glcm_sums(*a)
                             for a in sums5_calls], 10)
    s5_plain = time_ms(lambda: [glcm_kernel.glcm_sums_reference(*a)
                                for a in sums5_calls], 3)
    bound5 = sums_bound_ms(sums5_calls)
    bound5_l = sums_bound_ms(sums5_calls, True)
    log(f"GLCM sums, one band of config 5 ({len(sums5_calls)} launches, "
        f"K={n5}): kernel {s5_ms:.3f} ms, plain torch {s5_plain:.3f} ms, "
        f"bound {bound5:.4f} ms (band in place: {bound5_l:.4f} ms) "
        f"({card})")
    kernel_split(lambda: [glcm_kernel.glcm_sums(*a) for a in sums5_calls],
                 "GLCM sums kernels, 8 launches")

    # -- 12. sharded vs single-device on the card --------------------------
    sharded_vs_single(r5, image5)
    del r5, r5_cold, hist5_args, sums5_calls, img5_sh

    # -- 13. config-5 cross-check against the CPU plain path --------------
    cross_check(run_config5, build_scene(h=C5_CROSS_SIZE, w=C5_CROSS_SIZE),
                f"config 5 {C5_CROSS_SIZE}^2")

    # -- 14-15. config 3, tiled segmentation, then its card-vs-CPU check -----
    import shutil
    import tempfile
    root = tempfile.mkdtemp(prefix="obia_config3_")
    try:
        config3_phase(C3_SIZE, root, card)
        n3 = config3_cross_check(C3_CROSS_SIZE, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # -- 16-17. the canopy seed and cost-surface workflow, then card vs CPU --
    root = tempfile.mkdtemp(prefix="obia_canopy_")
    try:
        canopy_phase(CANOPY_SIZE, root, seed, card)
        canopy_cross_check(CANOPY_CROSS_SIZE, root, seed)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # -- 18-19. create_objects' full surface ---------------------------------
    rasterised = objects_phase(image, s, card, seed)
    objects_small_phase(seed)

    # -- 20-21. detection: train and predict at full width, then card checks --
    detection_phases(seed, card)

    # -- 22-24. the fused model, its sharded step, two ranks on the card ------
    fused_phase(card)
    sharded_train_phase(card)
    two_rank_check(card)

    # -- 25. the bench command, one configuration a process -----------------
    bench_rows = bench_phase(card, {4: n_obj, 2: n2, 5: n5, 3: n3})

    # -- 26. the north-star scene: 10000^2 x 8 bands -------------------------
    del image, s, image5, image2
    ns_sums, ns_hist, ns_row = north_star_phase(card)

    # -- 27. the reference import paths, the new functions, detection --------
    t27 = time.perf_counter()
    alias_launches = alias_phase(card, bench_rows[1]["n_objects"])
    detection_bench_phase(card)
    log(f"phase 27: {time.perf_counter() - t27:.1f} s")

    log(f"all phases: {time.perf_counter() - t_start:.1f} s")
    log(card_line())
    qs_r, qs_md = 15, QS_KW["max_dist"]  # as qs_time measures
    qd_bound, qp_bound = qs_bound(x2, qs_r), qs_bound(x2, qs_r, qs_md)
    log(f"quickshift bounds at {QS_SIZE}^2: density {qd_bound}, parent "
        f"{qp_bound}")
    kernels = [
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
         "launches_config5": sums5, "launches_rasterised": rasterised,
         **ns_sums},
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
         "bound_by": "bytes", "library_ms": None, **h, **ns_hist}]
    for k in kernels:  # phase 25's launches, by config, and phase 26's
        k["launches_bench"] = {str(c): row["launches"][k["name"]]
                               for c, row in bench_rows.items()}
        k["launches_bench_north_star"] = ns_row["launches"][k["name"]]
        k["launches_phase27"] = alias_launches[k["name"]]
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
