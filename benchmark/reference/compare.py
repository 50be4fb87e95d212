"""The comparison that decides ``correct``.

For each checked scene the reference works out, from the scene and the
seeds the benchmark handed to both sides, its own labels, and, from the
program's labels, its own features and class probabilities (the features
and the classifier follow the program's partition, so that their rows
line up; the partition itself is judged against the reference's own).
The stand-in forest is built and run on the reference's own features. The
MLP is fitted on the program's feature table: its fit turns a last-bit
difference in one feature into a different model (float32 and float64
fits of one table differ by 0.01-0.29 in the mean), so its stage is
checked from the program's own rows, and those rows by ``feature_gap``.
The numbers, each held to a limit where its cell names one:

- ``label_mismatch``: the share of pixels outside the best-matching
  segment, the larger of the two directions (program to reference and
  back), so that a split or a merge counts either way;
- ``polygon_faults``: objects whose polygon's area, boundary length or
  bounding box differs from its label's, or that are missing or in excess
  (exact: limit 0);
- ``feature_gap``: the widest gap of a feature, |program - reference| over
  the larger of |reference| and the mean |reference| of its column (the
  median is 0 in a column such as the skewness of many small objects); a
  NaN on one side only is an infinite gap;
- ``proba_gap``: the widest gap of a class probability;
- ``proba_mean_gap``: the mean over the objects of their widest gap.

A cell's limits name the numbers it is held to.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import Precision
from .classify import classify
from .features import features
from .polygons import polygon_faults
from .segment import segment

NUMBERS = ("label_mismatch", "polygon_faults", "feature_gap", "proba_gap",
           "proba_mean_gap")


def partition_mismatch(a: torch.Tensor, b: torch.Tensor) -> float:
    """Share of pixels outside the best-matching segment, worst way."""
    a = a.reshape(-1).long()
    b = b.reshape(-1).long()
    ka, kb = int(a.max()) + 1, int(b.max()) + 1
    key, cnt = torch.unique(a * kb + b, return_counts=True)
    worst = 0.0
    for owner, k in ((key // kb, ka), (key % kb, kb)):
        best = torch.zeros(k, dtype=torch.int64, device=a.device)
        best.scatter_reduce_(0, owner, cnt, "amax")
        worst = max(worst, 1.0 - float(best.sum()) / a.numel())
    return worst


def feature_gap(program: dict, reference: dict) -> float:
    """Widest relative gap over the reference's columns."""
    worst = 0.0
    for name, ref in reference.items():
        r = np.asarray(ref, np.float64)
        q = np.asarray(program[name], np.float64)
        nan_r, nan_q = np.isnan(r), np.isnan(q)
        if (nan_r != nan_q).any():
            return math.inf
        ok = ~nan_r
        if not ok.any():
            continue
        scale = np.maximum(np.abs(r[ok]), np.mean(np.abs(r[ok])))
        gap = np.abs(q[ok] - r[ok])
        rel = np.where(scale > 0, gap / np.where(scale > 0, scale, 1.0),
                       np.where(gap > 0, math.inf, 0.0))
        worst = max(worst, float(rel.max()))
    return worst


def as_float32(columns: dict) -> dict:
    """The feature columns as the configuration serves them: float32."""
    return {c: torch.as_tensor(v).to(torch.float32).cpu().numpy()
            for c, v in columns.items()}


def judge(scene: torch.Tensor, out: dict, config: dict, seeds: dict,
          device) -> dict:
    """The four numbers of one scene's outputs ``out``: ``labels`` (H, W),
    ``K``, ``columns`` {name: (K,)}, ``proba`` (K, C) and ``polygons``
    (the rings of each object, or None for a control, which makes none)."""
    labels = torch.as_tensor(np.asarray(out["labels"]), device=device)
    K = int(out["K"])
    nums = {}
    ref_labels = segment(scene, config["segment"])
    nums["label_mismatch"] = partition_mismatch(labels, ref_labels)
    del ref_labels
    ref = as_float32(features(scene, labels, K, config))
    nums["feature_gap"] = feature_gap(out["columns"], ref)
    clf = config["classifier"]
    rows = out["columns"] if clf["kind"] == "mlp" else ref
    proba = classify(rows, seeds, clf, device)
    gap = np.abs(np.asarray(out["proba"], np.float64) - proba).max(axis=1)
    nums["proba_gap"] = float(gap.max())
    nums["proba_mean_gap"] = float(gap.mean())
    if out.get("polygons") is not None:
        nums["polygon_faults"] = polygon_faults(out["polygons"], labels, K,
                                                scene.shape[0])
    return nums


def control(scene: torch.Tensor, config: dict, seeds: dict, device,
            p: Precision) -> dict:
    """The reference in ``p`` put in the program's place: its outputs of
    the scene, in :func:`judge`'s form (no polygons)."""
    labels = segment(scene, config["segment"], p)
    K = int(labels.max()) + 1
    cols = as_float32(features(scene, labels, K, config, p))
    return {"labels": labels.cpu().numpy(), "K": K, "columns": cols,
            "proba": classify(cols, seeds, config["classifier"], device, p),
            "polygons": None}


def verdict(numbers: dict, limits: dict) -> bool:
    """Whether every number is within its limit (a missing number is not:
    each that the limits name must have been read)."""
    return all(name in numbers and numbers[name] <= lim
               for name, lim in limits.items())
