"""Anchor generation, box encoding and IoU matching for RetinaNet (the
port's copy of ``obia_tpu/detection/anchors.py``).

torchvision's RetinaNet defaults, as the reference inherits them: per-level
base sizes 32..512 with scales {2^0, 2^(1/3), 2^(2/3)} and aspect ratios
{0.5, 1, 2}; IoU fg/bg thresholds 0.5/0.4; box deltas (dx, dy, dw, dh)
normalised by anchor size. ``anchors_for_shape`` and ``nms_numpy`` are numpy
on the host, as in JAX; the rest takes tensors and follows their device,
with JAX's operation order so that IoU and matching are bitwise JAX's on the
same inputs.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

SCALES = (1.0, 2 ** (1 / 3), 2 ** (2 / 3))
RATIOS = (0.5, 1.0, 2.0)
NUM_ANCHORS = len(SCALES) * len(RATIOS)
LEVEL_STRIDES = (8, 16, 32, 64, 128)
LEVEL_SIZES = (32, 64, 128, 256, 512)


def anchors_for_shape(image_hw: Tuple[int, int]) -> np.ndarray:
    """All anchors (N, 4) xyxy for an image of shape (H, W), ordered by
    level, then (y, x) cell, then anchor."""
    H, W = image_hw
    all_anchors = []
    for stride, size in zip(LEVEL_STRIDES, LEVEL_SIZES):
        fh = (H + stride - 1) // stride
        fw = (W + stride - 1) // stride
        shifts_x = (np.arange(fw) + 0.5) * stride
        shifts_y = (np.arange(fh) + 0.5) * stride
        cx, cy = np.meshgrid(shifts_x, shifts_y)
        base = []
        for scale in SCALES:
            for ratio in RATIOS:
                a = size * scale
                w = a * np.sqrt(1.0 / ratio)
                h = a * np.sqrt(ratio)
                base.append((w, h))
        base = np.asarray(base)  # (A, 2)
        cxy = np.stack([cx, cy], axis=-1).reshape(-1, 1, 2)  # (fh*fw, 1, 2)
        wh = base.reshape(1, -1, 2)
        mins = cxy - wh / 2
        maxs = cxy + wh / 2
        anchors = np.concatenate([mins, maxs], axis=-1).reshape(-1, 4)
        all_anchors.append(anchors)
    return np.concatenate(all_anchors, axis=0).astype(np.float32)


def encode_boxes(anchors: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """gt boxes -> (dx, dy, dw, dh) deltas relative to anchors (both xyxy)."""
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    ax = anchors[:, 0] + aw / 2
    ay = anchors[:, 1] + ah / 2
    bw = torch.clamp(boxes[:, 2] - boxes[:, 0], min=1e-6)
    bh = torch.clamp(boxes[:, 3] - boxes[:, 1], min=1e-6)
    bx = boxes[:, 0] + bw / 2
    by = boxes[:, 1] + bh / 2
    return torch.stack([(bx - ax) / aw, (by - ay) / ah,
                        torch.log(bw / aw), torch.log(bh / ah)], dim=1)


def decode_boxes(anchors: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    ax = anchors[:, 0] + aw / 2
    ay = anchors[:, 1] + ah / 2
    bx = deltas[:, 0] * aw + ax
    by = deltas[:, 1] * ah + ay
    bw = torch.exp(torch.clamp(deltas[:, 2], -10, 6)) * aw
    bh = torch.exp(torch.clamp(deltas[:, 3], -10, 6)) * ah
    return torch.stack([bx - bw / 2, by - bh / 2,
                        bx + bw / 2, by + bh / 2], dim=1)


def pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, M) IoU between two xyxy box sets."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = torch.clamp((a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1]), min=0)
    area_b = torch.clamp((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]), min=0)
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def match_anchors(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                  gt_valid: Optional[torch.Tensor] = None,
                  fg_thresh: float = 0.5, bg_thresh: float = 0.4):
    """Per anchor: (matched_gt_index, label) with label 1 = fg, 0 = bg,
    -1 = ignore. ``gt_valid`` masks the real rows of ``gt_boxes`` (all of
    them when None); with no valid row every anchor is background, matched
    to row 0."""
    n, g = anchors.shape[0], gt_boxes.shape[0]
    if g == 0:
        zeros = torch.zeros(n, dtype=torch.int64, device=anchors.device)
        return zeros, zeros.clone()
    if gt_valid is None:
        gt_valid = torch.ones(g, dtype=torch.bool, device=gt_boxes.device)
    iou = pairwise_iou(anchors, gt_boxes)
    iou = torch.where(gt_valid[None, :], iou, -1.0)
    best_iou, _ = iou.max(dim=1)
    best_gt = iou.argmax(dim=1)  # the first maximum, as jnp.argmax
    label = torch.where(best_iou >= fg_thresh, 1,
                        torch.where(best_iou < bg_thresh, 0, -1))
    # torchvision Matcher(allow_low_quality_matches=True): every gt's
    # best-overlap anchor(s) are forced positive even below fg_thresh
    best_anchor_iou, _ = iou.max(dim=0)  # (G,)
    force = ((iou == best_anchor_iou[None, :]) & gt_valid[None, :]
             & (best_anchor_iou[None, :] > 0))
    forced_any = force.any(dim=1)
    # torch has no argmax over bool: the first True of each row
    best_gt = torch.where(forced_any, force.to(torch.uint8).argmax(dim=1),
                          best_gt)
    label = torch.where(forced_any, 1, label)
    label = torch.where(gt_valid.any(), label, 0)
    return best_gt, label


def nms_numpy(boxes: np.ndarray, scores: np.ndarray,
              iou_threshold: float = 0.5, max_out: int = 300) -> np.ndarray:
    """Greedy host-side NMS; returns kept indices (at most ``max_out``).

    The JAX package's greedy loop (``argsort(-scores)``, each kept box
    suppressing every box with IoU > threshold), with each kept box's IoU
    taken only over the boxes that can meet it (:class:`_Neighbours`). A
    box that cannot meet it has no intersection, so its IoU is 0 and, for a
    threshold >= 0, it is not suppressed; every IoU taken is the same
    float64 arithmetic, element for element. The kept list is therefore
    the reference's, while a kept box costs its neighbourhood instead of
    every box (a 4096^2 raster passes millions of anchors)."""
    order = np.argsort(-scores)
    n = len(boxes)
    keep = []
    suppressed = np.zeros(n, bool)
    areas = np.clip(boxes[:, 2] - boxes[:, 0], 0, None) * \
        np.clip(boxes[:, 3] - boxes[:, 1], 0, None)
    near = _Neighbours(boxes) if n and iou_threshold >= 0 else None
    step = 4096
    for s in range(0, n, step):
        block = order[s:s + step]
        for i in block[~suppressed[block]]:
            if suppressed[i]:
                continue
            keep.append(i)
            if len(keep) >= max_out:
                return np.asarray(keep, np.int64)
            cand = near(i) if near is not None else slice(None)
            lt = np.maximum(boxes[i, :2], boxes[cand, :2])
            rb = np.minimum(boxes[i, 2:], boxes[cand, 2:])
            wh = np.clip(rb - lt, 0, None)
            inter = wh[:, 0] * wh[:, 1]
            iou = inter / np.maximum(areas[i] + areas[cand] - inter, 1e-9)
            suppressed[cand] |= iou > iou_threshold
            suppressed[i] = True
    return np.asarray(keep, np.int64)


class _Neighbours:
    """The boxes that can intersect box i: a superset of those whose
    extent overlaps it on both axes. Finite boxes are grouped by the
    power of two of their larger side; in each group, sorted by x1, the
    boxes with x1 in [x1_i - widest, x2_i] are the only ones whose x-extent
    can reach box i, and of those the ones with y1 in [y1_i - tallest,
    y2_i]. The bounds carry a margin (1 px and 1e-9 relative), so float
    rounding never drops a box; boxes with a non-finite coordinate are
    always included."""

    def __init__(self, boxes: np.ndarray):
        self.boxes = boxes
        b = np.asarray(boxes, np.float64)
        finite = np.isfinite(b).all(axis=1)
        self.wild = np.flatnonzero(~finite)
        size = np.maximum(b[:, 2] - b[:, 0], b[:, 3] - b[:, 1])
        group = np.zeros(len(b), np.int64)
        group[finite] = np.ceil(np.log2(np.maximum(size[finite], 1.0)))
        self.groups = []
        for g in np.unique(group[finite]):
            idx = np.flatnonzero(finite & (group == g))
            idx = idx[np.argsort(b[idx, 0], kind="stable")]
            w = float(np.max(b[idx, 2] - b[idx, 0]))
            h = float(np.max(b[idx, 3] - b[idx, 1]))
            self.groups.append((idx, b[idx, 0], b[idx, 1],
                                max(w, 0.0) * (1 + 1e-9) + 1.0,
                                max(h, 0.0) * (1 + 1e-9) + 1.0))

    def __call__(self, i) -> np.ndarray:
        x1, y1, x2, y2 = (float(v) for v in self.boxes[i])
        parts = [self.wild]
        for idx, gx1, gy1, reach_x, reach_y in self.groups:
            lo = np.searchsorted(gx1, x1 - reach_x - 1e-9 * abs(x1), "left")
            hi = np.searchsorted(gx1, x2 + 1e-9 * abs(x2) + 1.0, "right")
            if hi <= lo:
                continue
            y = gy1[lo:hi]
            m = (y >= y1 - reach_y - 1e-9 * abs(y1)) & \
                (y <= y2 + 1e-9 * abs(y2) + 1.0)
            parts.append(idx[lo:hi][m])
        return np.concatenate(parts)
