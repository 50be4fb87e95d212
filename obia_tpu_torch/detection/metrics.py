"""Detection evaluation metrics (the port's counterpart of
``obia_tpu/detection/metrics.py``): average precision at an IoU threshold
(Pascal-VOC style, all-point interpolation) over a dataset of predictions
against ground truth. The reference training loop has no evaluation
(reference detection/train.py:11-50); the JAX package added this one.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def _pairwise_iou_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * \
        np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * \
        np.clip(b[:, 3] - b[:, 1], 0, None)
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / np.maximum(union, 1e-9)


def average_precision(predictions: Sequence[Dict],
                      ground_truths: Sequence[Dict],
                      iou_threshold: float = 0.5) -> float:
    """AP@iou over a dataset.

    Each prediction dict: {"boxes" (N,4), "scores" (N,)} and optionally
    "labels" (N,); each ground truth: {"boxes" (M,4)} and optionally
    "labels" (M,). Lists must be index-aligned per image. When BOTH
    sides carry labels, matching is class-aware — a wrong-class
    prediction overlapping another class's object is a false positive,
    not a hit.
    """
    records: List[Tuple[float, bool]] = []  # (score, is_tp)
    n_gt = 0
    for pred, gt in zip(predictions, ground_truths):
        pb = np.asarray(pred.get("boxes", np.zeros((0, 4)))).reshape(-1, 4)
        ps = np.asarray(pred.get("scores", np.ones(len(pb)))).reshape(-1)
        gb = np.asarray(gt.get("boxes", np.zeros((0, 4)))).reshape(-1, 4)
        pl = pred.get("labels")
        gl = gt.get("labels")
        n_gt += len(gb)
        if len(pb) == 0:
            continue
        order = np.argsort(-ps)
        pb, ps = pb[order], ps[order]
        if pl is not None:
            pl = np.asarray(pl).reshape(-1)[order]
        matched = np.zeros(len(gb), bool)
        if len(gb):
            iou = _pairwise_iou_np(pb, gb)
            if pl is not None and gl is not None:
                gl = np.asarray(gl).reshape(-1)
                iou = np.where(pl[:, None] == gl[None, :], iou, -1.0)
        for i in range(len(pb)):
            tp = False
            if len(gb):
                j = int(np.argmax(np.where(matched, -1.0, iou[i])))
                if not matched[j] and iou[i, j] >= iou_threshold:
                    matched[j] = True
                    tp = True
            records.append((float(ps[i]), tp))
    if n_gt == 0 or not records:
        return 0.0
    records.sort(key=lambda r: -r[0])
    tps = np.cumsum([r[1] for r in records])
    fps = np.cumsum([not r[1] for r in records])
    recall = tps / n_gt
    precision = tps / np.maximum(tps + fps, 1)
    # all-point interpolation
    mrec = np.concatenate([[0.0], recall, [recall[-1]]])
    mpre = np.concatenate([[1.0], precision, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def evaluate_model(model, dataset, score_threshold: float = 0.05,
                   iou_threshold: float = 0.5,
                   nms_threshold: float = 0.5) -> Dict[str, float]:
    """Run the model over a dataset on its device and report AP and
    counts. Inference goes through :func:`predict.infer_image_array`, the
    one pipeline (forward, decode, per-class NMS) ``predict`` also uses."""
    from .predict import infer_image_array

    preds, gts = [], []
    for i in range(len(dataset)):
        img, tgt = dataset[i]
        hwc = np.transpose(np.asarray(img), (1, 2, 0))
        out = infer_image_array(model, hwc, score_threshold, nms_threshold)
        preds.append(out)
        gt = {"boxes": tgt["boxes"]}
        if "labels" in tgt:
            gt["labels"] = tgt["labels"]
        gts.append(gt)
    ap = average_precision(preds, gts, iou_threshold)
    return {"AP": ap,
            "n_images": len(dataset),
            "n_predictions": int(sum(len(p["boxes"]) for p in preds)),
            "n_ground_truth": int(sum(len(g["boxes"]) for g in gts))}
