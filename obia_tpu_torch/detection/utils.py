"""Detection helpers (the port's counterpart of
``obia_tpu/detection/utils.py``): ``get_transforms`` (reference
utils.py:17-47, the albumentations flip/rot90 pipelines as numpy with the
image=/bboxes=/labels= calling convention and the same ``default_rng``
draws as the JAX package), ``collate_fn`` (:50-60), ``calculate_iou``
(:63-81) and ``visualize_predictions`` (:84-125; matplotlib, imported
inside it).
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


class _NumpyBoxTransforms:
    """Random rot90 + flips applied to (H, W, C) images and pascal_voc
    bboxes, mirroring the reference's albumentations pipeline."""

    def __init__(self, train: bool = True, p_rot: float = 0.5,
                 p_flip: float = 0.5, seed: int = 0):
        self.train = train
        self.p_rot = p_rot
        self.p_flip = p_flip
        self.rng = np.random.default_rng(seed)

    def __call__(self, image, bboxes, labels) -> Dict:
        img = np.asarray(image)
        boxes = np.asarray(bboxes, np.float32).reshape(-1, 4)
        labels = list(labels)
        if self.train:
            if self.rng.random() < self.p_rot:
                k = int(self.rng.integers(1, 4))
                for _ in range(k):
                    img = np.rot90(img)
                    # rot90 CCW: (x, y) -> (y, w_prev - x)
                    x1, y1, x2, y2 = boxes.T.copy()
                    boxes = np.stack([y1, img.shape[0] - x2,
                                      y2, img.shape[0] - x1], axis=1)
            h, w = img.shape[:2]
            if self.rng.random() < self.p_flip:
                if self.rng.random() < 0.5:
                    img = img[:, ::-1]
                    x1 = w - boxes[:, 2]
                    x2 = w - boxes[:, 0]
                    boxes[:, 0], boxes[:, 2] = x1, x2
                else:
                    img = img[::-1, :]
                    y1 = h - boxes[:, 3]
                    y2 = h - boxes[:, 1]
                    boxes[:, 1], boxes[:, 3] = y1, y2
        return {"image": np.ascontiguousarray(img),
                "bboxes": boxes.tolist(), "labels": labels}


def get_transforms(train: bool = True):
    """Flip/rot90 train transforms; identity for eval (reference
    utils.py:17-47)."""
    return _NumpyBoxTransforms(train=train)


def collate_fn(batch):
    """Lists of images and targets (reference utils.py:50-60)."""
    images, targets = [], []
    for img, tgt in batch:
        images.append(img)
        targets.append(tgt)
    return images, targets


def calculate_iou(box1: Sequence[float], box2: Sequence[float]) -> float:
    """IoU of two pascal_voc boxes (reference utils.py:63-81)."""
    x1 = max(box1[0], box2[0])
    y1 = max(box1[1], box2[1])
    x2 = min(box1[2], box2[2])
    y2 = min(box1[3], box2[3])
    inter = max(0.0, x2 - x1) * max(0.0, y2 - y1)
    a1 = max(0.0, box1[2] - box1[0]) * max(0.0, box1[3] - box1[1])
    a2 = max(0.0, box2[2] - box2[0]) * max(0.0, box2[3] - box2[1])
    union = a1 + a2 - inter
    return inter / union if union > 0 else 0.0


def visualize_predictions(image, boxes, scores=None, labels=None,
                          score_threshold: float = 0.0, ax=None,
                          color: str = "red"):
    """Draw detection boxes (+ scores) on an image (reference
    utils.py:84-125)."""
    # the process-wide matplotlib backend is left as it is
    import matplotlib.pyplot as plt
    import matplotlib.patches as patches

    img = np.asarray(image)
    if img.ndim == 3 and img.shape[0] <= 16 and img.shape[0] < img.shape[2]:
        img = np.transpose(img, (1, 2, 0))  # CHW -> HWC
    if img.ndim == 3 and img.shape[2] > 3:
        img = img[:, :, :3]
    if ax is None:
        _, ax = plt.subplots(1, figsize=(10, 10))
    if img.dtype != np.uint8:
        # rescale instead of truncating: a [0, 1] float image would
        # floor to all-zeros (black canvas) under a bare astype
        lo, hi = float(img.min()), float(img.max())
        img = (np.zeros_like(img, np.uint8) if hi <= lo else
               (255.0 * (img.astype(np.float64) - lo)
                / (hi - lo)).astype(np.uint8))
    ax.imshow(img)
    for i, box in enumerate(np.asarray(boxes).reshape(-1, 4)):
        s = None if scores is None else float(np.asarray(scores).ravel()[i])
        if s is not None and s < score_threshold:
            continue
        x1, y1, x2, y2 = box
        ax.add_patch(patches.Rectangle((x1, y1), x2 - x1, y2 - y1,
                                       linewidth=1.5, edgecolor=color,
                                       facecolor="none"))
        txt = []
        if labels is not None:
            txt.append(str(np.asarray(labels).ravel()[i]))
        if s is not None:
            txt.append(f"{s:.2f}")
        if txt:
            ax.text(x1, max(y1 - 3, 0), " ".join(txt), color=color,
                    fontsize=8)
    ax.axis("off")
    return ax
