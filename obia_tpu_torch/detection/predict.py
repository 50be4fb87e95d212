"""Whole-raster detection inference (the port's counterpart of
``obia_tpu/detection/predict.py``).

``predict(model, image_path, device, score_threshold)`` (reference
predict.py:14-57) reads the full N-band raster, scales it globally to uint8
by its min and max, runs one forward pass, filters by score, and returns
{"boxes", "scores", "labels"} numpy arrays. Decoding and the score filter
run on the model's device; NMS runs per class on the host, in numpy on
float64 coordinates, as in the JAX package, so the kept set is the same
given the same scores (torchvision ``batched_nms`` semantics: boxes of
different labels never suppress each other).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .. import telemetry
from ..io.tiff import TiffReader
from .anchors import decode_boxes, nms_numpy
from .models import DetectionModel


def _tensor(array, device) -> torch.Tensor:
    """A host array as a tensor on ``device``. uint16 and uint32 go up as
    their signed views and are widened there (torch's unsigned types above
    8 bits do little arithmetic), so the host makes no copy."""
    if isinstance(array, torch.Tensor):
        return array.to(device)
    a = np.asarray(array)
    if a.dtype == np.uint16:
        t = torch.as_tensor(a.view(np.int16)).to(device)
        return t.to(torch.int32) & 0xFFFF
    if a.dtype == np.uint32:
        t = torch.as_tensor(a.view(np.int32)).to(device)
        return t.to(torch.int64) & 0xFFFFFFFF
    return torch.as_tensor(a).to(device)


def infer_image_array(model: DetectionModel, hwc, score_threshold: float,
                      nms_threshold: float) -> Dict[str, np.ndarray]:
    """Array-level inference shared by :func:`predict` and
    ``metrics.evaluate_model`` (one pipeline): pad to a multiple of 128
    (anchors and padding as the reference: the pad changes border
    features), one forward pass in evaluation mode on the model's device,
    decode, sigmoid, best non-background class, score filter, per-class
    NMS, clip to the unpadded extent. ``hwc`` is an (H, W, C) numpy array
    or tensor; its values are taken as float32. Counts the boxes that pass
    the score filter (``detect.candidates``) and those NMS keeps
    (``detect.kept``)."""
    dev = model.device
    model.eval()
    with torch.inference_mode():
        x = _tensor(hwc, dev).to(torch.float32)
        H, W, C = x.shape
        ph = ((H + 127) // 128) * 128
        pw = ((W + 127) // 128) * 128
        padded = torch.zeros((1, C, ph, pw), dtype=torch.float32, device=dev)
        padded[0, :, :H, :W] = x.permute(2, 0, 1)
        del x
        with telemetry.stage("detect.forward"):
            cls_logits, box_deltas = model(padded)
            del padded
        with telemetry.stage("detect.decode"):
            boxes = decode_boxes(model.anchors((ph, pw)), box_deltas[0])
            scores_all = torch.sigmoid(cls_logits[0])  # (N, K)
            # best non-background class per anchor (slot 0 = background)
            multi = scores_all.shape[1] > 1
            cls_scores = scores_all[:, 1:] if multi else scores_all
            labels = cls_scores.argmax(dim=1) + (1 if multi else 0)
            scores = cls_scores.amax(dim=1)
            keep = scores >= score_threshold
            boxes = boxes[keep].cpu().numpy()
            scores = scores[keep].cpu().numpy()
            labels = labels[keep].cpu().numpy()
    # both counters register at 0, so a raster without candidates reads 0
    telemetry.count("detect.candidates", len(boxes))
    with telemetry.stage("detect.nms"):
        if len(boxes):
            # per-class NMS via the batched_nms offset trick: shift each
            # class onto a disjoint coordinate range so cross-class boxes
            # can never overlap, then run one plain NMS
            off = labels.astype(np.float64)[:, None] * (float(boxes.max())
                                                       + 1.0)
            keep_idx = nms_numpy(boxes + off, scores, nms_threshold)
            boxes, scores, labels = (boxes[keep_idx], scores[keep_idx],
                                     labels[keep_idx])
            # clip to raster extent
            boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, W)
            boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, H)
    telemetry.count("detect.kept", len(boxes))
    return {"boxes": boxes, "scores": scores, "labels": labels}


def scale_to_uint8(image_array, device) -> torch.Tensor:
    """The reference's global min-max scaling to uint8 (predict.py:30-34),
    on ``device``: ``255.0 * (x - min) / (max - min + 1e-8)`` in float64,
    clipped and truncated; a constant raster is only clipped. Each step is
    one correctly rounded float64 operation, so the result is bitwise the
    reference's on the host or on the card."""
    x = _tensor(image_array, device)
    data_min = float(x.min())
    data_max = float(x.max())
    if data_max > data_min:
        x = 255.0 * (x.to(torch.float64) - data_min) / \
            (data_max - data_min + 1e-8)
    return torch.clamp(x, 0, 255).to(torch.uint8)


def predict(model: DetectionModel, image_path: str, device=None,
            score_threshold: float = 0.5,
            nms_threshold: float = 0.5) -> Dict[str, np.ndarray]:
    """Detect on a whole raster with the model on its device (``device``
    moves the model there first, as the reference's ``model.to(device)``)."""
    if device is not None:
        model.to(device)
    with telemetry.stage("detect.read"):
        image_array = TiffReader(image_path).read()
    with telemetry.stage("detect.scale"):
        image_u8 = scale_to_uint8(image_array, model.device)
        del image_array
    return infer_image_array(model, image_u8, score_threshold,
                             nms_threshold)
