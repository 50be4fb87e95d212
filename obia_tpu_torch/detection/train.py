"""RetinaNet training loop (the port's counterpart of
``obia_tpu/detection/train.py``).

``train_model(model, train_loader, num_epochs, device)`` (reference
train.py:11-50): Adam lr=1e-4, an epoch loop over the loader, the average
loss printed each epoch, the trained model returned. Each step pads the
batch to a common multiple of 128 (as the reference: BatchNorm's batch
statistics include the zero pad), runs the forward in training mode,
sums the per-image focal and box losses as ``cls.mean() + box.mean()``,
and takes one Adam step; the forward and backward use cuDNN's
deterministic algorithms, so training repeats run to run. Ground truth
stays one variable-length tensor per image (the JAX package pads it to
fixed slots for static shapes).
"""
from __future__ import annotations

import contextlib
import os
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from ..checkpoint import save_pytree
from .models import DetectionModel, detection_state_to_jax_tree, \
    retinanet_loss


def _pad_batch(images: Sequence[np.ndarray], targets: Sequence[dict],
               device, multiple: int = 128):
    """CHW images padded with zeros to a common (H, W) multiple of
    ``multiple`` as one (B, C, H, W) float32 tensor on ``device``, and
    each image's boxes (M, 4) float32 and labels (M,) int64 as tensors
    there. Returns (images, boxes, labels, (H, W))."""
    H = max(img.shape[1] for img in images)
    W = max(img.shape[2] for img in images)
    H = ((H + multiple - 1) // multiple) * multiple
    W = ((W + multiple - 1) // multiple) * multiple
    C = images[0].shape[0]
    out = np.zeros((len(images), C, H, W), np.float32)
    boxes, labels = [], []
    for i, (img, tgt) in enumerate(zip(images, targets)):
        c, h, w = img.shape
        out[i, :, :h, :w] = img
        boxes.append(torch.as_tensor(
            np.asarray(tgt["boxes"], np.float32).reshape(-1, 4),
            device=device))
        labels.append(torch.as_tensor(
            np.asarray(tgt["labels"], np.int64).reshape(-1), device=device))
    return torch.as_tensor(out, device=device), boxes, labels, (H, W)


def batch_loss(model: DetectionModel, images: torch.Tensor,
               boxes: List[torch.Tensor], labels: List[torch.Tensor],
               hw: Tuple[int, int]) -> torch.Tensor:
    """The training loss of one padded batch: the forward in training mode
    (moving BatchNorm's running statistics), then the mean over images of
    the focal loss plus the mean of the box loss (reference train.py:68)."""
    model.train()
    cls_logits, box_deltas = model(images)
    anchors = model.anchors(hw)
    per_image = [retinanet_loss(cls_logits[i], box_deltas[i], anchors,
                                boxes[i], labels[i])
                 for i in range(images.shape[0])]
    cls_l = torch.stack([c for c, _ in per_image])
    box_l = torch.stack([b for _, b in per_image])
    return cls_l.mean() + box_l.mean()


@contextlib.contextmanager
def _deterministic_cudnn():
    """cuDNN's deterministic algorithms, without autotuning, inside the
    block; the caller's two flags come back after it. Only these two:
    ``torch.backends.cudnn.flags`` would also reset TF32, which the package
    keeps off."""
    cudnn = torch.backends.cudnn
    was = cudnn.benchmark, cudnn.deterministic
    cudnn.benchmark, cudnn.deterministic = False, True
    try:
        yield
    finally:
        cudnn.benchmark, cudnn.deterministic = was


def make_train_step(model: DetectionModel,
                    optimizer: torch.optim.Optimizer) -> Callable:
    """``step(images, targets) -> loss tensor``: pad the batch onto the
    model's device (:func:`_pad_batch`), then take
    :func:`make_padded_train_step`'s step on it."""
    padded_step = make_padded_train_step(model, optimizer)

    def step(images, targets):
        return padded_step(*_pad_batch(list(images), list(targets),
                                       model.device))
    return step


def make_padded_train_step(model: DetectionModel,
                           optimizer: torch.optim.Optimizer) -> Callable:
    """``step(images, boxes, labels, hw) -> loss tensor`` on a batch that
    :func:`_pad_batch` padded onto the model's device: compute
    :func:`batch_loss`, back-propagate and take one optimiser step.

    The forward and backward run with cuDNN's deterministic algorithms and
    no autotuning, so two runs of the same steps give the same model, as
    the reference's training does: the default weight-gradient algorithms
    add with atomics. The flags are set for the step only and restored
    after it."""
    def step(imgs, boxes, labels, hw):
        with _deterministic_cudnn():
            loss = batch_loss(model, imgs, boxes, labels, hw)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
        optimizer.step()
        return loss.detach()
    return step


def train_model(model: DetectionModel, train_loader, num_epochs: int,
                device=None, checkpoint_dir: str = None) -> DetectionModel:
    """Train (reference train.py:11-50: Adam 1e-4, the per-epoch average
    loss printed, the trained model returned) on the model's device;
    ``device`` moves the model there first. ``checkpoint_dir`` saves
    ``epoch_{i}.npz`` after each epoch: the ``{"params", "batch_stats"}``
    tree under Flax's paths, which the JAX package loads too."""
    if device is not None:
        model.to(device)
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-4)
    step = make_train_step(model, optimizer)

    for epoch in range(num_epochs):
        total_loss = 0.0
        n_batches = 0
        for images, targets in train_loader:
            total_loss += float(step(images, targets))
            n_batches += 1
        avg = total_loss / max(n_batches, 1)
        print(f"Epoch {epoch + 1}/{num_epochs} - Loss: {avg:.4f}",
              flush=True)
        if checkpoint_dir:
            os.makedirs(checkpoint_dir, exist_ok=True)
            save_pytree(os.path.join(checkpoint_dir, f"epoch_{epoch + 1}"),
                        detection_state_to_jax_tree(model))
    return model
