"""RetinaNet detection model in torch (the port's counterpart of
``obia_tpu/detection/models.py``).

ResNet-50 + FPN backbone (:mod:`.backbone`), classification and box
regression heads shared over P3-P7 (four 3x3 convolutions each, 9 anchors a
cell), focal-loss training. ``in_channels`` is a constructor argument and
no input normalisation is applied, as in the reference. The convolutions are
``nn.Conv2d`` (cuDNN on the card, in true float32: the package switches TF32
off), the counterpart of the XLA convolutions the JAX package runs.

Parameters are initialised from ``torch.Generator(seed)`` with Flax's
distributions: convolution kernels LeCun normal (truncated at two standard
deviations, fan-in scaled), biases zero, BatchNorm scale 1 and bias 0 with
running mean 0 and variance 1, and the class output's bias the focal prior
-4.595. The numbers differ from JAX's for a seed; the distributions do not.
Trained weights carry between the packages with
:func:`detection_model_from_jax` and :func:`detection_state_to_jax_tree`.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .anchors import NUM_ANCHORS, anchors_for_shape, encode_boxes, \
    match_anchors
from .backbone import FPN, BatchNorm, ResNet50

FOCAL_PRIOR = -4.595  # sigmoid(-4.595) = 0.01


class RetinaNetHead(nn.Module):
    def __init__(self, num_classes: int, num_anchors: int = NUM_ANCHORS,
                 features: int = 256):
        super().__init__()
        self.num_classes = num_classes
        f = features
        for i in range(4):
            setattr(self, f"cls_t{i}", nn.Conv2d(f, f, 3, padding=1))
        for i in range(4):
            setattr(self, f"box_t{i}", nn.Conv2d(f, f, 3, padding=1))
        self.cls_out = nn.Conv2d(f, num_anchors * num_classes, 3, padding=1)
        self.box_out = nn.Conv2d(f, num_anchors * 4, 3, padding=1)

    def forward(self, feats):
        cls_outs, box_outs = [], []
        for f in feats:
            c = f
            for i in range(4):
                c = F.relu(getattr(self, f"cls_t{i}")(c))
            c = self.cls_out(c)
            # (B, A*K, H, W) -> (B, H, W, A*K) -> (B, H*W*A, K): the
            # anchors' (y, x, a) order of anchors_for_shape
            cls_outs.append(c.permute(0, 2, 3, 1).reshape(
                c.shape[0], -1, self.num_classes))
            b = f
            for i in range(4):
                b = F.relu(getattr(self, f"box_t{i}")(b))
            b = self.box_out(b)
            box_outs.append(b.permute(0, 2, 3, 1).reshape(b.shape[0], -1, 4))
        return torch.cat(cls_outs, dim=1), torch.cat(box_outs, dim=1)


class RetinaNet(nn.Module):
    def __init__(self, num_classes: int = 2, in_channels: int = 3,
                 backbone_width: int = 64, fpn_channels: int = 256,
                 stage_sizes: Tuple[int, ...] = (3, 4, 6, 3)):
        super().__init__()
        self.ResNet50_0 = ResNet50(in_channels, stage_sizes, backbone_width)
        self.FPN_0 = FPN(self.ResNet50_0.out_channels, fpn_channels)
        self.RetinaNetHead_0 = RetinaNetHead(num_classes,
                                             features=fpn_channels)

    def forward(self, images: torch.Tensor):
        """images: (B, C, H, W) float32. Returns (cls_logits (B, N, K),
        box_deltas (B, N, 4))."""
        return self.RetinaNetHead_0(self.FPN_0(self.ResNet50_0(images)))


def focal_loss(logits, labels, alpha: float = 0.25, gamma: float = 2.0):
    """Sigmoid focal loss. ``labels``: int class per anchor (0 =
    background, 1..K-1 the classes: slot 0 is unused for background, as in
    torchvision); the target is one-hot over the K slots, all zeros for
    background."""
    num_classes = logits.shape[-1]
    t = F.one_hot(labels, num_classes).to(logits.dtype)
    t = torch.where((labels > 0)[..., None], t, 0.0)
    p = torch.sigmoid(logits)
    ce = optax_sigmoid_ce(logits, t)
    p_t = p * t + (1 - p) * (1 - t)
    alpha_t = alpha * t + (1 - alpha) * (1 - t)
    return alpha_t * ((1 - p_t) ** gamma) * ce


def optax_sigmoid_ce(logits, targets):
    """optax.sigmoid_binary_cross_entropy's form."""
    return torch.clamp(logits, min=0) - logits * targets + \
        torch.log1p(torch.exp(-torch.abs(logits)))


def smooth_l1(x, beta: float = 1.0 / 9.0):
    ax = torch.abs(x)
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def retinanet_loss(cls_logits, box_deltas, anchors, gt_boxes, gt_labels):
    """Per-image RetinaNet loss (focal cls + smooth-L1 box), each summed
    and divided by the number of positive anchors (at least 1).

    gt_boxes: (M, 4); gt_labels: (M,) int. M may be 0: the image trains
    as background.
    """
    gt_valid = None
    if gt_boxes.shape[0] == 0:
        # one invalid zero row, as the reference's padded slots: the
        # gathers below need a row to index
        gt_boxes = gt_boxes.new_zeros((1, 4))
        gt_labels = gt_labels.new_zeros((1,))
        gt_valid = torch.zeros(1, dtype=torch.bool, device=gt_boxes.device)
    matched_gt, match_label = match_anchors(anchors, gt_boxes, gt_valid)
    # classification target per anchor: gt label where fg else 0 (bg)
    anchor_cls = torch.where(match_label == 1, gt_labels[matched_gt], 0)
    cls_l = focal_loss(cls_logits, anchor_cls)
    cls_mask = (match_label >= 0).to(cls_l.dtype)[:, None]
    n_pos = torch.clamp((match_label == 1).sum(), min=1)
    cls_total = (cls_l * cls_mask).sum() / n_pos

    target_deltas = encode_boxes(anchors, gt_boxes[matched_gt])
    box_l = smooth_l1(box_deltas - target_deltas).sum(dim=1)
    box_total = (box_l * (match_label == 1)).sum() / n_pos
    return cls_total, box_total


class DetectionModel(RetinaNet):
    """The RetinaNet that :func:`build_detection_model` returns, with its
    class and band counts and a per-shape anchor cache on the model's
    device; the train, predict and metrics modules operate on it."""

    def __init__(self, num_classes: int, in_channels: int, seed: int = 0,
                 image_size: Tuple[int, int] = (512, 512),
                 backbone_width: int = 64, fpn_channels: int = 256,
                 stage_sizes: Tuple[int, ...] = (3, 4, 6, 3)):
        super().__init__(num_classes, in_channels, backbone_width,
                         fpn_channels, tuple(stage_sizes))
        self.num_classes = num_classes
        self.in_channels = in_channels
        self.image_size = tuple(image_size)
        self._anchor_cache: Dict[tuple, torch.Tensor] = {}
        init_flax_like(self, seed)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def anchors(self, hw: Tuple[int, int]) -> torch.Tensor:
        """The anchors of an (H, W) input, on the model's device and in its
        parameters' dtype."""
        p = next(self.parameters())
        key = (tuple(hw), p.device, p.dtype)
        if key not in self._anchor_cache:
            self._anchor_cache[key] = torch.as_tensor(
                anchors_for_shape(tuple(hw)), dtype=p.dtype, device=p.device)
        return self._anchor_cache[key]


def _lecun_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """Flax's ``lecun_normal()``: a standard normal truncated to [-2, 2]
    (drawn by inverting its CDF) times sqrt(1 / fan_in) / 0.8796...; the
    kernel is OIHW, so fan_in = I * H * W."""
    fan_in = shape[1] * shape[2] * shape[3]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))  # Phi(-2)
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + u * (1.0 - 2.0 * lo)) - 1.0)
    return (torch.clamp(z, -2.0, 2.0) * std).to(torch.float32)


@torch.no_grad()
def init_flax_like(model: nn.Module, seed: int) -> None:
    """Initialise every convolution and BatchNorm of ``model`` (on the CPU,
    in module order) as Flax initialises the reference's."""
    gen = torch.Generator().manual_seed(seed)
    for name, mod in model.named_modules():
        if isinstance(mod, nn.Conv2d):
            mod.weight.copy_(_lecun_normal(tuple(mod.weight.shape), gen))
            if mod.bias is not None:
                mod.bias.fill_(FOCAL_PRIOR if name.endswith("cls_out")
                               else 0.0)
        elif isinstance(mod, BatchNorm):
            mod.weight.fill_(1.0)
            mod.bias.fill_(0.0)
            mod.running_mean.fill_(0.0)
            mod.running_var.fill_(1.0)


def build_detection_model(num_classes: int = 2, in_channels: int = 10,
                          seed: int = 0,
                          image_size: Tuple[int, int] = (512, 512),
                          backbone_width: int = 64, fpn_channels: int = 256,
                          stage_sizes: Tuple[int, ...] = (3, 4, 6, 3),
                          device=None) -> DetectionModel:
    """A RetinaNet for N-channel imagery (reference detection/models.py
    :19-62), initialised on the host from ``seed`` and moved to ``device``:
    the card when None (raising without one)."""
    dev = resolve_device(device)
    model = DetectionModel(num_classes, in_channels, seed=seed,
                           image_size=image_size,
                           backbone_width=backbone_width,
                           fpn_channels=fpn_channels,
                           stage_sizes=stage_sizes)
    return model.to(dev)


# -- the weight carry between the packages -----------------------------------

def _node(tree: dict, path: str) -> dict:
    for part in path.split("."):
        tree = tree[part]
    return tree


def detection_model_from_jax(params, batch_stats, device=None,
                             **config) -> DetectionModel:
    """The port's model holding the reference's Flax ``params`` and
    ``batch_stats`` trees (nested dicts of arrays under Flax's module
    names, e.g. ``ResNet50_0/Bottleneck_3/Conv_1/kernel``). ``config``
    takes :func:`build_detection_model`'s architecture arguments; the
    model goes to ``device`` (the card when None). Convolution kernels go
    from HWIO to OIHW; BatchNorm ``scale``/``bias``/``mean``/``var``
    become ``weight``/``bias``/``running_mean``/``running_var``."""
    model = build_detection_model(device="cpu", **config)
    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, nn.Conv2d):
                p = _node(params, name)
                mod.weight.copy_(_tensor(p["kernel"]).permute(3, 2, 0, 1))
                if mod.bias is not None:
                    mod.bias.copy_(_tensor(p["bias"]))
            elif isinstance(mod, BatchNorm):
                p, s = _node(params, name), _node(batch_stats, name)
                for dst, src in ((mod.weight, p["scale"]),
                                 (mod.bias, p["bias"]),
                                 (mod.running_mean, s["mean"]),
                                 (mod.running_var, s["var"])):
                    dst.copy_(_tensor(src))
    return model.to(resolve_device(device))


def _tensor(leaf) -> torch.Tensor:
    """A float32 CPU tensor of its own (JAX arrays are read-only)."""
    return torch.from_numpy(np.array(leaf, np.float32))


def detection_state_to_jax_tree(model: nn.Module) -> dict:
    """The inverse of :func:`detection_model_from_jax`: ``{"params": ...,
    "batch_stats": ...}`` as nested dicts of host arrays (the model's dtype,
    float32 as built) under Flax's paths, the tree the reference's
    ``train_model`` checkpoints."""
    params: dict = {}
    stats: dict = {}

    def put(tree, path, leaves):
        node = tree
        for part in path.split("."):
            node = node.setdefault(part, {})
        for k, v in leaves.items():
            node[k] = v.detach().cpu().numpy().copy()

    for name, mod in model.named_modules():
        if isinstance(mod, nn.Conv2d):
            leaves = {"kernel": mod.weight.permute(2, 3, 1, 0)}
            if mod.bias is not None:
                leaves["bias"] = mod.bias
            put(params, name, leaves)
        elif isinstance(mod, BatchNorm):
            put(params, name, {"scale": mod.weight, "bias": mod.bias})
            put(stats, name, {"mean": mod.running_mean,
                              "var": mod.running_var})
    return {"params": params, "batch_stats": stats}


def load_detection_checkpoint(path: str, device=None,
                              **config) -> DetectionModel:
    """A model from a ``{"params", "batch_stats"}`` ``.npz`` checkpoint
    written by either package's ``train_model(checkpoint_dir=...)``."""
    from ..checkpoint import load_pytree
    tree = load_pytree(path)
    return detection_model_from_jax(tree["params"], tree["batch_stats"],
                                    device=device, **config)
