"""ResNet-50 backbone + FPN in torch (the port's counterpart of
``obia_tpu/detection/backbone.py``).

Bottleneck ResNet-50 emitting C3/C4/C5 and a feature pyramid P3-P7, on
NCHW tensors, with the JAX package's topology: a 7x7/2 stem (padding 3) and
a 3x3/2 max-pool (padding 1), a projection shortcut wherever a block
changes shape, P6 from C5 and P7 from relu(P6), the top-down path
upsampled by repeat-then-crop. ``in_channels`` is a constructor argument,
so N-band imagery needs no first-conv surgery.

Submodules carry the Flax module names (``conv1``, ``BatchNorm_0``,
``Bottleneck_3``, ``Conv_1``, ``lat5``, ...), so a parameter's path here
is its path in the reference's ``params``/``batch_stats`` trees
(:func:`obia_tpu_torch.detection.models.detection_model_from_jax`).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm(nn.Module):
    """Flax's ``nn.BatchNorm`` (momentum 0.99, epsilon 1e-5, fast
    variance) over the channels of an NCHW tensor.

    In training it normalises with the batch's biased variance
    ``max(0, mean(x^2) - mean(x)^2)`` and moves the running statistics by
    Flax's rule, ``0.99 * running + 0.01 * batch``, with that same biased
    variance (``torch.nn.BatchNorm2d`` stores the unbiased one). In
    evaluation it uses the running statistics. Either way the output is
    ``(x - mean) * (rsqrt(var + eps) * weight) + bias``, Flax's order.
    """

    def __init__(self, channels: int, momentum: float = 0.99,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean,
                              min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return torch.addcmul(self.bias[:, None, None], x - mean[:, None, None],
                             mul[:, None, None])


def _conv(cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
          bias: bool = True) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding, bias=bias)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_features: int, features: int, strides: int = 1):
        super().__init__()
        out = features * self.expansion
        self.Conv_0 = _conv(in_features, features, 1, bias=False)
        self.BatchNorm_0 = BatchNorm(features)
        self.Conv_1 = _conv(features, features, 3, strides, 1, bias=False)
        self.BatchNorm_1 = BatchNorm(features)
        self.Conv_2 = _conv(features, out, 1, bias=False)
        self.BatchNorm_2 = BatchNorm(out)
        # the reference projects the shortcut when the residual's shape
        # differs from the block's output: a channel change or a stride
        self.project = in_features != out or strides != 1
        if self.project:
            self.Conv_3 = _conv(in_features, out, 1, strides, bias=False)
            self.BatchNorm_3 = BatchNorm(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        residual = self.BatchNorm_3(self.Conv_3(x)) if self.project else x
        return F.relu(y + residual)


class ResNet50(nn.Module):
    """Returns (C3, C4, C5) feature maps at strides 8/16/32. ``width``
    scales the base channel count (64 = the real ResNet-50; small values
    give a test-sized backbone with the same topology)."""

    def __init__(self, in_channels: int = 3,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3), width: int = 64):
        super().__init__()
        self.conv1 = _conv(in_channels, width, 7, 2, 3, bias=False)
        self.BatchNorm_0 = BatchNorm(width)
        self.stage_ends = []
        cin, k = width, 0
        for i, block_count in enumerate(stage_sizes):
            features = width * (2 ** i)
            for j in range(block_count):
                strides = 2 if (i > 0 and j == 0) else 1
                setattr(self, f"Bottleneck_{k}",
                        Bottleneck(cin, features, strides))
                cin = features * Bottleneck.expansion
                k += 1
            self.stage_ends.append(k)
        self.n_blocks = k
        self.out_channels = tuple(width * (2 ** i) * Bottleneck.expansion
                                  for i in range(1, len(stage_sizes)))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        y = F.relu(self.BatchNorm_0(self.conv1(x)))
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        outputs = []
        for k in range(self.n_blocks):
            y = getattr(self, f"Bottleneck_{k}")(y)
            if k + 1 in self.stage_ends[1:]:
                outputs.append(y)
        return tuple(outputs)  # C3, C4, C5


class FPN(nn.Module):
    """Feature pyramid P3-P7 (RetinaNet variant: P6/P7 from C5)."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256):
        super().__init__()
        c3, c4, c5 = in_channels
        o = out_channels
        self.lat5 = _conv(c5, o, 1)
        self.lat4 = _conv(c4, o, 1)
        self.lat3 = _conv(c3, o, 1)
        self.out3 = _conv(o, o, 3, padding=1)
        self.out4 = _conv(o, o, 3, padding=1)
        self.out5 = _conv(o, o, 3, padding=1)
        self.p6 = _conv(c5, o, 3, 2, 1)
        self.p7 = _conv(o, o, 3, 2, 1)

    def forward(self, feats: Tuple[torch.Tensor, ...]):
        c3, c4, c5 = feats
        p5 = self.lat5(c5)
        p4 = self.lat4(c4) + _upsample2x(p5, c4.shape)
        p3 = self.lat3(c3) + _upsample2x(p4, c3.shape)
        p3 = self.out3(p3)
        p4 = self.out4(p4)
        p5 = self.out5(p5)
        p6 = self.p6(c5)
        p7 = self.p7(F.relu(p6))
        return (p3, p4, p5, p6, p7)


def _upsample2x(x: torch.Tensor, target_shape) -> torch.Tensor:
    """Nearest 2x upsampling cropped to the target's (H, W) (NCHW)."""
    th, tw = target_shape[2], target_shape[3]
    up = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    return up[:, :, :th, :tw]
