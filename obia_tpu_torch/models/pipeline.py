"""The fused OBIA model (port of ``obia_tpu/models/pipeline.py``).

:func:`obia_forward` chains SLIC k-means, per-object moment features, a
standardisation and an MLP head into class logits, on the image's device.
:func:`make_sharded_train_step` is the same pipeline over a
:class:`~obia_tpu_torch.parallel.mesh.Mesh`: SLIC and the moments run per
shard with their sums reduced over the mesh, and the head trains
data-parallel, each shard taking its slice of the object batch, the
gradients summed over the mesh and plain SGD applied to every copy. On a
mesh that spans ranks (``make_mesh(..., distributed=True)``) each rank
runs its own shards, and the reductions give every rank the one-process
result.

The head's parameters keep the JAX package's names and layouts (``w1`` is
(features, hidden), ``x @ w1 + b1``), so :func:`params_from_jax` and
:func:`params_to_jax` carry weights across as plain copies. The centre sums
are added in float64 and rounded once (``ops/slic``); the moment sums are
float32, as the reference's, added in pixel order on every device
(:func:`_ordered_segment_sum`), so no result depends on the order the
card's atomics add in.
"""
from __future__ import annotations

import math
from typing import Callable, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.slic import (_grid_shape, initial_centers, slic_assign_block,
                        slic_update_sums, slic_update_sums64, update_centers)
from ..ops.stats import segment_sum
from ..parallel.mesh import Mesh, ShardedRaster, psum, shard_raster

MLP_HIDDEN = 64
_PARAM_NAMES = ("w1", "b1", "w2", "b2")


class FusedMLP(nn.Module):
    """The classifier head: ``relu(x @ w1 + b1) @ w2 + b2``."""

    def __init__(self, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                 b2: torch.Tensor):
        super().__init__()
        self.w1, self.b1, self.w2, self.b2 = (nn.Parameter(t)
                                              for t in (w1, b1, w2, b2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(x @ self.w1 + self.b1) @ self.w2 + self.b2


def init_mlp_params(generator_or_seed, n_features: int, n_classes: int,
                    hidden: int = MLP_HIDDEN, device=None) -> FusedMLP:
    """Normal weights scaled by 1/sqrt(fan_in) and zero biases, drawn on
    the host from a ``torch.Generator`` (or a seed), then moved to
    ``device`` (the card when None)."""
    g = generator_or_seed
    if not isinstance(g, torch.Generator):
        g = torch.Generator().manual_seed(int(g))
    w1 = torch.randn((n_features, hidden), generator=g) / math.sqrt(
        n_features)
    w2 = torch.randn((hidden, n_classes), generator=g) / math.sqrt(hidden)
    return FusedMLP(w1, torch.zeros(hidden), w2, torch.zeros(n_classes)).to(
        resolve_device(device))


def params_from_jax(tree, device=None) -> FusedMLP:
    """The head holding the JAX package's ``{"w1", "b1", "w2", "b2"}``
    arrays, on ``device`` (the card when None)."""
    return FusedMLP(*(torch.from_numpy(np.array(tree[k], np.float32))
                      for k in _PARAM_NAMES)).to(resolve_device(device))


def params_to_jax(model: FusedMLP) -> dict:
    """The head's parameters as the JAX package's tree of numpy arrays."""
    return {k: getattr(model, k).detach().cpu().numpy().copy()
            for k in _PARAM_NAMES}


def _ordered_segment_sum(values: torch.Tensor, seg: torch.Tensor,
                         K: int) -> torch.Tensor:
    """(N, F) rows summed by segment id, each segment's rows added one by
    one in row order from zero. No one call does so on both devices:
    ``index_add_`` does on the CPU (the reference's order there) but adds
    with atomics on the card; ``index_put_(accumulate=True)`` sorts the
    ids stably and adds each segment's rows in order on the card, but on
    a multi-threaded CPU adds float32 rows with atomics, in an order that
    changes run to run (``test_ordered_segment_sum_adds_in_row_order``)."""
    if values.device.type == "cpu":
        return segment_sum(values, seg, K)
    out = torch.zeros((K, values.shape[1]), dtype=values.dtype,
                      device=values.device)
    return out.index_put_((seg,), values, accumulate=True)


def _moment_sums(image: torch.Tensor, labels: torch.Tensor,
                 K: int) -> torch.Tensor:
    """(K, 2C+1) float32 sums of a block's labelled pixels: count, x and
    x*x. Where every pixel has a label (the sharded step) the mask is all
    ones and changes nothing."""
    C = image.shape[-1]
    x = image.reshape(-1, C)
    lab = labels.reshape(-1)
    ok = lab >= 0
    w = ok.to(torch.float32)[:, None]
    rows = torch.cat([w, x * w, x * x * w], dim=1)
    return _ordered_segment_sum(rows, torch.where(ok, lab, 0), K)


def _features(s: torch.Tensor, C: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Summed moments -> ((K, 2C+1) mean, variance, log1p(count); (K,)
    count). The log-count is worked in float64 and rounded once, so the
    card and the CPU agree: neither's float32 ``log1p`` is correctly
    rounded, and the counts of a near-regular grid barely differ, so
    standardising them turns an ulp into ~1e-5."""
    cnt, s1, s2 = s[:, 0], s[:, 1:C + 1], s[:, C + 1:]
    denom = torch.clamp(cnt, min=1.0)[:, None]
    mean = s1 / denom
    var = torch.clamp(s2 / denom - mean ** 2, min=0.0)
    log_cnt = torch.log1p(cnt.double()).to(cnt.dtype)
    return torch.cat([mean, var, log_cnt[:, None]], dim=1), cnt


def _object_features(image: torch.Tensor, labels: torch.Tensor, K: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K, 2C+1) per-object features (mean, variance, log-count) and the
    (K,) counts; pixels labelled -1 are left out."""
    return _features(_moment_sums(image, labels, K), image.shape[-1])


def _standardize(feats: torch.Tensor) -> torch.Tensor:
    """Each column less its mean, over its population (ddof 0) standard
    deviation + 1e-6, worked in float64 and rounded once: where a column's
    objects barely differ (the log-counts of a near-regular grid), an ulp
    of its mean is a large relative error in every standardised value, and
    float32 column sums in another order (the card's) would show it."""
    f = feats.double()
    sd = f.std(dim=0, correction=0, keepdim=True) + 1e-6
    return ((f - f.mean(dim=0, keepdim=True)) / sd).to(feats.dtype)


def obia_forward(image: torch.Tensor, model: FusedMLP, *, gh: int, gw: int,
                 n_iter: int = 5, compactness: float = 10.0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fused forward pass, SLIC -> object features -> class logits, on
    the (H, W, C) float32 image's device. Returns (logits (K, n_classes),
    labels (H, W) int64 in [0, K)), K = gh * gw."""
    H, W, _ = image.shape
    K = gh * gw
    ratio = (compactness / math.sqrt(H * W / K)) ** 2
    valid = torch.ones((H, W), dtype=torch.bool, device=image.device)
    with torch.no_grad():
        centers = initial_centers(image, gh, gw)
        for _ in range(n_iter):
            lab = slic_assign_block(image, valid, centers, gh, gw, ratio)
            centers = update_centers(*slic_update_sums(image, lab, K),
                                     centers)
        labels = slic_assign_block(image, valid, centers, gh, gw, ratio)
        feats, _ = _object_features(image, labels, K)
    return model(_standardize(feats)), labels


def make_flagship(h: int = 512, w: int = 512, c: int = 4,
                  n_segments: int = 256, n_classes: int = 8, device=None):
    """(fn, (image, model)) of the fused forward on the reference's seeded
    (h, w, c) image, on ``device`` (the card when None)."""
    dev = resolve_device(device)
    gh, gw = _grid_shape(h, w, n_segments)
    model = init_mlp_params(0, 2 * c + 1, n_classes, device=dev)
    image = torch.as_tensor(np.random.default_rng(0).random((h, w, c)),
                            dtype=torch.float32).to(dev)

    def fn(image, model):
        return obia_forward(image, model, gh=gh, gw=gw)

    return fn, (image, model)


def make_sharded_train_step(mesh: Mesh, H: int, W: int, C: int,
                            n_segments: int, n_classes: int,
                            compactness: float = 10.0, n_iter: int = 2,
                            lr: float = 1e-3
                            ) -> Tuple[Callable, Callable,
                                       Tuple[int, int, int]]:
    """One training step over ``mesh``: SLIC per shard with replicated
    centres, the per-object moments summed over the mesh and standardised
    over all K objects, then the head trained data-parallel. Each shard
    takes its ``Kpad // n_shards`` slice of the zero-padded object batch
    (targets padded with -1 and masked); its loss is its masked
    cross-entropy sum over the global valid count, and the gradients are
    summed over the shards before plain SGD (``p <- p - lr * g``).

    Returns ``(train_step, init, (gh, gw, K))``. ``init()`` gives
    ``(model, opt_state)``, the model on the mesh's home device and the
    state empty (SGD keeps none). ``train_step(image, targets, centers,
    model, opt_state)`` takes a :class:`ShardedRaster` or an (H, W, C)
    float32 tensor it shards itself, (K,) targets and (gh, gw, C+2)
    centres on the home device, updates the model in place and returns
    ``(model, opt_state, loss, centers)``. ``H`` and ``W`` must divide by
    the mesh's (ty, tx): padding would move every seed."""
    ty, tx = mesh.shape
    if H % ty or W % tx:
        raise ValueError(f"a {H} x {W} raster does not split evenly over a "
                         f"({ty}, {tx}) mesh")
    gh, gw = _grid_shape(H, W, n_segments)
    K = gh * gw
    ratio = (compactness / math.sqrt(H * W / K)) ** 2
    n_shards = ty * tx
    Kpad = -(-K // n_shards) * n_shards
    per_shard = Kpad // n_shards

    def assign(img: ShardedRaster, i: int, j: int, centers: torch.Tensor):
        blk = img.block(i, j)
        valid = torch.ones(blk.shape[:2], dtype=torch.bool,
                           device=blk.device)
        return slic_assign_block(blk, valid, centers.to(blk.device), gh, gw,
                                 ratio, origin=img.origin(i, j),
                                 full_hw=(H, W))

    def train_step(image, targets, centers, model, opt_state):
        img = image if isinstance(image, ShardedRaster) else \
            shard_raster(mesh, image)[0]
        if img.padded_hw != (H, W) or img.crop_hw != (H, W):
            raise ValueError(f"the step was built for {H} x {W}, not "
                             f"{img.crop_hw[0]} x {img.crop_hw[1]}")
        shards = list(mesh.shards())
        with torch.no_grad():
            for _ in range(n_iter):
                out = psum(mesh, [slic_update_sums64(
                    img.block(i, j), assign(img, i, j, centers), K,
                    img.origin(i, j)) for i, j in shards]).float()
                centers = update_centers(out[:, :C + 2], out[:, C + 2],
                                         centers)
            sums = psum(mesh, [_moment_sums(img.block(i, j),
                                            assign(img, i, j, centers), K)
                               for i, j in shards])
            feats = F.pad(_standardize(_features(sums, C)[0]),
                          (0, 0, 0, Kpad - K))
            targets_p = F.pad(targets.long(), (0, Kpad - K), value=-1)
            n_valid = torch.clamp((targets_p >= 0).sum().float(), min=1.0)
        params = [getattr(model, k) for k in _PARAM_NAMES]
        losses, grads = [], []
        for i, j in shards:
            rows = slice((i * tx + j) * per_shard,
                         (i * tx + j + 1) * per_shard)
            t = targets_p[rows]
            ce = F.cross_entropy(model(feats[rows]), torch.clamp(t, min=0),
                                 reduction="none")
            loss = (ce * (t >= 0).float()).sum() / n_valid
            grads.append(torch.cat([g.reshape(-1) for g in
                                    torch.autograd.grad(loss, params)]))
            losses.append(loss.detach())
        grad, loss = psum(mesh, grads), psum(mesh, losses)
        with torch.no_grad():
            for p, g in zip(params, grad.split([p.numel() for p in params])):
                p.sub_(g.view_as(p) * lr)
        return model, opt_state, loss, centers

    def init():
        return init_mlp_params(0, 2 * C + 1, n_classes,
                               device=mesh.home), ()

    return train_step, init, (gh, gw, K)
