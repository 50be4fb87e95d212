"""Per-object GLCM texture properties (port of ``obia_tpu/ops/glcm.py``).

Semantics follow the reference: distance 2, angles 0/45/90/135 degrees
(skimage's rounded offsets (0,2), (1,1), (2,0), (1,-1)), 256 levels,
symmetric and normalised co-occurrence, props averaged over the angles that
have pairs. Pairs count only when both pixels belong to the object, and each
object is quantised by its own min and max.

One path: one pre-pass (:func:`bbox_minmax`) gives every object's bounding
box and every band's quantiser bounds, then :func:`ops.glcm_kernel.glcm_sums`
computes the exact per-(angle, object) sums of each band (the CUDA kernel on
the card, its twin on the CPU) and :func:`glcm_props_from_sums` finishes.

:func:`graycomatrix_reference` and :func:`graycoprops_reference` are host
copies of skimage's ``graycomatrix``/``graycoprops``, for the
``strict_reference_glcm`` hatch of ``create_objects`` only.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import telemetry
from ..device import input_device
from .glcm_kernel import glcm_sums

GLCM_PROP_NAMES = ("contrast", "dissimilarity", "homogeneity", "ASM",
                   "energy", "correlation")

DEFAULT_ANGLES = (0.0, math.pi / 4, math.pi / 2, 3 * math.pi / 4)

_EMPTY = float(np.finfo(np.float32).max)  # what an empty object keeps


def angle_offsets(distance: int, angles: Sequence[float]
                  ) -> Tuple[Tuple[int, int], ...]:
    return tuple((int(round(math.sin(a) * distance)),
                  int(round(math.cos(a) * distance))) for a in angles)


def quant_inv(rng: torch.Tensor, levels: int) -> torch.Tensor:
    """(levels-1)/range in f32, 0 for a constant object (every value then
    maps to level 0). Computed once per object so the kernel and its twin
    multiply by the identical value (see glcm_kernel.quantise_pixels)."""
    pos = rng > 0
    return torch.where(pos, torch.tensor(levels - 1, dtype=torch.float32,
                                         device=rng.device)
                       / torch.where(pos, rng, torch.ones_like(rng)),
                       torch.zeros_like(rng))


def _check_levels(levels: int) -> int:
    levels = int(levels)
    if not 1 <= levels <= 256:
        raise ValueError(
            f"levels={levels} out of range: 1..256 grey levels supported")
    return levels


def bbox_minmax(image: torch.Tensor, labels: torch.Tensor,
                num_segments: int, band_ids: Sequence[int],
                origin: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """(K, 4 + 2B) float32 per-object minima of [r, -r, c, -c, v_b, -v_b,
    ...] for each band b in ``band_ids``: bounding boxes and quantiser bounds
    in one pass. Rows and columns are global: the block's first pixel is
    ``origin``, so the minima of a sharded raster's blocks reduce with a
    plain minimum. Explicit f32 throughout; an empty object keeps the f32
    maximum in every column."""
    H, W = labels.shape
    K = num_segments
    lab = labels.reshape(-1).long()
    ok = lab >= 0
    seg = torch.where(ok, lab, K)
    dev = labels.device
    r = (torch.arange(H, device=dev) + origin[0]).to(torch.float32)[
        :, None].expand(H, W).reshape(-1)
    c = (torch.arange(W, device=dev) + origin[1]).to(torch.float32)[
        None, :].expand(H, W).reshape(-1)
    rows = [r, -r, c, -c]
    for b in band_ids:
        v = image[..., b].reshape(-1).to(torch.float32)
        rows += [v, -v]
    out = torch.full((len(rows), K + 1), _EMPTY, dtype=torch.float32,
                     device=dev)
    for i, row in enumerate(rows):
        out[i].scatter_reduce_(0, seg, row, "amin")  # row K: no object
    return out[:, :K].T.contiguous()


def _bboxes_from_mins(mins: torch.Tensor) -> torch.Tensor:
    """(K, 4) int32 [rmin, rmax, cmin, cmax]; empty objects: (1, 0, 1, 0)."""
    empty = mins[:, 0] >= 2e38
    cols = [torch.where(empty, 1.0, mins[:, 0]),
            torch.where(empty, 0.0, -mins[:, 1]),
            torch.where(empty, 1.0, mins[:, 2]),
            torch.where(empty, 0.0, -mins[:, 3])]
    return torch.stack(cols, dim=1).to(torch.int32).contiguous()


def sums_from_kernel(isums: torch.Tensor, hsum: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel outputs -> (sums_A (A, K, 7), asm_A (A, K)) in float64, the
    form :func:`glcm_props_from_sums` takes: sums in the order n, sum d^2,
    sum |d|, sum 1/(1+d^2), sum(i+j), sum(i^2+j^2), sum ij."""
    s = isums.double()
    sums_A = torch.cat([s[..., :3], hsum[..., None], s[..., 3:6]], dim=-1)
    n = s[..., 0]
    asm_A = s[..., 6] / torch.clamp(2.0 * n, min=1.0) ** 2
    return sums_A, asm_A


def glcm_props_from_sums(sums_A: torch.Tensor, asm_A: torch.Tensor,
                         compute_asm: bool) -> torch.Tensor:
    """(A, K, 7) pair sums + (A, K) ASM -> (6, K) angle-averaged props in
    GLCM_PROP_NAMES order; NaN for objects with no pairs at any angle."""
    if not compute_asm:
        asm_A = torch.full_like(asm_A, float("nan"))
    n_A = sums_A[:, :, 0]
    safe_n = torch.clamp(n_A, min=1.0)
    mu = (sums_A[:, :, 4] / 2.0) / safe_n
    var = (sums_A[:, :, 5] / 2.0) / safe_n - mu * mu
    cov = sums_A[:, :, 6] / safe_n - mu * mu
    pos = var > 1e-12
    corr = torch.where(pos, cov / torch.where(pos, var, torch.ones_like(var)),
                       torch.ones_like(var))  # skimage: 1 when std ~ 0
    energy_A = torch.sqrt(asm_A) if compute_asm else asm_A
    props_A = torch.stack([sums_A[:, :, 1] / safe_n,
                           sums_A[:, :, 2] / safe_n,
                           sums_A[:, :, 3] / safe_n,
                           asm_A, energy_A, corr], dim=1)   # (A, 6, K)
    has_pairs = n_A > 0
    n_ok = torch.clamp(has_pairs.sum(0).to(props_A.dtype), min=1.0)
    avg = torch.where(has_pairs[:, None, :], props_A,
                      torch.zeros_like(props_A)).sum(0) / n_ok[None, :]
    return torch.where(has_pairs.any(0)[None, :], avg,
                       torch.full_like(avg, float("nan")))


def segment_glcm_props_packed(image: torch.Tensor, labels: torch.Tensor,
                              num_segments: int, levels: int = 256,
                              distance: int = 2,
                              angles: Tuple[float, ...] = DEFAULT_ANGLES,
                              compute_asm: bool = True,
                              bands: Optional[Tuple[int, ...]] = None):
    """All props of all objects for every band: (GLCM_PROP_NAMES,
    (6, K, B) float32 numpy), one download. ``image`` is (H, W, C) float32
    and ``labels`` (H, W) int32 on the same device; on a CUDA device every
    band goes through the CUDA kernel."""
    levels = _check_levels(levels)
    image = image.to(torch.float32).contiguous()
    labels = labels.to(torch.int32).contiguous()
    band_ids = tuple(bands) if bands is not None else tuple(
        range(image.shape[2]))
    K = int(num_segments)
    offsets = angle_offsets(distance, tuple(angles))
    with telemetry.stage("glcm.prepass"):
        mins = bbox_minmax(image, labels, K, band_ids)
        bboxes = _bboxes_from_mins(mins)
    outs = []
    for i, b in enumerate(band_ids):
        mn = mins[:, 4 + 2 * i].contiguous()
        inv = quant_inv(-mins[:, 5 + 2 * i] - mn, levels).contiguous()
        isums, hsum = glcm_sums(labels, image, b, bboxes, mn, inv, levels,
                                offsets)
        sums_A, asm_A = sums_from_kernel(isums, hsum)
        outs.append(glcm_props_from_sums(sums_A, asm_A, compute_asm))
    packed = torch.stack(outs).to(torch.float32).cpu().numpy()  # (B, 6, K)
    return GLCM_PROP_NAMES, np.moveaxis(packed, 0, 2)


def segment_glcm_props(image: torch.Tensor, labels: torch.Tensor,
                       num_segments: int, levels: int = 256,
                       distance: int = 2,
                       angles: Tuple[float, ...] = DEFAULT_ANGLES,
                       compute_asm: bool = True,
                       bands: Optional[Tuple[int, ...]] = None
                       ) -> Dict[str, np.ndarray]:
    """{prop: (K, B) float32 numpy} of :func:`segment_glcm_props_packed`,
    one entry per name of GLCM_PROP_NAMES."""
    names, packed = segment_glcm_props_packed(
        image, labels, num_segments, levels=levels, distance=distance,
        angles=angles, compute_asm=compute_asm, bands=bands)
    return dict(zip(names, packed))


def glcm_table(image, labels, num_segments: int, device=None,
               **kw) -> Dict[str, np.ndarray]:
    """:func:`segment_glcm_props` of an (H, W, C) image and (H, W) labels,
    arrays or tensors, on the image's device when that is a tensor, else
    on ``device`` (the card when None); ``kw`` are its options."""
    dev = input_device(image, device)
    return segment_glcm_props(
        torch.as_tensor(image, dtype=torch.float32, device=dev),
        torch.as_tensor(labels, dtype=torch.int32, device=dev),
        num_segments, **kw)


def graycomatrix_reference(arr: np.ndarray, distance: int = 2,
                           angles: Sequence[float] = DEFAULT_ANGLES,
                           levels: int = 256) -> np.ndarray:
    """Host copy of ``skimage.feature.graycomatrix`` with ``symmetric=True,
    normed=True`` (the reference's call): (levels, levels, 1, A) float64.
    Only the ``strict_reference_glcm`` hatch of ``create_objects`` uses it."""
    arr = np.asarray(arr)
    H, W = arr.shape
    offs = angle_offsets(distance, tuple(angles))
    out = np.zeros((levels, levels, 1, len(offs)), np.float64)
    for a, (dr, dc) in enumerate(offs):
        r0, r1 = max(0, -dr), min(H, H - dr)
        c0, c1 = max(0, -dc), min(W, W - dc)
        if r1 <= r0 or c1 <= c0:
            continue
        i = arr[r0:r1, c0:c1].ravel().astype(np.int64)
        j = arr[r0 + dr:r1 + dr, c0 + dc:c1 + dc].ravel().astype(np.int64)
        P = np.zeros((levels, levels), np.float64)
        np.add.at(P, (i, j), 1.0)
        P = P + P.T  # symmetric
        s = P.sum()
        if s > 0:
            P = P / s  # normed
        out[:, :, 0, a] = P
    return out


def graycoprops_reference(P: np.ndarray, prop: str) -> np.ndarray:
    """``skimage.feature.graycoprops`` over a (L, L, 1, A) normalised GLCM:
    (1, A) float64."""
    L = P.shape[0]
    i = np.arange(L, dtype=np.float64)[:, None]
    j = np.arange(L, dtype=np.float64)[None, :]
    A = P.shape[3]
    out = np.zeros((1, A))
    for a in range(A):
        G = P[:, :, 0, a]
        if prop == "contrast":
            out[0, a] = (G * (i - j) ** 2).sum()
        elif prop == "dissimilarity":
            out[0, a] = (G * np.abs(i - j)).sum()
        elif prop == "homogeneity":
            out[0, a] = (G / (1.0 + (i - j) ** 2)).sum()
        elif prop == "ASM":
            out[0, a] = (G ** 2).sum()
        elif prop == "energy":
            out[0, a] = np.sqrt((G ** 2).sum())
        elif prop == "correlation":
            px = G.sum(axis=1)
            mu_i = (np.arange(L) * px).sum()
            var_i = ((np.arange(L) - mu_i) ** 2 * px).sum()
            py = G.sum(axis=0)
            mu_j = (np.arange(L) * py).sum()
            var_j = ((np.arange(L) - mu_j) ** 2 * py).sum()
            if var_i < 1e-15 or var_j < 1e-15:
                out[0, a] = 1.0
            else:
                out[0, a] = (((i - mu_i) * (j - mu_j) * G).sum()
                             / np.sqrt(var_i * var_j))
        else:
            raise ValueError(prop)
    return out
