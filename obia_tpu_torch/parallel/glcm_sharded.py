"""Per-object GLCM texture of a sharded raster (port of
``obia_tpu/parallel/glcm_sharded.py``, the sharded Pallas route).

1. A pre-pass (:func:`glcm_prepass`) computes per shard, in global
   coordinates, every object's bounding box and every band's quantiser
   bounds (``ops/glcm.bbox_minmax``), reduced with a minimum over the mesh,
   and the seam spanners: the objects present on more than one shard.
2. Each shard's label and image blocks get a ``distance``-deep halo from
   their neighbours (:func:`obia_tpu_torch.parallel.halo.halo2d`; -1
   labels beyond the mesh's edge). The boxes handed to the sums kernel are
   clipped to the shard's own pixels (:func:`_clip_local`) and shifted into
   the halo's coordinates, so a pair counts on the shard that owns its
   centre pixel and a pair across a seam is neither lost nor counted twice.
3. Per band and shard, ``glcm_sums`` gives the seven pair sums and the
   local sum (C + C^T)^2, summed over the shards. That squared sum is exact
   for an object on one shard; for a seam spanner it is not a sum of
   per-shard values, so one ``glcm_spanner_hist`` launch a band counts every
   spanner's pairs over all its pieces, on every shard, into one table and
   writes that table's exact int64 sum (C + C^T)^2 over the spanner's
   entry. The spanners' pieces are a CSR list (:func:`spanner_groups`),
   built once per call.
4. ``sums_from_kernel`` and ``glcm_props_from_sums`` finish, as on one
   device.

There are no job tables, buckets or slot caps: those are the TPU's layout.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import telemetry
from ..ops.glcm import (DEFAULT_ANGLES, GLCM_PROP_NAMES, _bboxes_from_mins,
                        _check_levels, angle_offsets, bbox_minmax,
                        glcm_props_from_sums, quant_inv, sums_from_kernel)
from ..ops.glcm_kernel import (glcm_spanner_hist, glcm_sums,
                               spanner_pieces, symmetric_sumsq)
from .halo import halo2d
from .mesh import Mesh, ShardedRaster, pmin, psum
from .sharded import shard_presence

_EMPTY_BOX = (1, 0, 1, 0)  # rmin > rmax marks a box with no pixel


def glcm_prepass(mesh: Mesh, image: ShardedRaster, labels: ShardedRaster,
                 num_segments: int, band_ids: Sequence[int]):
    """(mins (K, 4 + 2B) float32 as ``bbox_minmax`` gives them for the
    whole raster, multi (K,) bool seam-spanner mask, {shard: (K,) bool
    presence}), the first two on the home device."""
    K = int(num_segments)
    mins = pmin(mesh, [bbox_minmax(image.block(i, j), labels.block(i, j), K,
                                   band_ids, origin=labels.origin(i, j))
                       for i, j in mesh.shards()])
    present = shard_presence(mesh, labels, K)
    n_sh = psum(mesh, [p.to(torch.int32) for p in present.values()])
    return mins, n_sh > 1, present


def _clip_local(bboxes: torch.Tensor, r0: int, c0: int, h: int, w: int
                ) -> torch.Tensor:
    """Global (K, 4) boxes -> the boxes of their pixels on the (h, w) block
    at (r0, c0), in the block's coordinates; (1, 0, 1, 0) where a box misses
    the block."""
    b = bboxes.long()
    loc = torch.stack([(b[:, 0] - r0).clamp(min=0),
                       (b[:, 1] - r0).clamp(max=h - 1),
                       (b[:, 2] - c0).clamp(min=0),
                       (b[:, 3] - c0).clamp(max=w - 1)], dim=1)
    bad = ((b[:, 0] > b[:, 1]) | (loc[:, 0] > loc[:, 1])
           | (loc[:, 2] > loc[:, 3]))
    loc[bad] = torch.tensor(_EMPTY_BOX, dtype=loc.dtype, device=loc.device)
    return loc.to(torch.int32)


def shard_inputs(mesh: Mesh, image: ShardedRaster, labels: ShardedRaster,
                 bboxes: torch.Tensor, spanners: torch.Tensor, present,
                 d: int):
    """Per shard (i, j), what its GLCM kernels take: (labels (h+2d, w+2d)
    int32 and image (h+2d, w+2d, C) float32 with a d-pixel halo, (K, 4)
    int32 boxes of each object's pixels on the shard in halo coordinates,
    (M_s,) int32 ids of the seam spanners (``spanners``: (K,) bool) present
    on the shard, (M_s, 4) their boxes), on the shard's device."""
    h, w = labels.block_hw
    home = mesh.home
    lab_h = halo2d(labels, d, -1)
    img_h = halo2d(image, d, 0.0)
    out = {}
    for i, j in mesh.shards():
        dev = mesh.device_of(i, j)
        loc = _clip_local(bboxes, *labels.origin(i, j), h, w)
        loc = torch.where(loc[:, :1] <= loc[:, 1:2], loc + d, loc)
        objs = torch.nonzero(spanners & present[(i, j)].to(home)).reshape(-1)
        out[(i, j)] = (lab_h.block(i, j).to(torch.int32),
                       img_h.block(i, j).to(torch.float32),
                       loc.to(dev), objs.to(torch.int32).to(dev),
                       loc[objs].contiguous().to(dev))
    return out


def spanner_groups(mesh: Mesh, shards, spanners: torch.Tensor):
    """Per device that holds shards: (its shards' halo'd label blocks, their
    image blocks, the CSR list of the pieces on them of every seam spanner,
    ``spanners`` being the (M,) ascending spanner ids), from what
    :func:`shard_inputs` gives."""
    by_dev: Dict[torch.device, list] = {}
    for (i, j), v in shards.items():
        by_dev.setdefault(mesh.device_of(i, j), []).append(v)
    return [([v[0] for v in vs], [v[1] for v in vs],
             spanner_pieces(spanners.to(dev), [v[3] for v in vs],
                            [v[4] for v in vs]))
            for dev, vs in by_dev.items()]


def spanner_sums(groups, band: int, mn: torch.Tensor, inv: torch.Tensor,
                 levels: int, offsets, isums: torch.Tensor) -> None:
    """Every seam spanner's exact sum (C + C^T)^2 of one band, written into
    ``isums[:, spanners, 6]``. Where one device holds every shard, one
    launch gives the sums and stores no table; where several do, each
    launches on its own shards and the tables are summed and squared on
    ``isums``' device."""
    if len(groups) == 1 and groups[0][0][0].device == isums.device:
        labs, imgs, work = groups[0]
        _, sumsq = glcm_spanner_hist(labs, imgs, band, work, mn, inv, levels,
                                     offsets, tables=False)
    else:
        total = 0
        for labs, imgs, work in groups:
            dev = labs[0].device
            tables, _ = glcm_spanner_hist(labs, imgs, band, work, mn.to(dev),
                                          inv.to(dev), levels, offsets)
            total = total + tables.to(isums.device)
        sumsq = symmetric_sumsq(total, len(offsets), levels)
    isums[:, groups[0][2].ids.to(isums.device).long(), 6] = sumsq


def sharded_glcm_sums(mesh: Mesh, image: ShardedRaster,
                      labels: ShardedRaster, num_segments: int,
                      levels: int = 256, distance: int = 2,
                      angles: Optional[Sequence[float]] = None,
                      compute_asm: bool = True,
                      bands: Optional[Tuple[int, ...]] = None):
    """Per band, (isums (A, K, 7) int64, hsum (A, K) float64) on the home
    device: what ``glcm_sums`` gives for the whole raster, seam spanners'
    sum (C + C^T)^2 included (left as the per-shard sum when
    ``compute_asm`` is off)."""
    levels = _check_levels(levels)
    angles = tuple(angles) if angles is not None else DEFAULT_ANGLES
    offsets = angle_offsets(distance, angles)
    A, L = len(offsets), levels
    d = max([1] + [max(abs(dr), abs(dc)) for dr, dc in offsets])
    band_ids = (tuple(bands) if bands is not None
                else tuple(range(image.block(0, 0).shape[2])))
    K = int(num_segments)
    home = mesh.home

    with telemetry.stage("glcm.prepass"):
        mins, multi, present = glcm_prepass(mesh, image, labels, K,
                                            band_ids)
        bboxes = _bboxes_from_mins(mins)
        spanners = torch.nonzero(multi).reshape(-1)
        M = int(spanners.numel()) if compute_asm else 0

    with telemetry.stage("glcm.halo"):
        shards = shard_inputs(mesh, image, labels, bboxes,
                              multi if M else torch.zeros_like(multi),
                              present, d)
        groups = spanner_groups(mesh, shards, spanners) if M else []

    out = []
    for bi, b in enumerate(band_ids):
        mn = mins[:, 4 + 2 * bi].contiguous()
        inv = quant_inv(-mins[:, 5 + 2 * bi] - mn, L).contiguous()
        isums = torch.zeros((A, K, 7), dtype=torch.int64, device=home)
        hsum = torch.zeros((A, K), dtype=torch.float64, device=home)
        for lab_h, img_h, loc, _, _ in shards.values():
            mn_s, inv_s = mn.to(lab_h.device), inv.to(lab_h.device)
            with telemetry.stage("glcm.sums"):
                s_i, s_h = glcm_sums(lab_h, img_h, b, loc, mn_s, inv_s, L,
                                     offsets)
                isums += s_i.to(home)
                hsum += s_h.to(home)
        if groups:
            with telemetry.stage("glcm.hist"):
                spanner_sums(groups, b, mn, inv, L, offsets, isums)
        out.append((isums, hsum))
    return out


def sharded_glcm_props(mesh: Mesh, image: ShardedRaster,
                       labels: ShardedRaster, num_segments: int,
                       levels: int = 256, distance: int = 2,
                       angles: Optional[Sequence[float]] = None,
                       compute_asm: bool = True,
                       bands: Optional[Tuple[int, ...]] = None,
                       packed: bool = False):
    """GLCM props of every object of a sharded raster. ``packed=True``
    returns (GLCM_PROP_NAMES, (6, K, B) float32 numpy) as
    ``ops/glcm.segment_glcm_props_packed`` does; otherwise {prop: (K, B)
    float32 numpy}, as the JAX package's dict gives them."""
    per_band = sharded_glcm_sums(mesh, image, labels, num_segments,
                                 levels=levels, distance=distance,
                                 angles=angles, compute_asm=compute_asm,
                                 bands=bands)
    props = torch.stack([glcm_props_from_sums(*sums_from_kernel(i, h),
                                              compute_asm)
                         for i, h in per_band])
    arr = props.to(torch.float32).cpu().numpy()            # (B, 6, K)
    if packed:
        return GLCM_PROP_NAMES, np.moveaxis(arr, 0, 2)
    out: Dict[str, np.ndarray] = {name: arr[:, p, :].T
                                  for p, name in enumerate(GLCM_PROP_NAMES)}
    return out
