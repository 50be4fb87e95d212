"""Sharded segmentation and spectral statistics over a logical mesh (port
of ``obia_tpu/parallel/sharded.py``).

Every stage keeps the raster in its blocks and reduces only what is small:

* SLIC k-means (:func:`sharded_slic_assign`): replicated centres, per-shard
  assignment and float64 partial sums, summed over the mesh, ten
  iterations. Assignment needs no halo: a pixel's candidate centres depend
  only on its global coordinates.
* connectivity (:func:`sharded_ccl_merge`): exact CCL per shard, then the
  equivalences across seams from one-pixel boundary strips, resolved on the
  host by the shared native union-find, and a replicated LUT that numbers
  the components by global raster-order first occurrence.
* small-segment merge (:func:`sharded_merge_small`): per-shard sizes and
  label-adjacency edges plus the seam edges, then the single-device
  adoption sweeps (``ops/connectivity``) on the replicated side.
* spectral moments (:func:`sharded_spectral_moments`): each pass of
  ``ops/stats`` per shard, reduced over the mesh before the next.

Labels are numbered as on the single-device path, so a raster that divides
the mesh evenly gets the single-device labels.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.connectivity import (_merge_final_lut, _merge_lut_loop,
                                ccl_dense_labels, label_edges)
from ..ops.slic import (_grid_half, _grid_shape, _grid_step,
                        centers_from_seeds, seed_positions, slic_assign_block,
                        slic_update_sums64, update_centers)
from ..ops.stats import (SPECTRAL_PACK_ORDER, _moments_finalize,
                         moment_minmax, moment_pass1, moment_pass2,
                         moment_pixels)
from .mesh import Mesh, ShardedRaster, pmax, pmin, psum

_INF32 = int(np.iinfo(np.int32).max)


def gather_pixels(image: ShardedRaster, rows: torch.Tensor,
                  cols: torch.Tensor) -> torch.Tensor:
    """(len(rows), len(cols), C) pixels at global ``rows`` x ``cols`` of a
    sharded image, on the mesh's home device."""
    mesh = image.mesh
    h, w = image.block_hw
    C = image.block(0, 0).shape[2]
    home = mesh.home
    rows, cols = rows.to(home), cols.to(home)
    out = torch.empty((rows.numel(), cols.numel(), C),
                      dtype=image.block(0, 0).dtype, device=home)
    for i, j in mesh.shards():
        r0, c0 = image.origin(i, j)
        ri = torch.nonzero((rows >= r0) & (rows < r0 + h)).reshape(-1)
        ci = torch.nonzero((cols >= c0) & (cols < c0 + w)).reshape(-1)
        if ri.numel() == 0 or ci.numel() == 0:
            continue
        dev = mesh.device_of(i, j)
        blk = image.block(i, j)
        sel = blk[(rows[ri] - r0).to(dev)][:, (cols[ci] - c0).to(dev)]
        out[ri[:, None], ci[None, :]] = sel.to(home)
    return out


def sharded_slic_assign(mesh: Mesh, image: ShardedRaster, n_segments: int,
                        compactness: float = 10.0, max_num_iter: int = 10
                        ) -> Tuple[ShardedRaster, torch.Tensor]:
    """The SLIC k-means loop over a sharded (Hp, Wp, C) float32 image.
    Returns (int64 cluster ids in [0, gh*gw) per block, the final
    (gh, gw, C+2) centres on the home device)."""
    Hp, Wp = image.padded_hw
    gh, gw = _grid_shape(Hp, Wp, n_segments)
    K = gh * gw
    # the single-device path's integer grid step and seed offset, so
    # sharded labels are the single-device labels
    step = _grid_step(Hp, Wp, n_segments)
    ratio = (compactness / step) ** 2
    cy0, cx0, cyi, cxi = seed_positions(
        Hp, Wp, gh, gw, step, _grid_half(Hp, Wp, n_segments), mesh.home)
    centers = centers_from_seeds(gather_pixels(image, cyi, cxi), cy0, cx0)

    def assign(blk, i, j, c):
        valid = torch.ones(blk.shape[:2], dtype=torch.bool, device=blk.device)
        return slic_assign_block(blk, valid, c.to(blk.device), gh, gw,
                                 ratio, origin=image.origin(i, j),
                                 full_hw=(Hp, Wp))

    C = image.block(0, 0).shape[2]
    for _ in range(max_num_iter):
        parts = []
        for i, j in mesh.shards():
            blk = image.block(i, j)
            parts.append(slic_update_sums64(blk, assign(blk, i, j, centers),
                                            K, image.origin(i, j)))
        out = psum(mesh, parts).float()    # float64 sums, rounded once
        centers = update_centers(out[:, :C + 2], out[:, C + 2], centers)
    return image.map(lambda blk, i, j: assign(blk, i, j, centers)), centers


def _seam_pairs(bot_a, top_b, lab_bot_a, lab_top_b):
    """Equal-cluster pixel pairs across one seam (host, numpy)."""
    same = (lab_bot_a == lab_top_b) & (lab_bot_a >= 0) \
        & (bot_a >= 0) & (top_b >= 0)
    return bot_a[same], top_b[same]


def _strips(raster: ShardedRaster):
    """The four one-pixel boundary strips of every block on the host, as
    the JAX package's out_specs lay them out: top and bottom rows (ty, Wp),
    left and right columns (Hp, tx)."""
    mesh = raster.mesh

    def rows(pick):
        return np.concatenate([
            np.concatenate([pick(raster.block(i, j)).cpu().numpy()
                            for j in range(mesh.tx)], axis=1)
            for i in range(mesh.ty)], axis=0)

    return (rows(lambda b: b[:1, :]), rows(lambda b: b[-1:, :]),
            rows(lambda b: b[:, :1]), rows(lambda b: b[:, -1:]))


def sharded_ccl_merge(mesh: Mesh, labels: ShardedRaster,
                      crop_hw: Tuple[int, int], k_max: Optional[int] = None,
                      n_segments: Optional[int] = None
                      ) -> Tuple[ShardedRaster, int]:
    """Connected components of a sharded cluster-label raster without
    gathering it: exact CCL and a dense relabel per shard, the pieces'
    equivalences across seams from the boundary strips, the native
    union-find on the host, then a replicated LUT that relabels every shard
    to global raster-order first-occurrence dense labels.

    labels: cluster ids per block; pixels outside ``crop_hw`` become -1.
    k_max: per-shard piece id stride (default sized from ``n_segments``);
    a shard with more pieces retries with twice its count.
    Returns (int32 dense labels 0..K-1 / -1 per block, K).
    """
    ty, tx = mesh.shape
    n_shards = ty * tx
    h, w = labels.block_hw
    H, W = crop_hw
    if k_max is None:
        base = (n_segments or 1024) * 4 // max(n_shards, 1)
        k_max = max(512, base + 512)

    pieces, cleaned = [], []
    for i, j in mesh.shards():
        blk = labels.block(i, j)
        r0, c0 = labels.origin(i, j)
        rr = torch.arange(h, device=blk.device)[:, None] + r0
        cc = torch.arange(w, device=blk.device)[None, :] + c0
        lab = torch.where((rr < H) & (cc < W) & (blk >= 0), blk.long(), -1)
        piece, k = ccl_dense_labels(lab)
        pieces.append((piece.long(), k, rr, cc))
        cleaned.append(lab)
    k_big = max(p[1] for p in pieces)
    if k_big > k_max:
        # heavy fragmentation: retry the same pieces under twice the count
        k_max = 2 * k_big
    return _glue(mesh, labels, pieces, cleaned, W, k_max)


def _glue(mesh: Mesh, labels: ShardedRaster, pieces, cleaned, W: int,
          k_max: int) -> Tuple[ShardedRaster, int]:
    """Global ids from the per-shard pieces (see :func:`sharded_ccl_merge`)."""
    ty, tx = mesh.shape
    n_ids = ty * tx * k_max
    gids, min_g = [], []
    for sid, (piece, _, rr, cc) in enumerate(pieces):
        valid = piece >= 0
        # raster-order key: the minimum global linear index of each piece
        key = torch.full((k_max + 1,), _INF32, dtype=torch.int64,
                         device=piece.device)
        key.scatter_reduce_(0, torch.where(valid, piece, k_max).reshape(-1),
                            (rr * W + cc).expand_as(piece).reshape(-1),
                            "amin")
        min_g.append(key[:k_max].cpu().numpy())
        gids.append(torch.where(valid, piece + sid * k_max, -1))
    gid = ShardedRaster(mesh, [gids[i * tx:(i + 1) * tx] for i in range(ty)],
                        labels.crop_hw)
    lab = ShardedRaster(mesh, [cleaned[i * tx:(i + 1) * tx]
                               for i in range(ty)], labels.crop_hw)
    g_top, g_bot, g_lft, g_rgt = _strips(gid)
    l_top, l_bot, l_lft, l_rgt = _strips(lab)
    pa_v, pb_v = _seam_pairs(g_bot[:-1], g_top[1:], l_bot[:-1], l_top[1:])
    pa_h, pb_h = _seam_pairs(g_rgt[:, :-1].T, g_lft[:, 1:].T,
                             l_rgt[:, :-1].T, l_lft[:, 1:].T)
    pa = np.concatenate([pa_v.reshape(-1), pa_h.reshape(-1)])
    pb = np.concatenate([pb_v.reshape(-1), pb_h.reshape(-1)])

    from obia_tpu import native
    identity = np.arange(n_ids, dtype=np.int64)[None, :]
    roots = native.resolve_components(identity, pa.astype(np.int64),
                                      pb.astype(np.int64))[0]
    # component key = min global first-occurrence index over the class
    min_g_flat = np.concatenate(min_g).astype(np.int64)
    keys = np.full(n_ids, _INF32, np.int64)
    np.minimum.at(keys, roots, min_g_flat)
    used_root = np.zeros(n_ids, bool)
    used_root[roots[min_g_flat < _INF32]] = True
    order = np.argsort(np.where(used_root, keys, _INF32), kind="stable")
    rank = np.full(n_ids, -1, np.int32)
    K = int(used_root.sum())
    rank[order[:K]] = np.arange(K, dtype=np.int32)
    final_lut = np.where(used_root[roots], rank[roots], -1).astype(np.int64)
    return apply_lut(gid, torch.as_tensor(final_lut)), K


def apply_lut(raster: ShardedRaster, lut: torch.Tensor) -> ShardedRaster:
    """int32 ``lut[id]`` of every block, -1 where id < 0 (the LUT is
    replicated to each shard's device)."""
    luts = {}

    def one(blk, i, j):
        dev = blk.device
        if dev not in luts:
            luts[dev] = lut.to(dev)
        ids = blk.long()
        return torch.where(ids >= 0, luts[dev][ids.clamp(min=0)],
                           -1).to(torch.int32)

    return raster.map(one)


def sharded_merge_small(mesh: Mesh, labels: ShardedRaster, num_labels: int,
                        min_size: int, max_size: int, max_iters: int = 512
                        ) -> Tuple[ShardedRaster, int]:
    """Small-segment merge of sharded dense labels: per-shard sizes
    (summed) and label-adjacency edges, plus the edges across seams from
    the boundary strips, then the adoption sweeps and dense re-compaction
    of :func:`obia_tpu_torch.ops.connectivity.merge_small_device` on the
    home device. An edge seen by two shards is harmless: the sweeps reduce
    with min. Returns the single-device result for the same labels."""
    K = max(int(num_labels), 1)
    home = mesh.home
    sizes, ea, eb = [], [], []
    for i, j in mesh.shards():
        blk = labels.block(i, j).long()
        sizes.append(torch.bincount(blk[blk >= 0], minlength=K))
        a, b = label_edges(blk, K)
        ea.append(a.to(home))
        eb.append(b.to(home))
    sizes0 = psum(mesh, sizes)

    s_top, s_bot, s_lft, s_rgt = _strips(labels)
    for a, b in ((s_bot[:-1], s_top[1:]), (s_rgt[:, :-1], s_lft[:, 1:])):
        m = (a != b) & (a >= 0) & (b >= 0)
        ea.append(torch.as_tensor(np.minimum(a[m], b[m]), dtype=torch.int64,
                                  device=home))
        eb.append(torch.as_tensor(np.maximum(a[m], b[m]), dtype=torch.int64,
                                  device=home))
    lut = _merge_lut_loop(torch.cat(ea), torch.cat(eb), sizes0,
                          int(min_size), int(max_size), K, max_iters)
    final, k = _merge_final_lut(lut, sizes0, K)
    return apply_lut(labels, final), k


def sharded_spectral_moments(mesh: Mesh, image: ShardedRaster,
                             labels: ShardedRaster, num_segments: int,
                             packed: bool = False):
    """Spectral moments ({stat: (K, C)} on the home device) of a sharded
    image: the single-device passes per shard, each reduced over the mesh
    (sum, then min and max) before the next. ``packed=True`` returns
    (SPECTRAL_PACK_ORDER, (7, K, C) float32 numpy), one download."""
    K = int(num_segments)
    pix = {(i, j): moment_pixels(image.block(i, j), labels.block(i, j), K)
           for i, j in mesh.shards()}
    s1c = psum(mesh, [moment_pass1(p, K) for p in pix.values()])
    cnt1 = s1c[:, 0]
    s1 = s1c[:, 1:]
    mean = s1 / torch.clamp(cnt1[:, None], min=1.0)
    p2 = psum(mesh, [moment_pass2(p, mean.to(p[0].device), K)
                     for p in pix.values()])
    mm = [moment_minmax(p, K) for p in pix.values()]
    xmin = pmin(mesh, [m[0] for m in mm])
    xmax = pmax(mesh, [m[1] for m in mm])
    out = _moments_finalize(cnt1, s1, p2, xmin, xmax,
                            image.block(0, 0).shape[2])
    if packed:
        stack = torch.stack([out[k] for k in SPECTRAL_PACK_ORDER])
        return SPECTRAL_PACK_ORDER, stack.cpu().numpy()
    return out


def shard_presence(mesh: Mesh, labels: ShardedRaster, num_segments: int):
    """Per shard, the (K,) bool mask of objects with a pixel on it."""
    K = int(num_segments)
    out = {}
    for i, j in mesh.shards():
        blk = labels.block(i, j).reshape(-1).long()
        out[(i, j)] = torch.bincount(blk[blk >= 0], minlength=K)[:K] > 0
    return out


def count_shard_spanning(mesh: Mesh, labels: ShardedRaster,
                         num_segments: int):
    """(n_multi, (K,) bool numpy mask) of the objects present on more than
    one shard."""
    present = shard_presence(mesh, labels, num_segments)
    n_sh = psum(mesh, [p.to(torch.int32) for p in present.values()])
    multi = (n_sh > 1).cpu().numpy()
    return int(multi.sum()), multi
