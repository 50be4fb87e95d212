"""Halo exchange between the blocks of a :class:`~.mesh.ShardedRaster`
(port of ``obia_tpu/parallel/halo.py`` and of ``_halo2d`` in
``obia_tpu/parallel/sharded.py``).

On the TPU the strips travel by ``lax.ppermute``; here they are slices of
the neighbour blocks, copied to the receiving shard's device. The sharded
GLCM uses :func:`halo2d`, built from the same strip exchange, so that a
pixel pair across a seam is seen by the shard that owns its centre pixel.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .mesh import ShardedRaster


def _strip_pair(raster: ShardedRaster, axis: int, fill, d: int = 1):
    """(from_prev, from_next) d-pixel strips along ``axis`` (0: rows,
    1: columns) for every shard."""
    n = raster.mesh.shape[axis]

    def strip(step: int) -> ShardedRaster:
        def one(blk, i, j):
            k = ((i, j)[axis] + step) % n
            src = raster.block(k, j) if axis == 0 else raster.block(i, k)
            s = src.narrow(axis, src.shape[axis] - d if step < 0 else 0, d)
            if fill is not None and (i, j)[axis] == (0 if step < 0
                                                     else n - 1):
                s = torch.full_like(s, fill)
            return s.to(blk.device)
        return raster.map(one)

    return strip(-1), strip(1)


def exchange_halo_rows(raster: ShardedRaster, fill=None
                       ) -> Tuple[ShardedRaster, ShardedRaster]:
    """Every shard's (row from the previous shard along "ty", row from the
    next): the neighbour's last and first rows, each (1, w[, C]). As on the
    TPU ring, edge shards receive the wrapped-around strip unless ``fill``
    is given, which then fills the strips from beyond the mesh's edge."""
    return _strip_pair(raster, 0, fill)


def exchange_halo_cols(raster: ShardedRaster, fill=None
                       ) -> Tuple[ShardedRaster, ShardedRaster]:
    """The column counterpart of :func:`exchange_halo_rows` along "tx":
    strips (h, 1[, C])."""
    return _strip_pair(raster, 1, fill)


def halo2d(raster: ShardedRaster, d: int, fill) -> ShardedRaster:
    """Every block extended by ``d`` pixels of halo from its four mesh
    neighbours, (h + 2d, w + 2d[, C]) on the shard's device. Corners come
    from the diagonal neighbours through the two-stage row-then-column
    exchange; halos beyond the mesh's edge hold ``fill``."""
    h, w = raster.block_hw
    if not 0 < d <= min(h, w):
        raise ValueError(f"halo depth {d} must be in 1..{min(h, w)} for "
                         f"{h}x{w} blocks")
    top, bot = _strip_pair(raster, 0, fill, d)
    ext = raster.map(lambda b, i, j: torch.cat(
        [top.block(i, j), b, bot.block(i, j)], dim=0))
    lft, rgt = _strip_pair(ext, 1, fill, d)
    return ext.map(lambda b, i, j: torch.cat(
        [lft.block(i, j), b, rgt.block(i, j)], dim=1).contiguous())
