"""A logical mesh of raster shards (counterpart of ``jax.sharding.Mesh``,
``make_mesh`` and ``shard_raster`` in ``obia_tpu/parallel/sharded.py``).

The JAX package runs the mosaic under ``shard_map`` over a 2-D device mesh
("ty", "tx"). Here one controller drives the same layout explicitly: a
:class:`Mesh` is a (ty, tx) grid of shards placed round-robin over the
devices it is given, a :class:`ShardedRaster` is the (ty, tx) grid of
contiguous local blocks of a padded raster plus its crop (H, W), and
:func:`psum`, :func:`pmin` and :func:`pmax` reduce per-shard tensors onto
the mesh's first device. Eight shards on ``["cuda:0"]`` put every shard on
one card (with no ``devices``, :func:`make_mesh` takes the card); eight on
``["cpu"]`` is the layout of the CPU tests. Every seam,
halo and reduction of the path runs the same in both.

``make_mesh(..., distributed=True)`` spreads the mesh over the initialised
process group (:mod:`.distributed`), one shard row a rank: rank r holds
and computes only the blocks of row r, and the reductions all-gather every
rank's per-shard parts and add them in shard order, so every rank gets the
one-process result bit for bit.
"""
from __future__ import annotations

import math
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device

DEFAULT_SHARDS = 8  # the 2 x 4 layout of the JAX package's mosaic mesh


class Mesh:
    """(ty, tx) shards over ``devices``; shard (i, j) lives on
    ``devices[(i * tx + j) % len(devices)]``. With ``distributed``, the
    shard rows are spread over the initialised process group, row r on
    rank r, and ``devices`` are this rank's."""

    def __init__(self, ty: int, tx: int, devices: Sequence,
                 distributed: bool = False):
        if ty < 1 or tx < 1:
            raise ValueError(f"mesh shape ({ty}, {tx}) must be positive")
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.ty, self.tx = int(ty), int(tx)
        self.devices = tuple(torch.device(d) for d in devices)
        self.rank, self.world = 0, 1
        if distributed:
            import torch.distributed as dist
            if not dist.is_initialized():
                raise RuntimeError(
                    "distributed=True needs an initialised process group: "
                    "call obia_tpu_torch.parallel.distributed.initialize "
                    "first")
            self.rank, self.world = dist.get_rank(), dist.get_world_size()
            if self.ty != self.world:
                raise ValueError(
                    f"a mesh over {self.world} ranks needs {self.world} "
                    f"shard rows, one a rank; got ({self.ty}, {self.tx})")

    @property
    def spans_ranks(self) -> bool:
        """True when other processes hold some of the shards."""
        return self.world > 1

    @property
    def shape(self) -> Tuple[int, int]:
        return self.ty, self.tx

    @property
    def home(self) -> torch.device:
        """Where reductions and replicated values live."""
        return self.devices[0]

    def device_of(self, i: int, j: int) -> torch.device:
        return self.devices[(i * self.tx + j) % len(self.devices)]

    def shards(self) -> Iterator[Tuple[int, int]]:
        """Coordinates of the shards this process holds, in row-major
        order: every shard, or row ``rank`` on a mesh that spans ranks."""
        for i in ((self.rank,) if self.spans_ranks else range(self.ty)):
            for j in range(self.tx):
                yield i, j


def make_mesh(n_shards: Optional[int] = None, devices=None,
              distributed: bool = False) -> Mesh:
    """Most-square (ty, tx) factorisation of ``n_shards`` (default 8) over
    ``devices`` (default the card, raising where there is none; ``["cpu"]``
    asks for the CPU). Shards never move off the devices given. With
    ``distributed``, shard row r goes to rank r of the process group,
    whose size must be ty."""
    n = int(n_shards or DEFAULT_SHARDS)
    if devices is None:
        devices = [resolve_device(None)]
    elif isinstance(devices, (str, torch.device)):
        devices = [devices]
    ty = int(math.sqrt(n))
    while n % ty:
        ty -= 1
    return Mesh(ty, n // ty, devices, distributed)


class ShardedRaster:
    """A padded (Hp, Wp[, C]) raster as a (ty, tx) grid of contiguous
    (h, w[, C]) blocks, block (i, j) covering rows i*h..(i+1)*h and columns
    j*w..(j+1)*w on ``mesh.device_of(i, j)``; ``crop_hw`` is the unpadded
    (H, W). Blocks of shards another rank holds are None."""

    def __init__(self, mesh: Mesh, blocks: List[List[torch.Tensor]],
                 crop_hw: Tuple[int, int]):
        self.mesh = mesh
        self.blocks = blocks
        self.crop_hw = tuple(crop_hw)

    def block(self, i: int, j: int) -> torch.Tensor:
        return self.blocks[i][j]

    @property
    def block_hw(self) -> Tuple[int, int]:
        i, j = next(self.mesh.shards())
        return tuple(self.blocks[i][j].shape[:2])

    @property
    def padded_hw(self) -> Tuple[int, int]:
        h, w = self.block_hw
        return self.mesh.ty * h, self.mesh.tx * w

    def origin(self, i: int, j: int) -> Tuple[int, int]:
        """Global (row, col) of block (i, j)'s first pixel."""
        h, w = self.block_hw
        return i * h, j * w

    def map(self, fn: Callable[[torch.Tensor, int, int], torch.Tensor]
            ) -> "ShardedRaster":
        """A raster of the same layout from ``fn(block, i, j)``."""
        return ShardedRaster(self.mesh, _held(
            self.mesh, lambda i, j: fn(self.blocks[i][j], i, j)),
            self.crop_hw)

    def gather(self) -> torch.Tensor:
        """The whole padded raster on the mesh's home device."""
        if self.mesh.spans_ranks:
            raise ValueError("gather() needs every block in one process; "
                             "this mesh spans ranks")
        home = self.mesh.home
        return torch.cat([torch.cat([b.to(home) for b in row], dim=1)
                          for row in self.blocks], dim=0)


def shard_raster(mesh: Mesh, arr, fill=0) -> Tuple[ShardedRaster,
                                                     Tuple[int, int]]:
    """Pad an (H, W[, C]) array or tensor with ``fill`` to a mesh-divisible
    shape and split it into the mesh's blocks, each placed on its shard's
    device. Returns (raster, (H, W))."""
    if isinstance(arr, np.ndarray) and not arr.flags.writeable:
        arr = arr.copy()  # torch does not wrap read-only numpy memory
    t = torch.as_tensor(arr)
    H, W = t.shape[:2]
    h = -(-H // mesh.ty)
    w = -(-W // mesh.tx)
    Hp, Wp = h * mesh.ty, w * mesh.tx
    if (Hp, Wp) != (H, W):
        full = torch.full((Hp, Wp) + tuple(t.shape[2:]), fill, dtype=t.dtype,
                          device=t.device)
        full[:H, :W] = t
        t = full
    blocks = _held(mesh, lambda i, j: t[i * h:(i + 1) * h,
                                         j * w:(j + 1) * w].to(
        mesh.device_of(i, j)).contiguous())
    return ShardedRaster(mesh, blocks, (H, W)), (H, W)


def _held(mesh: Mesh, make: Callable[[int, int], torch.Tensor]
          ) -> List[List[Optional[torch.Tensor]]]:
    """The (ty, tx) grid of ``make(i, j)`` over the shards this process
    holds, None elsewhere."""
    grid = [[None] * mesh.tx for _ in range(mesh.ty)]
    for i, j in mesh.shards():
        grid[i][j] = make(i, j)
    return grid


def all_parts(mesh: Mesh, parts: Sequence[torch.Tensor]
              ) -> List[torch.Tensor]:
    """Every shard's part in shard order on the home device, from the parts
    of the shards this process holds (``mesh.shards()`` order). On a mesh
    that spans ranks each rank's row of parts is all-gathered, so every
    rank gets the same list."""
    home = mesh.home
    parts = [p.to(home) for p in parts]
    if not mesh.spans_ranks:
        return parts
    import torch.distributed as dist
    row = torch.stack(parts)
    rows = [torch.empty_like(row) for _ in range(mesh.world)]
    dist.all_gather(rows, row)
    return [p for r in rows for p in r.unbind(0)]


def psum(mesh: Mesh, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum of per-shard tensors in shard order, on the mesh's home
    device."""
    parts = all_parts(mesh, parts)
    out = parts[0].clone()
    for p in parts[1:]:
        out += p
    return out


def pmin(mesh: Mesh, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    parts = all_parts(mesh, parts)
    out = parts[0].clone()
    for p in parts[1:]:
        out = torch.minimum(out, p)
    return out


def pmax(mesh: Mesh, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    parts = all_parts(mesh, parts)
    out = parts[0].clone()
    for p in parts[1:]:
        out = torch.maximum(out, p)
    return out
