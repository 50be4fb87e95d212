"""SLIC's k-means pass: the hand-written CUDA kernel (``csrc/slic.cu``).

:func:`slic_pass` is one launch, one pass over the pixels of an (h, w)
block whose first pixel is the global pixel ``origin`` of an image of
``full_hw``. Each pixel takes the centre with the least D^2 among the 9
clamped grid neighbours of its own cell, or -1 where ``valid`` is false, as
``ops/slic.slic_assign_reference`` (the plain twin) computes it; the pass
writes those int64 labels, or adds each assigned pixel's channels, row,
column and 1 to its centre's (K, C + 3) float64 sums, as
``ops/slic.slic_update_sums64`` computes them, or both, as the caller asks.
It replaces no Pallas kernel: ``obia_tpu/ops/slic.py`` is plain ``jnp``.

Given the same centres the labels are bitwise the twin's. The sums are
added in another order than the twin's (atomics), so a float64 sum may
differ from the twin's in its last bits, and its float32 rounding (what the
centre update reads) almost never. ``ops/slic`` routes by device: a CUDA
tensor takes this kernel, every other tensor the twin. Each launch counts
``kernel.slic_pass`` in the telemetry; the twin never counts.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import telemetry

WARPS = 8                 # warps a block (SLIC_WARPS in the kernel)
# (rows, columns) of a block's tile, tallest first; the columns are a
# multiple of 32, a warp's row segment
TILES = ((32, 128), (16, 128), (8, 128), (4, 128), (2, 128), (1, 128),
         (1, 64), (1, 32))
SMEM_BUDGET = 47104       # dynamic shared bytes a block takes without
                          # opting in (SLIC_SMEM_LIMIT in the kernel)


def _f32(x: float) -> float:
    """``x`` rounded once to float32, as PyTorch rounds a Python scalar
    that meets a float32 tensor."""
    return float(np.float32(x))


def window_cap(t: int, n: int, N: int) -> int:
    """The most grid cells (of ``n`` over ``N`` pixels) that ``t``
    consecutive rows (or columns) and the ring around them span: the cells
    floor(g n / N) of t consecutive g span at most floor((t - 1) n / N) + 2,
    and the ring adds 2."""
    return min(n, (t - 1) * n // N + 4)


def window_bytes(cells: int, C: int, sums: bool, slico: bool) -> int:
    """Shared bytes of a window of ``cells`` centres: their float64 bins
    (C + 3 values) where the pass adds sums, their C + 2 float32 values,
    and SLICO's scale."""
    return cells * ((C + 3) * 8 * sums + (C + 2) * 4 + 4 * slico)


def tile_plan(H: int, W: int, gh: int, gw: int, C: int, sums: bool,
              slico: bool) -> Tuple[int, int, int, int]:
    """``(th, tw, nr_cap, nc_cap)`` of a pass over an H x W image's gh x gw
    grid: the first of :data:`TILES` whose window (at most nr_cap x nc_cap
    centres) fits :data:`SMEM_BUDGET`; where none does, the largest tile
    with the window in global memory (caps 0)."""
    for th, tw in TILES:
        nr, nc = window_cap(th, gh, H), window_cap(tw, gw, W)
        if window_bytes(nr * nc, C, sums, slico) <= SMEM_BUDGET:
            return th, tw, nr, nc
    return TILES[0][0], TILES[0][1], 0, 0


def _check(t: torch.Tensor, shape, dtype, name: str, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, img on {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def slic_pass(img: torch.Tensor, valid: torch.Tensor, centers: torch.Tensor,
              gh: int, gw: int, ratio: float,
              inv_max_dc: Optional[torch.Tensor] = None, step: float = 1.0,
              spacing: Optional[Tuple[float, float]] = None,
              origin: Tuple[int, int] = (0, 0),
              full_hw: Optional[Tuple[int, int]] = None,
              labels: bool = True, sums: bool = False
              ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """One pass of the kernel: ((h, w) int64 labels in [0, gh*gw), -1 where
    not valid, or None; (gh*gw, C+3) float64 sums of channels, row, column
    and count, or None), as ``labels`` and ``sums`` ask.

    img (h, w, C) float32, valid (h, w) bool, centers (gh, gw, C+2)
    float32 and SLICO's inv_max_dc (gh, gw) float32, all contiguous on one
    CUDA device. Launches on the current stream and never synchronises."""
    if img.device.type != "cuda":
        raise ValueError(f"slic_pass: unsupported device {img.device} (the "
                         f"plain twin runs everywhere else)")
    if not (labels or sums):
        raise ValueError("slic_pass: ask for labels, sums or both")
    if img.dim() != 3:
        raise ValueError(f"img: expected (h, w, C), got {tuple(img.shape)}")
    h, w, C = img.shape
    _check(img, (h, w, C), torch.float32, "img", img.device)
    _check(valid, (h, w), torch.bool, "valid", img.device)
    _check(centers, (gh, gw, C + 2), torch.float32, "centers", img.device)
    if inv_max_dc is not None:
        _check(inv_max_dc, (gh, gw), torch.float32, "inv_max_dc", img.device)
    H, W = full_hw if full_hw is not None else (h, w)
    K = gh * gw
    lab = (torch.empty((h, w), dtype=torch.int64, device=img.device)
           if labels else None)
    out = (torch.zeros((K, C + 3), dtype=torch.float64, device=img.device)
           if sums else None)
    if h * w == 0:
        return lab, out
    th, tw, nr, nc = tile_plan(H, W, gh, gw, C, sums,
                               inv_max_dc is not None)
    sy, sx = spacing if spacing is not None else (1.0, 1.0)
    from .. import _build
    lib = _build.load()
    with torch.cuda.device(img.device):
        status = lib.obia_slic_pass(
            img.data_ptr(), valid.data_ptr(), centers.data_ptr(),
            inv_max_dc.data_ptr() if inv_max_dc is not None else None,
            C, h, w, int(origin[0]), int(origin[1]), H, W, gh, gw,
            _f32(ratio), _f32(1.0 / (step * step)), _f32(sy), _f32(sx),
            th, tw, nr, nc, lab.data_ptr() if labels else None,
            out.data_ptr() if sums else None,
            torch.cuda.current_stream(img.device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"SLIC pass kernel launch failed: CUDA error "
                           f"{status}")
    telemetry.count("kernel.slic_pass")  # the twin never counts
    return lab, out
