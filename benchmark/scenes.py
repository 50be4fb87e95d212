"""The benchmark's scenes, made on the device from a seed.

The recipe is ``obia_tpu_torch/bench.py``'s ``build_scene`` and
``config4_scene`` (frozen here, so that a change to the program cannot move
the inputs), rewritten in torch so that a 100 MP scene takes seconds on the
card instead of the host's tens of seconds:

- four smooth bands of the pixel's (row, column) in a mosaic:
  ``sin(y/97) + cos(x/131)``, ``sin((y+x)/151)``, ``cos(y/71) sin(x/113)``
  and a 256-pixel checkerboard of five levels, plus N(0, 0.05) noise;
- the scene's own minimum and maximum scaled to 0..255 and truncated to
  uint8, as ``build_scene`` does;
- 3 bands: the first three; 8 bands: the four, then band ``i % 4`` rolled
  by ``17 (i + 1)`` pixels along axis ``i % 2`` for i = 0..3, as
  ``config4_scene`` does.

A tile of a larger mosaic is the same recipe with its top-left pixel at
``origin``. The noise comes from a ``torch.Generator`` on ``device`` seeded
with the scene's seed, so one seed gives the same scene on one kind of
device, and another seed a different one.
"""
from __future__ import annotations

import numpy as np
import torch


def scene_seeds(seed: int, n: int, stream: int = 0) -> list:
    """``n`` scene seeds, each under 2**62, drawn from the run's ``seed``
    (any whole number) and a stream number, so that the pool, the warm
    scene and the classifiers draw apart."""
    rng = np.random.default_rng([int(seed) % (1 << 64), stream])
    return [int(s) for s in rng.integers(0, 1 << 62, n)]


def make_scene(side: int, bands: int, seed: int, device,
               origin=(0, 0)) -> torch.Tensor:
    """(side, side, bands) uint8 scene on ``device`` (bands 3 or 8)."""
    if bands not in (3, 8):
        raise ValueError(f"the recipe makes 3 or 8 bands, not {bands}")
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(int(seed))
    oy, ox = int(origin[0]), int(origin[1])
    yy = (torch.arange(side, device=dev, dtype=torch.float32) + oy)[:, None]
    xx = (torch.arange(side, device=dev, dtype=torch.float32) + ox)[None, :]
    cells = ((torch.arange(side, device=dev) + oy)[:, None] // 256
             + (torch.arange(side, device=dev) + ox)[None, :] // 256)
    base = [torch.sin(yy / 97.0) + torch.cos(xx / 131.0),
            torch.sin((yy + xx) / 151.0).expand(side, side),
            torch.cos(yy / 71.0) * torch.sin(xx / 113.0),
            (cells % 5).to(torch.float32) / 4.0]
    c = 3 if bands == 3 else 4
    arr = torch.stack([b.expand(side, side) for b in base[:c]], dim=-1)
    arr = arr + 0.05 * torch.randn((side, side, c), generator=g, device=dev)
    lo, hi = arr.amin(), arr.amax()
    u8 = (255.0 * (arr - lo) / (hi - lo)).to(torch.uint8)
    del arr
    if bands == 3:
        return u8
    more = [torch.roll(u8[..., i % 4], 17 * (i + 1), dims=i % 2)
            for i in range(4)]
    return torch.cat([u8, torch.stack(more, dim=-1)], dim=-1)


def tile_origins(seed: int, n: int, side: int, mosaic: int) -> list:
    """``n`` distinct top-left pixels of ``side``-pixel tiles on the
    ``side``-aligned grid of a ``mosaic``-pixel square, drawn from
    ``seed``."""
    per_row = mosaic // side
    if n > per_row * per_row:
        raise ValueError(f"{n} tiles do not fit a {mosaic}-pixel mosaic")
    rng = np.random.default_rng([int(seed) % (1 << 64), 7])
    cells = rng.choice(per_row * per_row, n, replace=False)
    return [(int(c // per_row) * side, int(c % per_row) * side)
            for c in cells]


def make_pool(traffic: dict, bands: int, seed: int, device) -> list:
    """The cell's scenes of ``bands`` bands as host uint8 arrays, made on
    ``device``: the warm scene first, then the pool. ``traffic["scene"]``
    gives ``side``, ``pool`` and, for tiles of a mosaic, ``mosaic``."""
    sc = traffic["scene"]
    side, n = int(sc["side"]), int(sc["pool"])
    seeds = scene_seeds(seed, n + 1)
    if "mosaic" in sc:
        origins = tile_origins(seed, n + 1, side, int(sc["mosaic"]))
    else:
        origins = [(0, 0)] * (n + 1)
    out = []
    for s, o in zip(seeds, origins):
        out.append(make_scene(side, bands, s, device, o).cpu().numpy())
    return out
