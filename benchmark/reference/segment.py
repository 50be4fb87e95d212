"""Segmentation semantics in plain torch: per-band min-max normalisation,
sRGB to CIELAB, SLIC with connectivity and the small-segment merge, and
quickshift with connected components of its roots.

SLIC (grid seeds of skimage's ``regular_grid``, the 3 x 3 cell candidate
set, 10 iterations, centres as float64 sums rounded once) and the merge
(adoption sweeps over the label-adjacency edges) are frozen copies of the
program's plain versions as of this benchmark (``obia_tpu_torch/ops/slic.py``,
``ops/connectivity.py``), because their labels are the configuration's
semantics down to ties. The connected components, the tree flattening and
the disk of parent offsets are written here afresh. Labels are numbered
0..K-1 by raster-order first occurrence.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import REFERENCE, Precision

_OFFSETS9 = tuple((di, dj) for di in (-1, 0, 1) for dj in (-1, 0, 1))
_M = ((0.412453, 0.357580, 0.180423),
      (0.212671, 0.715160, 0.072169),
      (0.019334, 0.119193, 0.950227))
_WHITE = (0.95047, 1.0, 1.08883)


def normalise(scene: torch.Tensor, bands, p: Precision = REFERENCE
              ) -> torch.Tensor:
    """(H, W, len(bands)) each band min-max scaled to [0, 1] (a constant
    band to 0) from the uint8 scene."""
    sel = scene[:, :, list(bands)].to(p.ft)
    lo = sel.amin(dim=(0, 1), keepdim=True)
    rng = sel.amax(dim=(0, 1), keepdim=True) - lo
    pos = rng > 0
    return torch.where(pos, (sel - lo) / torch.where(pos, rng, 1.0),
                       torch.zeros_like(sel))


def rgb_to_lab(rgb: torch.Tensor, p: Precision = REFERENCE) -> torch.Tensor:
    """(..., 3) sRGB in [0, 1] to CIELAB (D65), computed in ``p.acc`` and
    rounded once to ``p.ft``."""
    rgb = torch.clamp(rgb.to(p.acc), 0.0, 1.0)
    lin = torch.where(rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4,
                      rgb / 12.92)
    f = []
    for row, white in zip(_M, _WHITE):
        t = (lin[..., 0] * row[0] + lin[..., 1] * row[1]
             + lin[..., 2] * row[2]) / white
        f.append(torch.where(t > 0.008856, torch.pow(t, 1.0 / 3.0),
                             (903.3 * t + 16.0) / 116.0))
    fx, fy, fz = f
    return torch.stack([116.0 * fy - 16.0, 500.0 * (fx - fy),
                        200.0 * (fy - fz)], dim=-1).to(p.ft)


# -- connected components ----------------------------------------------------

def components(labels: torch.Tensor) -> torch.Tensor:
    """(H, W) int64 4-connected components of equal labels, numbered
    0..K-1 by raster-order first occurrence: each pixel takes the least
    index over its equal neighbours, then follows its pointer, until
    nothing moves."""
    H, W = labels.shape
    idx = torch.arange(H * W, device=labels.device).view(H, W)
    same_l = labels[:, 1:] == labels[:, :-1]
    same_u = labels[1:, :] == labels[:-1, :]
    comp = idx.clone()
    big = H * W
    while True:
        m = comp.clone()
        m[:, 1:] = torch.minimum(m[:, 1:], torch.where(same_l, comp[:, :-1],
                                                       big))
        m[:, :-1] = torch.minimum(m[:, :-1], torch.where(same_l, comp[:, 1:],
                                                         big))
        m[1:, :] = torch.minimum(m[1:, :], torch.where(same_u, comp[:-1, :],
                                                       big))
        m[:-1, :] = torch.minimum(m[:-1, :], torch.where(same_u, comp[1:, :],
                                                         big))
        flat = m.reshape(-1)
        flat = flat[flat]
        flat = flat[flat]
        nxt = flat.view(H, W)
        if torch.equal(nxt, comp):
            break
        comp = nxt
    is_root = (comp == idx).reshape(-1)
    rank = torch.cumsum(is_root.to(torch.int64), 0) - 1
    return rank[comp.reshape(-1)].view(H, W)


# -- SLIC ---------------------------------------------------------------------

def _grid(H: int, W: int, n_segments: int):
    """(gh, gw, step, half) of skimage's regular grid."""
    fstep = math.sqrt(H * W / max(n_segments, 1))
    step = max(1, round(fstep))
    half = int(fstep // 2)
    gh = max(1, len(range(half, H, step)))
    gw = max(1, len(range(half, W, step)))
    return gh, gw, step, half


def slic(img: torch.Tensor, n_segments: int, compactness: float,
         max_num_iter: int = 10, min_size_factor: float = 0.5,
         max_size_factor: float = 3.0, p: Precision = REFERENCE
         ) -> torch.Tensor:
    """(H, W) int64 SLIC labels of the (H, W, C) image, connectivity
    enforced and small segments merged."""
    H, W, C = img.shape
    dev = img.device
    gh, gw, step, half = _grid(H, W, n_segments)
    K = gh * gw
    ratio = (compactness / float(step)) ** 2
    cy0 = torch.clamp(half + torch.arange(gh, device=dev, dtype=p.ft) * step,
                      max=H - 1.0)
    cx0 = torch.clamp(half + torch.arange(gw, device=dev, dtype=p.ft) * step,
                      max=W - 1.0)
    cyi = torch.clamp(torch.round(cy0), 0, H - 1).long()
    cxi = torch.clamp(torch.round(cx0), 0, W - 1).long()
    centers = torch.cat([img[cyi][:, cxi],
                         cy0[:, None, None].expand(gh, gw, 1),
                         cx0[None, :, None].expand(gh, gw, 1)], dim=-1)
    rows = torch.arange(H, device=dev)
    cols = torch.arange(W, device=dev)
    yy = rows.to(p.ft)[:, None].expand(H, W)
    xx = cols.to(p.ft)[None, :].expand(H, W)
    row_cell = torch.clamp(rows * gh // H, 0, gh - 1)
    col_cell = torch.clamp(cols * gw // W, 0, gw - 1)

    def assign(centers):
        best_d = torch.full((H, W), float("inf"), dtype=p.ft, device=dev)
        best_k = torch.full((H, W), -1, dtype=torch.int64, device=dev)
        for di, dj in _OFFSETS9:
            ri = torch.clamp(row_cell + di, 0, gh - 1)
            ci = torch.clamp(col_cell + dj, 0, gw - 1)

            def plane(ch):
                return centers[..., ch].index_select(0, ri).index_select(
                    1, ci)

            d_color = torch.zeros((H, W), dtype=p.ft, device=dev)
            for c in range(C):
                d_color = d_color + (img[..., c] - plane(c)) ** 2
            dy = yy - plane(C)
            dx = xx - plane(C + 1)
            d = d_color + ratio * (dy * dy + dx * dx)
            kid = ri[:, None] * gw + ci[None, :]
            better = d < best_d
            best_d = torch.where(better, d, best_d)
            best_k = torch.where(better, kid, best_k)
        return best_k

    def update(labels, centers):
        feats = torch.cat([img.reshape(-1, C), yy.reshape(-1, 1),
                           xx.reshape(-1, 1),
                           torch.ones((H * W, 1), dtype=p.ft, device=dev)],
                          dim=1).to(p.acc)
        sums = torch.zeros((K, C + 3), dtype=p.acc, device=dev).index_add_(
            0, labels.reshape(-1), feats).to(p.ft)
        cnt = sums[:, C + 2]
        means = sums[:, :C + 2] / torch.clamp(cnt, min=1.0)[:, None]
        means = torch.where((cnt > 0)[:, None], means,
                            centers.reshape(K, C + 2))
        return means.reshape(gh, gw, C + 2)

    for _ in range(max_num_iter):
        centers = update(assign(centers), centers)
    lab = components(assign(centers))
    n = int(lab.max()) + 1
    seg_size = H * W / K
    min_size = max(1, int(min_size_factor * seg_size))
    max_size = max(min_size + 1, int(max_size_factor * seg_size))
    return merge_small(lab, n, min_size, max_size)


# -- the small-segment merge (frozen copy) -----------------------------------

def _edges(lab: torch.Tensor, K: int):
    keys = []
    for a, b in ((lab[:, :-1], lab[:, 1:]), (lab[:-1, :], lab[1:, :])):
        m = a != b
        keys.append(torch.minimum(a[m], b[m]) * K + torch.maximum(a[m], b[m]))
    key = torch.unique(torch.cat(keys))
    return key // K, key % K


def _sweep(ea, eb, lut, sizes0, min_size, max_size, K, capped):
    iota = torch.arange(K, device=lut.device)
    sizes = torch.zeros(K, dtype=torch.int64,
                        device=lut.device).index_add_(0, lut, sizes0)
    small = (sizes > 0) & (sizes < min_size)
    a, b = lut[ea], lut[eb]
    m = a != b
    inf = 2 * K
    biased = torch.full((K,), inf, dtype=torch.int64, device=lut.device)
    for src, dst in ((a, b), (b, a)):
        use = m & small[src]
        val = dst + torch.where(small[dst], K, 0)
        biased.scatter_reduce_(0, src[use], val[use], "amin")
    has_large = biased < K
    tgt = torch.where(has_large, biased, biased - K)
    tgt_safe = tgt.clamp(0, K - 1)
    adopt = small & (biased < inf) & ((tgt < iota) | has_large)
    if capped:
        adopt &= (sizes + sizes[tgt_safe]) <= max_size
    adopt &= ~adopt[tgt_safe]
    return torch.where(adopt, tgt_safe, iota)[lut], bool(adopt.any())


def merge_small(lab: torch.Tensor, K: int, min_size: int, max_size: int,
                max_iters: int = 512) -> torch.Tensor:
    """Segments under ``min_size`` pixels adopt a neighbour: capped sweeps
    (the merged size at most ``max_size``) to their fixpoint, uncapped ones
    while a small segment is left; then numbered by first occurrence."""
    flat = lab.reshape(-1)
    sizes0 = torch.bincount(flat, minlength=K)
    ea, eb = _edges(lab, K)
    lut = torch.arange(K, device=lab.device)
    for capped in (True, False):
        if not capped:
            sizes = torch.zeros(K, dtype=torch.int64, device=lab.device
                                ).index_add_(0, lut, sizes0)
            if not bool(((sizes > 0) & (sizes < min_size)).any()):
                break
        for _ in range(max_iters):
            lut, changed = _sweep(ea, eb, lut, sizes0, min_size, max_size,
                                  K, capped)
            if not changed:
                break
    return components(lut[flat].view(lab.shape))


# -- quickshift -----------------------------------------------------------------

def tie_noise(seed: int, shape, device) -> torch.Tensor:
    """The density's tie-breaking noise: N(0, 1) * 1e-5 from a CPU
    ``torch.Generator`` seeded with ``seed``, moved to ``device``."""
    g = torch.Generator().manual_seed(int(seed))
    return (torch.randn(tuple(shape), generator=g) * 1e-5).to(device)


def _d2(img, sh, off2: int):
    t = img[0] - sh[0]
    d2 = t * t
    for c in range(1, img.shape[0]):
        t = img[c] - sh[c]
        d2 = d2 + t * t
    return d2 + float(off2)


def quickshift(img: torch.Tensor, ratio: float, kernel_size: float,
               max_dist: float, seed: int = 42, p: Precision = REFERENCE
               ) -> torch.Tensor:
    """(H, W) int64 quickshift labels of the (H, W, C) image: the Parzen
    density over the (2r+1)^2 window (r = ceil(3 kernel_size)) plus the
    tie noise, each pixel's parent the nearest window neighbour of higher
    density within ``max_dist`` (ties to the first in row-major order),
    then connected components of the roots."""
    H, W, _ = img.shape
    r = max(1, int(math.ceil(3.0 * kernel_size)))
    x = (img * ratio).permute(2, 0, 1).contiguous().to(p.ft)
    inv2k2 = torch.tensor(1.0 / (2.0 * kernel_size * kernel_size),
                          dtype=torch.float32).to(p.ft)
    pad = F.pad(x.float(), (r, r, r, r), value=float("inf")).to(p.ft)
    rho = torch.ones((H, W), dtype=p.ft, device=img.device)
    window = [(dy, dx) for dy in range(-r, r + 1) for dx in range(-r, r + 1)
              if (dy, dx) != (0, 0)]
    for dy, dx in window:
        d2 = _d2(x, pad[:, r + dy:r + dy + H, r + dx:r + dx + W],
                 dy * dy + dx * dx)
        rho = rho + torch.where(torch.isfinite(d2), torch.exp(-d2 * inv2k2),
                                0.0)
    rho = rho + tie_noise(seed, (H, W), img.device).to(p.ft)
    max_d2 = float(torch.tensor(max_dist * max_dist, dtype=torch.float32))
    pad_rho = F.pad(rho[None].float(), (r, r, r, r),
                    value=float("-inf"))[0].to(p.ft)
    best = torch.full((H, W), float("inf"), dtype=p.ft, device=img.device)
    doff = torch.zeros((H, W), dtype=torch.int64, device=img.device)
    for dy, dx in window:
        if dy * dy + dx * dx > max_d2:
            continue
        d2 = _d2(x, pad[:, r + dy:r + dy + H, r + dx:r + dx + W],
                 dy * dy + dx * dx)
        nb = pad_rho[r + dy:r + dy + H, r + dx:r + dx + W]
        better = (nb > rho) & (d2 <= max_d2) & torch.isfinite(d2) & (d2 < best)
        best = torch.where(better, d2, best)
        doff = torch.where(better, dy * W + dx, doff)
    idx = torch.arange(H * W, device=img.device)
    root = idx + doff.reshape(-1)
    while True:
        nxt = root[root]
        if torch.equal(nxt, root):
            break
        root = nxt
    return components(root.view(H, W))


def segment(scene: torch.Tensor, seg: dict, p: Precision = REFERENCE
            ) -> torch.Tensor:
    """The configuration's labels of the (H, W, bands) uint8 ``scene``
    (``seg``: the configuration's ``segment`` arguments)."""
    bands = seg.get("segmentation_bands") or list(range(scene.shape[2]))
    img = normalise(scene, bands, p)
    if len(bands) == 3:
        img = rgb_to_lab(img, p)
    if seg["method"] == "slic":
        return slic(img, int(seg["n_segments"]), float(seg["compactness"]),
                    p=p)
    if seg["method"] == "quickshift":
        return quickshift(img, float(seg["ratio"]), float(seg["kernel_size"]),
                          float(seg["max_dist"]), p=p)
    raise ValueError(f"unknown method {seg['method']!r}")
