"""SLIC superpixels in torch (port of ``obia_tpu/ops/slic.py``).

Each pixel evaluates the 3x3 neighbourhood of grid cluster centres around
its own grid cell (the candidate set of SLIC's 2S x 2S window), and the
centre update sums the pixels of each cluster in float64, rounded once. On
a CUDA tensor each k-means pass is one launch of the hand-written kernel
(:mod:`obia_tpu_torch.ops.slic_kernel`, ``csrc/slic.cu``), which assigns and
accumulates the centre sums on chip; on any other tensor the plain twin
runs (:func:`slic_assign_reference`, then :func:`slic_update_sums64`, one
``index_add_`` over the pixels). Connectivity is then
enforced by :mod:`obia_tpu_torch.ops.connectivity` (exact CCL, dense
relabel, small-segment merge), all on the labels' device; the finished
labels leave it once, as row-wise runs (:func:`download_labels_rle`).
:func:`slic` is the skimage-compatible entry point over
:func:`slic_dense`.

Distance: D^2 = d_color^2 + (compactness / S)^2 * d_spatial^2 with
S = sqrt(H*W / n_segments); SLICO (``slic_zero``) uses a per-cluster colour
scale instead. Seeds follow skimage's ``util.regular_grid``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from .connectivity import ccl_dense_labels, dense_relabel, merge_small_device
from .slic_kernel import slic_pass
from .stats import segment_sum

_OFFSETS9 = tuple((di, dj) for di in (-1, 0, 1) for dj in (-1, 0, 1))


def _grid_step(h: int, w: int, n_segments: int) -> int:
    return max(1, round(math.sqrt(h * w / max(n_segments, 1))))


def _grid_half(h: int, w: int, n_segments: int) -> int:
    """First-seed offset of skimage ``regular_grid``: int(float_step // 2)
    from the float step, before rounding."""
    return int(math.sqrt(h * w / max(n_segments, 1)) // 2)


def _grid_shape(h: int, w: int, n_segments: int) -> Tuple[int, int]:
    s = _grid_step(h, w, n_segments)
    half = _grid_half(h, w, n_segments)
    gh = max(1, len(range(half, h, s)))
    gw = max(1, len(range(half, w, s)))
    return gh, gw


def initial_centers(img: torch.Tensor, gh: int, gw: int,
                    step: Optional[int] = None,
                    half: Optional[int] = None) -> torch.Tensor:
    """Grid-seeded centres (gh, gw, C+2): features + (y, x)."""
    H, W, C = img.shape
    cy0, cx0, cyi, cxi = seed_positions(H, W, gh, gw, step, half, img.device)
    return centers_from_seeds(img[cyi][:, cxi], cy0, cx0)


def seed_positions(H: int, W: int, gh: int, gw: int,
                   step: Optional[int] = None, half: Optional[int] = None,
                   device=None):
    """Seed coordinates (cy0 (gh,), cx0 (gw,) float32) and the pixel rows
    and columns (cyi, cxi) whose features seed the centres."""
    si = step if step else max(1, round((H / gh + W / gw) / 2.0))
    if half is None:
        half = si // 2
    cy0 = torch.clamp(half + torch.arange(gh, dtype=torch.float32,
                                          device=device) * si, max=H - 1.0)
    cx0 = torch.clamp(half + torch.arange(gw, dtype=torch.float32,
                                          device=device) * si, max=W - 1.0)
    cyi = torch.clamp(torch.round(cy0), 0, H - 1).long()
    cxi = torch.clamp(torch.round(cx0), 0, W - 1).long()
    return cy0, cx0, cyi, cxi


def centers_from_seeds(feat0: torch.Tensor, cy0: torch.Tensor,
                       cx0: torch.Tensor) -> torch.Tensor:
    """(gh, gw, C) seed features + seed coordinates -> (gh, gw, C+2)."""
    gh, gw = feat0.shape[:2]
    return torch.cat([feat0, cy0[:, None, None].expand(gh, gw, 1),
                      cx0[None, :, None].expand(gh, gw, 1)], dim=-1)


def _plane(grid2d: torch.Tensor, ri: torch.Tensor, ci: torch.Tensor):
    """(gh, gw) centre channel -> (h, w) by separable row/column gathers."""
    return grid2d.index_select(0, ri).index_select(1, ci)


def _block_coords(h: int, w: int, origin: Tuple[int, int], device):
    """Global row and column coordinates of an (h, w) block at ``origin``:
    int64 (h,), (w,) and float32 (h, w) planes."""
    rows = torch.arange(h, device=device) + origin[0]
    cols = torch.arange(w, device=device) + origin[1]
    yy = rows.to(torch.float32)[:, None].expand(h, w)
    xx = cols.to(torch.float32)[None, :].expand(h, w)
    return rows, cols, yy, xx


def _contiguous(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return t.contiguous() if t is not None else None


def slic_assign_block(img: torch.Tensor, valid: torch.Tensor,
                      centers: torch.Tensor, gh: int, gw: int, ratio: float,
                      inv_max_dc: Optional[torch.Tensor] = None,
                      step: float = 1.0,
                      spacing: Optional[Tuple[float, float]] = None,
                      origin: Tuple[int, int] = (0, 0),
                      full_hw: Optional[Tuple[int, int]] = None
                      ) -> torch.Tensor:
    """Assignment step for an (h, w) block whose first pixel is the global
    pixel ``origin`` of an image of ``full_hw`` (default: the block is the
    image): (h, w) int64 labels in [0, gh*gw), -1 where not valid. The
    centres are the full replicated grid, so a block needs no halo. A CUDA
    tensor takes the kernel's assign pass (one launch), any other tensor
    :func:`slic_assign_reference`."""
    if img.device.type == "cuda":
        return slic_pass(img.contiguous(), valid.contiguous(),
                         centers.contiguous(), gh, gw, ratio,
                         _contiguous(inv_max_dc), step, spacing, origin,
                         full_hw)[0]
    return slic_assign_reference(img, valid, centers, gh, gw, ratio,
                                 inv_max_dc, step, spacing, origin, full_hw)


def slic_assign_and_sum(img: torch.Tensor, valid: torch.Tensor,
                        centers: torch.Tensor, gh: int, gw: int,
                        ratio: float,
                        inv_max_dc: Optional[torch.Tensor] = None,
                        step: float = 1.0,
                        spacing: Optional[Tuple[float, float]] = None,
                        origin: Tuple[int, int] = (0, 0),
                        full_hw: Optional[Tuple[int, int]] = None,
                        labels: bool = False
                        ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """One k-means pass over a block, as :func:`slic_assign_block` takes
    it: (its labels, or None where a CUDA tensor was not asked for them;
    the block's (gh*gw, C+3) float64 centre-update sums, as
    :func:`slic_update_sums64` gives them, which a sharded run adds over
    its blocks before :func:`rounded_sums`). A CUDA tensor takes one launch
    of the kernel, which assigns and accumulates on chip; any other tensor
    :func:`slic_assign_reference`, then :func:`slic_update_sums64`."""
    if img.device.type == "cuda":
        return slic_pass(img.contiguous(), valid.contiguous(),
                         centers.contiguous(), gh, gw, ratio,
                         _contiguous(inv_max_dc), step, spacing, origin,
                         full_hw, labels=labels, sums=True)
    lab = slic_assign_reference(img, valid, centers, gh, gw, ratio,
                                inv_max_dc, step, spacing, origin, full_hw)
    return lab, slic_update_sums64(img, lab, gh * gw, origin)


def slic_assign_reference(img: torch.Tensor, valid: torch.Tensor,
                          centers: torch.Tensor, gh: int, gw: int,
                          ratio: float,
                          inv_max_dc: Optional[torch.Tensor] = None,
                          step: float = 1.0,
                          spacing: Optional[Tuple[float, float]] = None,
                          origin: Tuple[int, int] = (0, 0),
                          full_hw: Optional[Tuple[int, int]] = None
                          ) -> torch.Tensor:
    """The plain twin of the kernel's assignment, on any device: for each of
    the 9 candidate offsets in turn, D^2 over the whole block, kept on a
    strict <."""
    h, w, C = img.shape
    H, W = full_hw if full_hw is not None else (h, w)
    dev = img.device
    rows, cols, yy, xx = _block_coords(h, w, origin, dev)
    row_cell = torch.clamp(rows * gh // H, 0, gh - 1)
    col_cell = torch.clamp(cols * gw // W, 0, gw - 1)
    best_d = torch.full((h, w), float("inf"), dtype=torch.float32, device=dev)
    best_k = torch.full((h, w), -1, dtype=torch.int64, device=dev)
    for di, dj in _OFFSETS9:
        ri = torch.clamp(row_cell + di, 0, gh - 1)
        ci = torch.clamp(col_cell + dj, 0, gw - 1)
        d_color = torch.zeros((h, w), dtype=torch.float32, device=dev)
        for c in range(C):
            d_color = d_color + (img[..., c] - _plane(centers[..., c], ri,
                                                      ci)) ** 2
        dy = yy - _plane(centers[..., C], ri, ci)
        dx = xx - _plane(centers[..., C + 1], ri, ci)
        if spacing is not None:
            dy = dy * spacing[0]
            dx = dx * spacing[1]
        d_sp = dy * dy + dx * dx
        if inv_max_dc is not None:
            # SLICO: D^2 = d_c^2 / m_k^2 + d_s^2 / S^2
            d = d_color * _plane(inv_max_dc, ri, ci) + d_sp * (
                1.0 / (step * step))
        else:
            d = d_color + ratio * d_sp
        kid = ri[:, None] * gw + ci[None, :]
        better = d < best_d
        best_d = torch.where(better, d, best_d)
        best_k = torch.where(better, kid, best_k)
    return torch.where(valid, best_k, -1)


def slic_update_sums64(img: torch.Tensor, labels: torch.Tensor, K: int,
                       origin: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """(K, C+3) float64 centre-update sums of a block at ``origin``:
    feature and position sums, then the count. A sharded run adds the
    blocks' sums before rounding them once."""
    h, w, C = img.shape
    _, _, yy, xx = _block_coords(h, w, origin, img.device)
    lab = labels.reshape(-1)
    ok = lab >= 0
    wpx = ok.to(torch.float32)
    rows = torch.cat([img.reshape(-1, C), yy.reshape(-1, 1),
                      xx.reshape(-1, 1)], dim=1) * wpx[:, None]
    # float64 accumulation, rounded once: the sums no longer depend on the
    # order the device's atomics add in, so the card and the CPU find the
    # same centres (float32 atomics moved ~2% of 512^2 labels)
    return segment_sum(torch.cat([rows, wpx[:, None]], dim=1).double(),
                       torch.where(ok, lab, 0), K)


def rounded_sums(sums64: torch.Tensor):
    """(K, C+3) float64 centre-update sums rounded once to float32:
    ((K, C+2) feature + position sums, (K,) counts)."""
    out = sums64.float()
    return out[:, :-1], out[:, -1]


def update_centers(sums: torch.Tensor, cnts: torch.Tensor,
                   centers: torch.Tensor) -> torch.Tensor:
    """New (gh, gw, C+2) centres: the means, or the old centre of a
    cluster that lost every pixel."""
    gh, gw, F = centers.shape
    means = sums / torch.clamp(cnts, min=1.0)[:, None]
    means = torch.where((cnts > 0)[:, None], means,
                        centers.reshape(gh * gw, F))
    return means.reshape(gh, gw, F)


def _slic_iterate(img: torch.Tensor, valid: torch.Tensor, gh: int, gw: int,
                  compactness: float, max_num_iter: int,
                  slic_zero: bool = False, grid_step: int = 0,
                  grid_half: int = -1,
                  spacing: Optional[Tuple[float, float]] = None
                  ) -> torch.Tensor:
    """Core k-means loop: (H, W) int64 cluster ids in [0, gh*gw), -1 where
    not valid. Each of the ``max_num_iter`` updates reads the sums of one
    :func:`slic_assign_and_sum` pass, which on the card writes no labels
    (SLICO's writes them, for its colour scale), and one assign-only pass
    writes the labels: ``max_num_iter + 1`` launches of
    ``kernel.slic_pass`` on the card, 11 at the default 10 iterations."""
    img = img.contiguous()
    valid = valid.contiguous()
    H, W, C = img.shape
    K = gh * gw
    step = float(grid_step) if grid_step else math.sqrt(H * W / K)
    ratio = (compactness / step) ** 2
    centers = initial_centers(img, gh, gw, grid_step or None,
                              grid_half if grid_half >= 0 else None)

    def assign(centers, inv_max_dc=None):
        return slic_assign_block(img, valid, centers, gh, gw, ratio,
                                 inv_max_dc=inv_max_dc, step=step,
                                 spacing=spacing)

    def update(centers, inv_max_dc=None, labels=False):
        """(the pass's labels, or None; the centres it updates to)."""
        lab, sums = slic_assign_and_sum(img, valid, centers, gh, gw, ratio,
                                        inv_max_dc, step, spacing,
                                        labels=labels)
        return lab, update_centers(*rounded_sums(sums), centers)

    if not slic_zero:
        for _ in range(max_num_iter):
            centers = update(centers)[1]
        return assign(centers)

    def color_dist_max(labels, centers):
        """Per-cluster max colour distance of the assigned pixels."""
        own = centers.reshape(K, C + 2)[labels.clamp(0, K - 1)]
        d_c = torch.sqrt(((img - own[..., :C]) ** 2).sum(-1))
        lab = labels.reshape(-1)
        mx = torch.full((K + 1,), float("-inf"), dtype=torch.float32,
                        device=img.device)
        mx.scatter_reduce_(0, torch.where(lab >= 0, lab, K),
                           torch.where(lab >= 0, d_c.reshape(-1), 0.0),
                           "amax")
        return torch.clamp(mx[:K], min=1e-3)

    inv_max_dc = torch.full((gh, gw), 1.0 / (10.0 ** 2), dtype=torch.float32,
                            device=img.device)
    for _ in range(max_num_iter):
        labels, centers = update(centers, inv_max_dc, labels=True)
        mx = color_dist_max(labels, centers)
        inv_max_dc = (1.0 / (mx * mx)).reshape(gh, gw)
    return assign(centers, inv_max_dc)


def slic(image, n_segments: int = 100, compactness: float = 10.0,
         max_num_iter: int = 10, sigma: float = 0.0, mask=None,
         enforce_connectivity: bool = True, min_size_factor: float = 0.5,
         max_size_factor: float = 3.0, start_label: int = 1,
         channel_axis: int = -1, convert2lab: Optional[bool] = None,
         slic_zero: bool = False, spacing=None, device=None) -> np.ndarray:
    """skimage-compatible SLIC: (H, W) int64 labels from ``start_label``;
    with a ``mask``, masked-out pixels are 0 and labels start at
    ``max(start_label, 1)``. A tensor runs on its own device; an array on
    ``device``, the card when None (raising where there is none), the CPU
    only with ``"cpu"``."""
    from ..device import resolve_device
    if not isinstance(image, torch.Tensor):
        image = torch.as_tensor(np.asarray(image)).to(resolve_device(device))
    lab, _ = slic_dense(
        image, n_segments=n_segments, compactness=compactness,
        max_num_iter=max_num_iter, sigma=sigma, mask=mask,
        enforce_connectivity=enforce_connectivity,
        min_size_factor=min_size_factor, max_size_factor=max_size_factor,
        channel_axis=channel_axis, convert2lab=convert2lab,
        slic_zero=slic_zero, spacing=spacing)
    lab_np = decode_rle_labels(*download_labels_rle(lab)).astype(np.int64)
    if mask is not None:
        return np.where(lab_np >= 0, lab_np + max(start_label, 1), 0)
    return lab_np + start_label


def slic_dense(image: torch.Tensor, n_segments: int = 100,
               compactness: float = 10.0, max_num_iter: int = 10,
               sigma: float = 0.0, mask=None,
               enforce_connectivity: bool = True,
               min_size_factor: float = 0.5, max_size_factor: float = 3.0,
               channel_axis: int = -1, convert2lab: Optional[bool] = None,
               slic_zero: bool = False, spacing=None
               ) -> Tuple[torch.Tensor, int]:
    """SLIC on the tensor's own device: ((H, W) int32 dense labels 0..K-1,
    -1 where masked out; K)."""
    from .. import telemetry

    img = image.to(torch.float32)
    if img.dim() == 2:
        img = img[:, :, None]
    if channel_axis not in (-1, 2):
        img = torch.movedim(img, channel_axis, -1)
    H, W, C = img.shape
    if convert2lab or (convert2lab is None and C == 3):
        from .color import rgb_to_lab
        img = rgb_to_lab(img)
    if sigma and sigma > 0:
        # skimage pre-smooths each channel with scipy's gaussian_filter
        # (reflect padding), after the colour conversion
        from .filters import gaussian_filter
        img = gaussian_filter(img, float(sigma))
    spacing_yx = None
    if spacing is not None:
        spacing_yx = (float(spacing[0]), float(spacing[1]))
        if spacing_yx == (1.0, 1.0):
            spacing_yx = None
    valid = (torch.as_tensor(np.asarray(mask) != 0, device=img.device)
             if mask is not None
             else torch.ones((H, W), dtype=torch.bool, device=img.device))
    gh, gw = _grid_shape(H, W, n_segments)

    with telemetry.stage("slic.iterate"):
        labels = _slic_iterate(img, valid, gh, gw, float(compactness),
                               int(max_num_iter), slic_zero=bool(slic_zero),
                               grid_step=_grid_step(H, W, n_segments),
                               grid_half=_grid_half(H, W, n_segments),
                               spacing=spacing_yx)
    if not enforce_connectivity:
        return _compact_first_occurrence(labels, gh * gw)
    with telemetry.stage("slic.connectivity"):
        lab, K = ccl_dense_labels(labels)
    with telemetry.stage("slic.merge_small"):
        seg_size = H * W / (gh * gw)
        min_size = max(1, int(min_size_factor * seg_size))
        max_size = max(min_size + 1, int(max_size_factor * seg_size))
        return merge_small_device(lab, K, min_size, max_size)


def _compact_first_occurrence(labels: torch.Tensor, K: int
                              ) -> Tuple[torch.Tensor, int]:
    """Cluster ids in [0, K) -> dense ids by raster-order first occurrence."""
    flat = labels.reshape(-1)
    ok = flat >= 0
    pos = torch.arange(flat.numel(), dtype=torch.int64, device=flat.device)
    first = torch.full((K + 1,), flat.numel(), dtype=torch.int64,
                       device=flat.device)
    first.scatter_reduce_(0, torch.where(ok, flat, K), pos, "amin")
    roots = torch.where(ok, first[flat.clamp(min=0)], -1)
    return dense_relabel(roots.view(labels.shape))


def _rle_run_starts(lab: torch.Tensor) -> torch.Tensor:
    """Start positions of the row-major runs of a label raster; runs also
    break at row ends, so every run is at most W long (reference
    ``_rle_run_ids``)."""
    H, W = lab.shape
    flat = lab.reshape(-1)
    start = torch.ones_like(flat, dtype=torch.bool)
    start[1:] = flat[1:] != flat[:-1]
    start[::W] = True
    return torch.nonzero(start).reshape(-1)


def download_labels_rle(lab: torch.Tensor):
    """Row-wise RLE download of a label raster: (values int32 (R,),
    lengths int64 (R,), (H, W)) (reference ``_rle_compact`` +
    ``download_labels_rle``). About 12 bytes per run cross to the host
    instead of 4 per pixel."""
    H, W = lab.shape
    starts = _rle_run_starts(lab)
    values = lab.reshape(-1)[starts]
    ends = torch.cat([starts[1:], torch.tensor([H * W], device=lab.device)])
    lengths = ends - starts
    return (values.to(torch.int32).cpu().numpy(),
            lengths.to(torch.int64).cpu().numpy(), (H, W))


def decode_rle_labels(values: np.ndarray, lengths: np.ndarray,
                      shape) -> np.ndarray:
    return np.repeat(values, lengths).reshape(shape)


class LazyRLERaster:
    """Dense label raster materialised from RLE on first array access:
    polygonisation and statistics read the RLE and device copies, so the
    dense host raster exists only if something indexes it."""

    __slots__ = ("values", "lengths", "shape", "_dense")

    def __init__(self, values, lengths, shape):
        self.values = values
        self.lengths = lengths
        self.shape = shape
        self._dense = None

    def materialise(self) -> np.ndarray:
        if self._dense is None:
            self._dense = decode_rle_labels(self.values, self.lengths,
                                            self.shape)
        return self._dense

    def __array__(self, dtype=None, copy=None):
        arr = self.materialise()
        return arr.astype(dtype) if dtype is not None else arr

    def __len__(self):
        return self.shape[0]

    # the RLE is never written to: a copy shares it
    def __deepcopy__(self, memo):
        return self

    def __copy__(self):
        return self

    # the ndarray surface that consumers of an attached label raster use
    # (comparisons, arithmetic, reductions), each on the dense raster
    @property
    def dtype(self):
        return self.values.dtype

    @property
    def ndim(self):
        return len(self.shape)

    @property
    def size(self):
        h, w = self.shape
        return h * w

    def astype(self, dtype):
        return self.materialise().astype(dtype)

    def __getitem__(self, idx):
        return self.materialise()[idx]

    def __eq__(self, other):
        return self.materialise() == other

    def __ne__(self, other):
        return self.materialise() != other

    __hash__ = None

    def __ge__(self, other):
        return self.materialise() >= other

    def __gt__(self, other):
        return self.materialise() > other

    def __le__(self, other):
        return self.materialise() <= other

    def __lt__(self, other):
        return self.materialise() < other

    def __add__(self, other):
        return self.materialise() + other

    __radd__ = __add__

    def __sub__(self, other):
        return self.materialise() - other

    def __rsub__(self, other):
        return other - self.materialise()

    def __mul__(self, other):
        return self.materialise() * other

    __rmul__ = __mul__

    def min(self, *a, **kw):
        return self.materialise().min(*a, **kw)

    def max(self, *a, **kw):
        return self.materialise().max(*a, **kw)
