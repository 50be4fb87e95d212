"""Seed points from canopy-height and density peaks, merged into canonical
seeds (port of ``obia_tpu/utils/seeds.py``).

``make_chm_seeds`` and ``make_density_seeds`` write the peaks of a raster;
``make_canonical_seeds`` merges both seed sets: stage-1 clustering with an
adaptive eps, a cost-weighted distance matrix, DBSCAN on it, an optional
height split and per-cluster trim, and per-crown NMS.

On ``device`` (the card unless ``device="cpu"``) run the masked Gaussian and
the window maximum of the peak search, and the distance matrix
(:func:`build_distance_matrix`): the reference's line-cost gather over every
pair and sample, walked here in blocks of rows over the pairs i < j only,
so no (n, n, S) array is ever held. DBSCAN with ``min_samples=1`` on a
precomputed matrix is the connected components of the graph D <= eps: its
edges are taken on the device and joined by the native union-find. The
reference's pandas steps (sorts, ``groupby().head()``, the height split,
the NMS) are numpy with the same row order, so nothing here needs pandas
or sklearn; tables are read and written through
:mod:`obia_tpu_torch.vector.features`.
"""
from __future__ import annotations

import sys
from pathlib import Path
from typing import List

import numpy as np
import torch

from .. import telemetry
from ..device import resolve_device
from ..geometry.geom import Point
from ..io.tiff import TiffReader
from ..ops.filters import fma, gaussian_filter, hypot, maximum_filter
from ..vector.features import Features, read_features

# a block of rows of the distance matrix keeps its intermediates under
# this many bytes; a pair of the block holds at most _PAIR_BYTES of them
_BLOCK_BYTES = 1 << 30
_PAIR_BYTES = 160


def _detect_peaks(arr: np.ndarray, v_min: float, min_dist_px: int,
                  sigma: float = 0, device=None) -> np.ndarray:
    """(row, col) indices, in row-major order, of the local maxima >=
    ``v_min`` under a (2 min_dist_px + 1)² window, after a Gaussian blur
    of the valid pixels that ignores NaN nodata when ``sigma > 0``."""
    dev = resolve_device(device)
    valid = np.isfinite(arr)
    with telemetry.stage("seeds.peaks"):
        if sigma and sigma > 0:
            # masked smoothing: smoothing a -inf nodata fill would bleed
            # -inf over the kernel's support and suppress every peak near
            # a nodata border or hole
            ok = torch.as_tensor(valid, device=dev)
            w = gaussian_filter(ok.to(torch.float32), float(sigma))
            v = gaussian_filter(torch.as_tensor(
                np.where(valid, arr, 0.0).astype(np.float32), device=dev),
                float(sigma))
            x = torch.where(ok & (w > 1e-6), v / torch.clamp_min(w, 1e-6),
                            torch.full_like(v, -np.inf))
        else:
            x = torch.as_tensor(np.where(valid, arr, -np.inf).astype(
                np.float32), device=dev)
        mx = maximum_filter(x, 2 * int(min_dist_px) + 1)
        peaks = torch.nonzero((x == mx) & (x >= v_min)).cpu().numpy()
    return peaks


def _read_band_nan(path: str):
    r = TiffReader(path)
    arr = r.read()[:, :, 0].astype(np.float32)
    if r.nodata is not None:
        arr = np.where(arr == r.nodata, np.nan, arr)
    return arr, r


def _peaks_table(arr, peak_rc, reader, value_col: str) -> Features:
    rows, cols = peak_rc[:, 0], peak_rc[:, 1]
    t = reader.transform
    xs = t.a * (cols + 0.5) + t.b * (rows + 0.5) + t.c
    ys = t.d * (cols + 0.5) + t.e * (rows + 0.5) + t.f
    vals = arr[rows, cols]
    return Features({"id": np.arange(len(xs)).tolist(),
                     value_col: vals.tolist()},
                    [Point(x, y) for x, y in zip(xs, ys)], reader.crs)


def _make_seeds(raster, seeds_gpkg, v_min, min_dist_px, sigma, device,
                value_col: str, what: str, missing: str, empty: str) -> None:
    device = resolve_device(device)
    raster_path = Path(raster)
    if not raster_path.exists():
        raise SystemExit(f"{missing} not found: {raster_path}")
    arr, reader = _read_band_nan(str(raster_path))
    peak_rc = _detect_peaks(arr, v_min, min_dist_px, sigma, device)
    if peak_rc.size == 0:
        raise SystemExit(empty)
    table = _peaks_table(arr, peak_rc, reader, value_col)
    Path(seeds_gpkg).parent.mkdir(parents=True, exist_ok=True)
    with telemetry.stage("seeds.write", host_only=True):
        table.to_file(str(seeds_gpkg), driver="GPKG")
    print(f"wrote {len(table):,} {what} points -> {seeds_gpkg}")


def make_density_seeds(density_raster, seeds_gpkg, d_min: float = 4.5,
                       min_dist_px: int = 4, gauss_sigma: float = 2,
                       device=None) -> None:
    """Density-raster peak seeds (``id``, ``den_max``) → GPKG."""
    _make_seeds(density_raster, seeds_gpkg, d_min, min_dist_px, gauss_sigma,
                device, "den_max", "density-seed", "density raster",
                "No density peaks found - lower D_MIN or check raster.")


def make_chm_seeds(chm_raster, seeds_gpkg, h_min_m: float = 2.5,
                   min_dist_px: int = 3, gauss_sigma: float = 1,
                   device=None) -> None:
    """Canopy-height-model peak seeds (``id``, ``ch_max``) → GPKG."""
    _make_seeds(chm_raster, seeds_gpkg, h_min_m, min_dist_px, gauss_sigma,
                device, "ch_max", "CHM seed", "CHM raster",
                "No peaks found - adjust H_MIN_M or check CHM.")


def _add_chm_height(table: Features, chm_path) -> Features:
    """The CHM sampled at each point as a float32 ``height`` column; rows
    off the raster or on nodata are dropped."""
    chm, reader = _read_band_nan(str(chm_path))
    inv = ~reader.transform
    vals = []
    H, W = chm.shape
    for p in table.geometry:
        c, r = inv * (p.x, p.y)
        # floor, not int(): truncation maps -0.4 to pixel 0, sampling the
        # border pixel for points just outside the raster
        ri, ci = int(np.floor(r)), int(np.floor(c))
        vals.append(chm[ri, ci] if 0 <= ri < H and 0 <= ci < W else np.nan)
    height = np.asarray(vals, np.float32)
    keep = np.flatnonzero(~np.isnan(height))
    cols = {k: [v[i] for i in keep] for k, v in table.columns.items()}
    cols["height"] = height[keep]
    return Features(cols, [table.geometry[i] for i in keep], table.crs)


def _pair_values(x, y, cost, inv, ts, weight: float, xy_thresh: float,
                 r0: int, r1: int) -> torch.Tensor:
    """D[i, j] for the rows r0 <= i < r1 and the columns j > r0, zero where
    j <= i: the reference's ``_line_cost_matrix`` for those pairs, then its
    ``where``. The float32 arithmetic is XLA's on the CPU, which contracts
    every multiply that feeds an add into a fused multiply-add: the sample
    x_i + t·dx is fma(t, dx, x_i), its column fma(a, x, b·y) + c; a sample
    rounds half to even and clips; the mean is the float32 sum in sample
    order times the float32 1/S."""
    H, W = cost.shape
    flat = cost.reshape(-1)
    a, b, c, d, e, f = inv
    xi, yi = x[r0:r1, None], y[r0:r1, None]
    dx, dy = x[None, r0 + 1:] - xi, y[None, r0 + 1:] - yi
    xy = hypot(dx, dy)
    acc = None
    for t in ts:
        xl, yl = fma(t, dx, xi), fma(t, dy, yi)
        ci = torch.round(fma(a, xl, b * yl) + c).to(torch.int64)
        ri = torch.round(fma(d, xl, e * yl) + f).to(torch.int64)
        v = flat[ri.clamp_(0, H - 1) * W + ci.clamp_(0, W - 1)]
        acc = v if acc is None else acc + v
    mean = acc * float(np.float32(1) / np.float32(len(ts)))
    if weight == 0:
        val = xy
    else:
        val = torch.where(xy <= xy_thresh, xy, xy * (1.0 + weight * mean))
    j = torch.arange(r0 + 1, x.shape[0], device=x.device)
    i = torch.arange(r0, r1, device=x.device)
    return torch.where(j[None, :] > i[:, None], val, torch.zeros_like(val))


def _block_rows(n: int) -> int:
    return max(1, _BLOCK_BYTES // (_PAIR_BYTES * max(n, 1)))


def distance_matrix(xs, ys, cost: np.ndarray, transform, weight: float,
                    xy_thresh: float, samples: int = 8,
                    device=None) -> torch.Tensor:
    """The cost-weighted distance matrix on ``device`` as an (n, n)
    float32 tensor: D = xy_dist * (1 + weight * mean_line_cost) beyond
    ``xy_thresh``, plain xy_dist within; each pair i < j computed once and
    mirrored, the diagonal zero."""
    dev = resolve_device(device)
    n = len(xs)
    D = torch.zeros((n, n), dtype=torch.float32, device=dev)
    if n < 2:
        return D
    tinv = ~transform
    inv = tuple(float(np.float32(v)) for v in (tinv.a, tinv.b, tinv.c,
                                               tinv.d, tinv.e, tinv.f))
    ts = np.linspace(0.0, 1.0, samples + 2, dtype=np.float32)[1:-1].tolist()
    x = torch.as_tensor(np.asarray(xs, np.float32), device=dev)
    y = torch.as_tensor(np.asarray(ys, np.float32), device=dev)
    cost_t = torch.as_tensor(np.ascontiguousarray(cost, np.float32),
                             device=dev)
    step = _block_rows(n)
    with telemetry.stage("seeds.distance"):
        for r0 in range(0, n - 1, step):
            r1 = min(n - 1, r0 + step)
            val = _pair_values(x, y, cost_t, inv, ts, float(weight),
                               float(xy_thresh), r0, r1)
            D[r0:r1, r0 + 1:] = val
            D[r0 + 1:, r0:r1] += val.T
    return D


def build_distance_matrix(xs: np.ndarray, ys: np.ndarray, cost: np.ndarray,
                          transform, weight: float, xy_thresh: float,
                          samples: int = 8, device=None) -> np.ndarray:
    """:func:`distance_matrix` copied to the host as float32 numpy."""
    return distance_matrix(xs, ys, cost, transform, weight, xy_thresh,
                           samples, device).cpu().numpy()


def _upper_triangle(D: torch.Tensor) -> torch.Tensor:
    """D's strict upper triangle, in ``np.triu_indices`` order."""
    n = D.shape[0]
    step = _block_rows(n)
    parts = []
    for r0 in range(0, n - 1, step):
        r1 = min(n - 1, r0 + step)
        j = torch.arange(r0 + 1, n, device=D.device)
        i = torch.arange(r0, r1, device=D.device)
        parts.append(D[r0:r1, r0 + 1:][j[None, :] > i[:, None]])
    return torch.cat(parts)


def _distance_summary(D: torch.Tensor) -> str:
    """min / median / max of the distinct pairs, as numpy prints them: the
    median of an even count is the float32 mean of the two middle values
    (``torch.median`` would give the lower one)."""
    v = torch.sort(_upper_triangle(D)).values
    m = v.numel()
    med = (v[(m - 1) // 2] + v[m // 2]) / 2
    return (f"d_eff  min/median/max = {float(v[0]):.2f} / {float(med):.2f} "
            f"/ {float(v[-1]):.2f}")


def dbscan_labels(D: torch.Tensor, eps: float) -> np.ndarray:
    """``DBSCAN(eps, min_samples=1, metric="precomputed")`` labels of the
    symmetric matrix D: the connected components of the graph D <= eps,
    numbered in the order of each component's smallest index. The edges
    come from D's upper triangle on its device; the native union-find
    joins them on the host."""
    from .. import native
    n = D.shape[0]
    step = _block_rows(n)
    a, b = [], []
    with telemetry.stage("seeds.dbscan"):
        for r0 in range(0, n - 1, step):
            r1 = min(n - 1, r0 + step)
            j = torch.arange(r0 + 1, n, device=D.device)
            i = torch.arange(r0, r1, device=D.device)
            ij = torch.nonzero((D[r0:r1, r0 + 1:] <= eps)
                               & (j[None, :] > i[:, None]))
            a.append((ij[:, 0] + r0).cpu().numpy())
            b.append((ij[:, 1] + r0 + 1).cpu().numpy())
        ids = np.arange(n, dtype=np.int64)
        if a:
            roots = native.resolve_components(ids, np.concatenate(a),
                                              np.concatenate(b))
        else:
            roots = ids
        # a component's root is its smallest index
        return np.unique(roots, return_inverse=True)[1].astype(np.int64)


def _nargsort_desc(values: np.ndarray) -> np.ndarray:
    """``pandas.core.sorting.nargsort(values, "quicksort", ascending=False)``,
    the order of ``sort_values(ascending=False)``: the non-NaN values
    reversed, argsorted with numpy's quicksort (whose order of ties is
    numpy's), reversed again, the NaNs last in their order."""
    mask = np.isnan(values) if values.dtype.kind == "f" else np.zeros(
        len(values), bool)
    idx = np.arange(len(values))
    non_nan_idx = idx[~mask][::-1]
    indexer = non_nan_idx[values[~mask][::-1].argsort(kind="quicksort")]
    return np.concatenate([indexer[::-1], np.flatnonzero(mask)])


def _head_mask(keys: np.ndarray, n: int) -> np.ndarray:
    """``groupby(keys).head(n)`` as a mask: each row whose key has occurred
    fewer than ``n`` times before it."""
    order = np.argsort(keys, kind="stable")
    k = keys[order]
    first = np.r_[True, k[1:] != k[:-1]]
    pos = np.arange(len(k))
    rank = pos - np.maximum.accumulate(np.where(first, pos, 0))
    mask = np.empty(len(keys), bool)
    mask[order] = rank < n
    return mask


def _groups(keys: np.ndarray) -> List[np.ndarray]:
    """The positions of each key, keys ascending, positions in order (the
    groups ``DataFrame.groupby`` iterates)."""
    order = np.argsort(keys, kind="stable")
    k = keys[order]
    cuts = np.flatnonzero(k[1:] != k[:-1]) + 1
    return np.split(order, cuts) if len(order) else []


def _split_by_height(cluster: np.ndarray, height: np.ndarray, dz: float):
    """The ``dz_merge`` split: a cluster whose height range exceeds ``dz``
    becomes its rows at or below the median and those above. Returns the
    rows in the reference's new order and their new cluster ids."""
    rows, ids = [], []
    for g in _groups(cluster):
        h = height[g]
        mid = np.nanmedian(h)
        parts = [g] if np.ptp(h) <= dz else [g[h <= mid], g[h > mid]]
        for part in parts:
            if len(part):
                rows.append(part)
                ids.append(np.full(len(part), len(rows) - 1, np.int64))
    return np.concatenate(rows), np.concatenate(ids)


def _nms_per_crown(cluster: np.ndarray, height: np.ndarray, x: np.ndarray,
                   y: np.ndarray, base_r: float, scale_r: float
                   ) -> np.ndarray:
    """Greedy per-cluster NMS keeping the tallest seed within an adaptive
    radius: the rows kept, clusters ascending, each cluster's rows by
    height descending."""
    if base_r <= 0 and scale_r <= 0:
        return np.arange(len(cluster))
    from scipy.spatial import cKDTree
    kept = []
    for g in _groups(cluster):
        g = g[_nargsort_desc(height[g])]
        pts = np.c_[x[g], y[g]]
        tree = cKDTree(pts)
        keep = np.zeros(len(g), bool)
        suppressed = np.zeros(len(g), bool)
        for i, (px, py, h) in enumerate(zip(pts[:, 0], pts[:, 1],
                                            height[g])):
            if suppressed[i] or keep[i]:
                continue
            keep[i] = True
            r = max(base_r, scale_r * h)
            suppressed[tree.query_ball_point([px, py], r)] = True
        kept.append(g[keep])
    return np.concatenate(kept)


def _as_column(values) -> np.ndarray:
    arr = np.asarray(values)
    return arr.astype(np.float64) if arr.dtype.kind == "O" else arr


def _seed_table(path, origin: str, value_col: str, chm_raster,
                keep: List[str]) -> Features:
    table = read_features(str(path))
    table.columns["origin"] = [origin] * len(table)
    if value_col in table.columns:
        table.columns["height"] = table.columns.pop(value_col)
    if "height" not in table.columns:
        table = _add_chm_height(table, chm_raster)
    missing = [k for k in keep if k != "geometry" and k not in table.columns]
    if missing:
        raise KeyError(f"{path}: no column {missing}")
    return table


def make_canonical_seeds(chm_seeds, den_seeds, chm_raster, cost_surface,
                         out_path, eps_scale=0.4, min_eps=2, max_eps=8,
                         z_thresh=-1, min_samples=2, merge_radius=1.5,
                         cost_weight=0.5, xy_thresh=0.8, dz_merge=0,
                         keep_all_stage1=True, stage1_top=1,
                         max_per_cluster=0, nms_base=0, nms_scale=0,
                         debug_dist=True, keep=None, nodata_cost=1,
                         device=None) -> Features:
    """Merge CHM and density seeds into canonical seed points, written as
    the GPKG layer ``canonical_seeds`` (``id``, ``cluster``, ``ch_max``,
    ``origin``) and returned as a pandas-free table. The distance matrix
    stays on ``device`` (the card unless ``device="cpu"``)."""
    from scipy.spatial import cKDTree
    dev = resolve_device(device)
    if keep is None:
        keep = ["geometry", "height", "origin"]
    for need in ("geometry", "height", "origin"):
        if need not in keep:
            raise KeyError(f"keep must hold {need!r}")
    chm = _seed_table(chm_seeds, "chm", "ch_max", chm_raster, keep)
    den = _seed_table(den_seeds, "density", "den_max", chm_raster, keep)

    geometry = chm.geometry + den.geometry
    if len(geometry) == 0:
        print("No seeds after CHM sampling.", file=sys.stderr)
        sys.exit(1)
    # pd.concat's dtype: float32 only when both sets were sampled
    height = np.concatenate([_as_column(chm["height"]),
                             _as_column(den["height"])])
    origin = np.array(chm["origin"] + den["origin"], dtype=object)
    sx = np.array([g.x for g in geometry], np.float64)
    sy = np.array([g.y for g in geometry], np.float64)

    with telemetry.stage("seeds.stage1", host_only=True):
        pts_xy = np.c_[sx, sy]
        tree = cKDTree(pts_xy)
        h64 = height.astype(np.float64)
        eps = np.clip(eps_scale * h64, min_eps, max_eps)
        cl1 = -np.ones(len(geometry), int)
        cid = 0
        for i in range(len(geometry)):
            if cl1[i] != -1:
                continue
            idx = tree.query_ball_point(pts_xy[i], float(eps[i]))
            if z_thresh >= 0 and np.ptp(h64[idx]) > z_thresh:
                continue
            if len(idx) >= min_samples:
                cl1[idx] = cid
                cid += 1
        if keep_all_stage1:
            rows = np.arange(len(geometry))
        else:
            clustered = np.flatnonzero(cl1 != -1)
            tall = clustered[_nargsort_desc(height[clustered])]
            tall = tall[_head_mask(cl1[tall], max(1, stage1_top))]
            rows = np.concatenate([tall, np.flatnonzero(cl1 == -1)])

    cost_reader = TiffReader(str(cost_surface))
    cost_arr = cost_reader.read()[:, :, 0].astype(np.float32)
    if cost_reader.nodata is not None:
        cost_arr[cost_arr == cost_reader.nodata] = nodata_cost

    D = distance_matrix(sx[rows], sy[rows], cost_arr, cost_reader.transform,
                        cost_weight, xy_thresh, samples=12, device=dev)
    if debug_dist and len(D) > 1:
        with telemetry.stage("seeds.summary"):
            print(_distance_summary(D))
    cluster = dbscan_labels(D, merge_radius)
    del D

    if dz_merge > 0:
        order, cluster = _split_by_height(cluster, height[rows], dz_merge)
        rows = rows[order]
    if max_per_cluster > 0:
        tall = _nargsort_desc(height[rows])
        kept = np.sort(tall[_head_mask(cluster[tall], max_per_cluster)])
        rows, cluster = rows[kept], cluster[kept]
    with telemetry.stage("seeds.nms", host_only=True):
        final = _nms_per_crown(cluster, height[rows], sx[rows], sy[rows],
                               nms_base, nms_scale)
    rows, cluster = rows[final], cluster[final]

    out = Features({"id": list(range(len(rows))), "cluster": cluster.tolist(),
                    "ch_max": height[rows].tolist(),
                    "origin": origin[rows].tolist()},
                   [geometry[i] for i in rows], chm.crs)
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with telemetry.stage("seeds.write", host_only=True):
        out.to_file(str(out_path), layer="canonical_seeds", driver="GPKG")
    print(f"canonical seeds: {len(out):,}  ->  {out_path}")
    return out
