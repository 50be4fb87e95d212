"""Cost surface from the CHM gradient, the NDVI gap, texture entropy and
SLIC edges (port of ``obia_tpu/utils/cost.py``).

``read_band``, ``normalise``, ``chm_gradient``, ``ndvi``,
``texture_entropy``, ``slic_edge``, ``rasterise_slic_gpkg`` and
``make_cost_surface``, with the reference's behaviour: the weights must
total 1, the WorldView-3 band layout (C, B, G, Y, R, RE, N1, N2), -9999
nodata, SystemExit on unusable inputs, and a UserWarning with the weights
renormalised when no SLIC layer is given.

The Sobel gradient and the 256-level windowed entropy run on ``device``
(the card unless ``device="cpu"``) through :mod:`obia_tpu_torch.ops.
filters`; the percentiles, NDVI, the SLIC edges and the nodata logic stay
in numpy on the host, as in the reference. The SLIC layer is read without
pandas (:mod:`obia_tpu_torch.vector.features`).
"""
from __future__ import annotations

import warnings
from pathlib import Path

import numpy as np
import torch

from .. import telemetry
from ..device import resolve_device
from ..geometry.rasterize import rasterize
from ..io.tiff import TiffReader, write_tiff
from ..ops.filters import disk_footprint, hypot, local_entropy, sobel
from ..vector.features import read_features

NODATA = -9999.0
_PCT_WINDOW = (2.0, 98.0)

# WorldView-3 band order the reference assumes (cost.py:95)
_WV3_COASTAL, _WV3_RED, _WV3_NIR1 = 0, 4, 6


def read_band(path, idx: int = 1):
    """(band array with NaN nodata, profile dict)."""
    r = TiffReader(str(path))
    arr = r.read()[:, :, idx - 1].astype(np.float32)
    if r.nodata is not None:
        arr = np.where(arr == r.nodata, np.nan, arr)
    prof = {"height": r.height, "width": r.width, "crs": r.crs,
            "transform": r.transform, "count": r.spp, "dtype": r.dtype}
    return arr, prof


def normalise(arr: np.ndarray) -> np.ndarray:
    """Rescale the 2nd..98th percentile window to [0, 1]; NaN (and a
    degenerate window) map to 0."""
    lo, hi = np.nanpercentile(arr, _PCT_WINDOW)
    span = hi - lo
    if not np.isfinite(span) or span == 0:
        return np.zeros(np.shape(arr), np.float32)
    with np.errstate(invalid="ignore"):
        scaled = (np.clip(arr, lo, hi) - lo) / span
    return np.nan_to_num(scaled).astype(np.float32)


def chm_gradient(chm: np.ndarray, device=None) -> np.ndarray:
    """Normalised Sobel gradient magnitude, the Sobels on ``device``."""
    x = torch.as_tensor(np.nan_to_num(chm).astype(np.float32),
                        device=resolve_device(device))
    with telemetry.stage("cost.gradient"):
        dx = sobel(x, axis=1, mode="nearest")
        dy = sobel(x, axis=0, mode="nearest")
        mag = hypot(dx, dy).cpu().numpy()
    return normalise(mag)


def ndvi(red: np.ndarray, nir: np.ndarray) -> np.ndarray:
    """Normalised-difference vegetation index in [-1, 1] (eps-guarded
    denominator)."""
    index = (nir - red) / (nir + red + 1e-9)
    return np.clip(index, -1.0, 1.0)


def texture_entropy(pan: np.ndarray, device=None) -> np.ndarray:
    """Rank entropy of the normalised band under a disk(3) footprint: the
    256-level windowed histogram entropy on ``device``."""
    pan_u8 = (normalise(pan) * 255).astype(np.uint8)
    q = torch.as_tensor(pan_u8, device=resolve_device(device))
    with telemetry.stage("cost.entropy"):
        ent = local_entropy(q, disk_footprint(3)).cpu().numpy()
    return normalise(ent)


def slic_edge(label_img: np.ndarray) -> np.ndarray:
    """Label-discontinuity edge map: a pixel is an edge when its right or
    bottom 4-neighbour holds another label. NaN labels (nodata regions of a
    label raster) are never edges."""
    lab = np.asarray(label_img)
    boundary = np.zeros(lab.shape, np.bool_)
    boundary[:-1, :] = lab[1:, :] != lab[:-1, :]
    boundary[:, :-1] |= lab[:, 1:] != lab[:, :-1]
    if lab.dtype.kind == "f":
        finite = np.isfinite(lab)
        ok = finite.copy()
        ok[:-1, :] &= finite[1:, :]
        ok[:, :-1] &= finite[:, 1:]
        boundary &= ok
    # the map is binary: percentile normalisation would zero it out
    # whenever edge pixels are under the 98th-percentile mass
    return boundary.astype(np.float32)


def rasterise_slic_gpkg(gpkg_path, tgt_profile) -> np.ndarray:
    """Burn GPKG polygons' ``segment_id`` onto the target grid, the layer
    reprojected to the grid's CRS first. Rows without a usable geometry or
    numeric id are dropped; an empty result is a SystemExit."""
    from ..geometry.transform_crs import to_raster_crs
    table = read_features(str(gpkg_path))
    if len(table) == 0:
        raise SystemExit(f"{gpkg_path}: no polygons intersect this grid")
    table = to_raster_crs(table, tgt_profile.get("crs"))

    def _usable():
        for geom, seg in zip(table.geometry, table["segment_id"]):
            if geom is None or geom.is_empty:
                continue
            try:
                yield geom, int(seg)
            except (TypeError, ValueError):
                continue

    shapes = list(_usable())
    if not shapes:
        raise SystemExit(
            f"{gpkg_path}: no rasterisable polygons carry a numeric "
            "'segment_id'")
    grid = (tgt_profile["height"], tgt_profile["width"])
    return rasterize(shapes, grid, transform=tgt_profile["transform"],
                     fill=0, dtype=np.uint32)


def _slic_edge_term(slic_src, tgt_profile) -> np.ndarray:
    """Edge term from either a SLIC GPKG or a label raster path."""
    if str(slic_src).lower().endswith(".gpkg"):
        labels = rasterise_slic_gpkg(slic_src, tgt_profile)
    else:
        labels, _ = read_band(slic_src)
    return slic_edge(labels)


def make_cost_surface(wv3, chm, out, slic=None,
                      weights=(0.5, 0.25, 0.25, 0), device=None) -> None:
    """Weighted cost surface, written as a float32 GeoTIFF with -9999
    nodata:

    cost = w0*(CHM Sobel gradient) + w1*(1 - NDVI) + w2*(rank entropy of
    the coastal band) + w3*(SLIC edge map).

    Without ``slic`` the first three weights are renormalised and a
    UserWarning is issued. The gradient and the entropy run on ``device``
    (the card unless ``device="cpu"``).
    """
    if len(weights) != 4:
        raise SystemExit(
            f"cost weights must be 4 values (gradient, 1-NDVI, entropy, "
            f"SLIC edge), got {len(weights)} — a short tuple would "
            "silently drop terms")
    if abs(sum(weights) - 1.0) > 1e-6:
        raise SystemExit(f"cost weights {tuple(weights)} must total 1")
    device = resolve_device(device)

    reader = TiffReader(str(wv3))
    stack = reader.read().astype(np.float32)
    if reader.nodata is not None:
        # NaN like read_band does for the CHM: raw -9999s would poison
        # NDVI and the entropy term's percentile normalisation
        stack = np.where(stack == reader.nodata, np.nan, stack)
    if stack.shape[2] < 8:
        raise SystemExit(
            f"{wv3}: expected the 8 WorldView-3 bands "
            "(C,B,G,Y,R,RE,N1,N2), got " + str(stack.shape[2]))
    profile = {"height": reader.height, "width": reader.width,
               "crs": reader.crs, "transform": reader.transform}

    chm_arr, _ = read_band(chm)
    terms = [
        chm_gradient(chm_arr, device),
        normalise(1.0 - ndvi(stack[:, :, _WV3_RED],
                             stack[:, :, _WV3_NIR1])),
        texture_entropy(stack[:, :, _WV3_COASTAL], device),
    ]
    w = [float(x) for x in weights]
    if slic:
        with telemetry.stage("cost.slic_edges", host_only=True):
            terms.append(_slic_edge_term(slic, profile))
    else:
        live = sum(w[:3])
        if live <= 0:
            raise ValueError(
                "weights put everything on the SLIC term but no `slic` "
                "layer was given — at least one of the first three "
                "weights must be positive without it")
        w = [x / live for x in w[:3]]
        warnings.warn("no SLIC layer given; renormalising the three "
                      "remaining cost weights")

    cost = sum(wi * ti for wi, ti in zip(w, terms))
    cost = np.clip(cost, 0.0, 1.0).astype(np.float32)
    # every term nan_to_nums internally, so cost itself is always finite:
    # mark the missing INPUT pixels as nodata, or the output claims valid
    # (0..1) cost over areas with no data at all
    valid = (np.isfinite(chm_arr)
             & np.isfinite(stack[:, :, _WV3_COASTAL])
             & np.isfinite(stack[:, :, _WV3_RED])
             & np.isfinite(stack[:, :, _WV3_NIR1]))
    cost = np.where(valid, cost, NODATA).astype(np.float32)

    out_path = Path(out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with telemetry.stage("cost.write", host_only=True):
        write_tiff(str(out_path), cost, transform=reader.transform,
                   crs=reader.crs, nodata=NODATA, compression="deflate")
    print(f"cost surface written -> {out_path} (nodata={NODATA})")
