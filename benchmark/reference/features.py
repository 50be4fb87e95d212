"""Per-object features in plain torch, by the configuration's definitions.

Spectral, per object and band: mean, variance (ddof 0), min, max,
skewness (Fisher-Pearson g1) and kurtosis (Fisher excess g2), both biased,
as scipy defines them; NaN skewness and kurtosis for zero variance.

Texture, per object and band (skimage's ``graycomatrix`` and
``graycoprops``): each object quantised by its own minimum and maximum to
256 levels, ``floor((v - min) * (255 / (max - min)))`` in the data's
float32; pairs at distance 2 and angles 0, 45, 90 and 135 degrees that
lie wholly inside the object; the symmetric, normalised co-occurrence
matrix; contrast, dissimilarity, homogeneity, ASM, energy and correlation
(1 where the variance is under 1e-15), averaged over the angles that have
pairs, NaN where none has. The matrix is built from the counts of each
(object, level, level) pair, so no table of 256 x 256 per object exists.
"""
from __future__ import annotations

import math

import torch

from . import REFERENCE, Precision

SPECTRAL = ("mean", "variance", "min", "max", "skewness", "kurtosis")
TEXTURE = ("contrast", "dissimilarity", "homogeneity", "ASM", "energy",
           "correlation")
BLOCK = 1 << 23  # pixels whose float64 rows exist at once


def column_names(spectral_bands, texture_bands) -> list:
    """The feature columns in the table's order: each band's spectral
    features, then each band's texture features."""
    return ([f"b{b}_{s}" for b in spectral_bands for s in SPECTRAL]
            + [f"b{b}_{t}" for b in texture_bands for t in TEXTURE])


def spectral(scene: torch.Tensor, labels: torch.Tensor, K: int, bands,
             p: Precision = REFERENCE) -> dict:
    """{"b{b}_{stat}": (K,) p.acc} of the uint8 scene's ``bands``."""
    C = len(bands)
    x = scene[:, :, list(bands)].reshape(-1, C)
    lab = labels.reshape(-1).long()
    N = lab.numel()
    dev = labels.device
    cnt = torch.bincount(lab, minlength=K).to(p.acc)
    s1 = torch.zeros((K, C), dtype=p.acc, device=dev)
    for i in range(0, N, BLOCK):
        s1.index_add_(0, lab[i:i + BLOCK], x[i:i + BLOCK].to(p.ft).to(p.acc))
    mean = s1 / cnt.clamp(min=1)[:, None]
    m = torch.zeros((K, 3 * C), dtype=p.acc, device=dev)
    for i in range(0, N, BLOCK):
        li = lab[i:i + BLOCK]
        d = x[i:i + BLOCK].to(p.ft).to(p.acc) - mean[li]
        d2 = d * d
        m.index_add_(0, li, torch.cat([d2, d2 * d, d2 * d2], dim=1))
    m = m / cnt.clamp(min=1)[:, None]
    m2, m3, m4 = m[:, :C], m[:, C:2 * C], m[:, 2 * C:]
    big = torch.finfo(p.ft).max
    xf = x.to(p.ft)
    idx = lab[:, None].expand(-1, C)
    xmin = torch.full((K, C), big, dtype=p.ft, device=dev).scatter_reduce_(
        0, idx, xf, "amin")
    xmax = torch.full((K, C), -big, dtype=p.ft, device=dev).scatter_reduce_(
        0, idx, xf, "amax")
    flat = m2 <= 0
    nan = torch.full_like(m2, math.nan)
    safe = torch.where(flat, 1.0, m2)
    stats = {"mean": mean, "variance": m2, "min": xmin.to(p.acc),
             "max": xmax.to(p.acc),
             "skewness": torch.where(flat, nan, m3 / safe ** 1.5),
             "kurtosis": torch.where(flat, nan, m4 / safe ** 2 - 3.0)}
    empty = (cnt == 0)[:, None]
    return {f"b{b}_{s}": torch.where(empty, nan, v)[:, j]
            for s, v in stats.items() for j, b in enumerate(bands)}


def _offsets(distance: int, angles_deg) -> list:
    return [(int(round(math.sin(math.radians(a)) * distance)),
             int(round(math.cos(math.radians(a)) * distance)))
            for a in angles_deg]


def levels(v: torch.Tensor, lab: torch.Tensor, K: int, n_levels: int,
           p: Precision = REFERENCE) -> torch.Tensor:
    """(H, W) int64 grey level of each pixel within its own object."""
    v = v.to(p.ft)
    flat = lab.reshape(-1)
    vf = v.reshape(-1)
    big = torch.finfo(p.ft).max
    lo = torch.full((K,), big, dtype=p.ft, device=v.device).scatter_reduce_(
        0, flat, vf, "amin")
    hi = torch.full((K,), -big, dtype=p.ft, device=v.device).scatter_reduce_(
        0, flat, vf, "amax")
    rng = hi - lo
    inv = torch.where(rng > 0, torch.tensor(n_levels - 1, dtype=p.ft,
                                            device=v.device)
                      / torch.where(rng > 0, rng, 1.0), 0.0).to(p.ft)
    q = torch.floor((vf - lo[flat]) * inv[flat])
    return q.clamp(0, n_levels - 1).long().view(v.shape)


def texture(scene: torch.Tensor, labels: torch.Tensor, K: int, bands,
            glcm: dict, p: Precision = REFERENCE) -> dict:
    """{"b{b}_{prop}": (K,) p.acc} of the uint8 scene's ``bands``."""
    L = int(glcm["levels"])
    offs = _offsets(int(glcm["distance"]), glcm["angles_deg"])
    lab = labels.long()
    H, W = lab.shape
    out = {}
    for b in bands:
        q = levels(scene[:, :, b], lab, K, L, p)
        per_angle = []
        for dr, dc in offs:
            r0, r1 = max(0, -dr), min(H, H - dr)
            c0, c1 = max(0, -dc), min(W, W - dc)
            a = lab[r0:r1, c0:c1]
            same = a == lab[r0 + dr:r1 + dr, c0 + dc:c1 + dc]
            k = a[same]
            i = q[r0:r1, c0:c1][same]
            j = q[r0 + dr:r1 + dr, c0 + dc:c1 + dc][same]
            key = (k * L + torch.minimum(i, j)) * L + torch.maximum(i, j)
            del k, i, j, same, a
            key, t = torch.unique(key, return_counts=True)
            per_angle.append(_props(key, t.to(p.acc), K, L, p))
        out.update(_average(per_angle, b))
    return out


def _props(key, t, K: int, L: int, p: Precision) -> dict:
    """The six props of each object at one angle from the counts ``t`` of
    its unordered level pairs ``key`` = (k L + lo) L + hi."""
    k = key // (L * L)
    lo = ((key // L) % L).to(p.acc)
    hi = (key % L).to(p.acc)
    dev = key.device

    def per_object(v):
        return torch.zeros(K, dtype=p.acc, device=dev).index_add_(0, k, v)

    n = per_object(t)
    safe = n.clamp(min=1)
    d = hi - lo
    diag = lo == hi
    mu = per_object(t * (lo + hi)) / (2 * safe)
    mk = mu[k]
    var = per_object(t * ((lo - mk) ** 2 + (hi - mk) ** 2)) / (2 * safe)
    cov = per_object(t * (lo - mk) * (hi - mk)) / safe
    asm = per_object(torch.where(diag, (2 * t) ** 2, 2 * t * t)) / (
        2 * safe) ** 2
    flat = var < 1e-15
    return {"n": n,
            "contrast": per_object(t * d * d) / safe,
            "dissimilarity": per_object(t * d.abs()) / safe,
            "homogeneity": per_object(t / (1 + d * d)) / safe,
            "ASM": asm, "energy": torch.sqrt(asm),
            "correlation": torch.where(flat, 1.0,
                                       cov / torch.where(flat, 1.0, var))}


def _average(per_angle: list, b: int) -> dict:
    has = torch.stack([a["n"] > 0 for a in per_angle])
    n_ok = has.sum(0)
    out = {}
    for prop in TEXTURE:
        v = torch.stack([a[prop] for a in per_angle])
        avg = torch.where(has, v, 0.0).sum(0) / n_ok.clamp(min=1)
        out[f"b{b}_{prop}"] = torch.where(n_ok > 0, avg, math.nan)
    return out


def features(scene: torch.Tensor, labels: torch.Tensor, K: int,
             config: dict, p: Precision = REFERENCE) -> dict:
    """Every feature column of the configuration, (K,) each, for the
    objects 0..K-1 of ``labels`` over the uint8 ``scene``."""
    bands = config["segment"].get("statistics_bands") or list(
        range(scene.shape[2]))
    texture_bands = list(range(scene.shape[2]))
    out = spectral(scene, labels, K, bands, p)
    out.update(texture(scene, labels, K, texture_bands, config["glcm"], p))
    return {c: out[c] for c in column_names(bands, texture_bands)}
