"""Model-agnostic Kernel SHAP with the model evaluated on the device (port
of ``obia_tpu/classification/kernel_shap.py``).

Algorithm (Lundberg & Lee 2017, "A Unified Approach to Interpreting
Model Predictions"): Shapley values solve a weighted linear regression
over feature coalitions z in {0,1}^M with the Shapley kernel weight

    pi(z) = (M - 1) / (C(M, |z|) * |z| * (M - |z|)).

Missing features are integrated out over a background set. Coalition sizes
are enumerated completely, smallest pair first, while they fit the sample
budget; the rest is drawn from the leftover size distribution. The
coalitions and their weights are the reference's, bit for bit (the same
numpy generator, seeded with ``random_state``). The sum-to-f(x) constraint
is enforced by eliminating the last coefficient, so local accuracy
(base + sum(phi) == f(x)) holds exactly.

The synthetic rows ``where(Z[k], X[i], background)`` are built on the device,
in chunks of about ``batch_rows`` rows (one chunk may hold several explained
rows), and go through ``predict`` there; their mean over the background is
taken on the device in float64. Only the (S, n, C) means cross to the host,
where the weighted least squares runs in float64 numpy.
"""
from __future__ import annotations

from itertools import combinations
from math import comb
from typing import Callable, Optional

import numpy as np
import torch

from ..device import resolve_device


def _size_masses(M: int) -> np.ndarray:
    """Total Shapley-kernel mass per coalition size s = 1..M-1:
    pi(s) * C(M, s) = (M-1) / (s * (M-s)), normalised."""
    s = np.arange(1, M, dtype=np.float64)
    w = (M - 1) / (s * (M - s))
    return w / w.sum()


def _build_coalitions(M: int, nsamples: int, rng: np.random.Generator):
    """Coalition mask matrix Z (n, M) in {0,1} and per-row weights."""
    p = _size_masses(M)  # index s-1
    masks, weights = [], []
    enumerated = np.zeros(M - 1, bool)
    remaining = nsamples

    # paired complete enumeration: sizes (1, M-1), (2, M-2), ...
    for s in range(1, M // 2 + 1):
        sizes = [s] if s * 2 == M else [s, M - s]
        count = sum(comb(M, t) for t in sizes)
        if count > remaining:
            break
        for t in sizes:
            # all C(M, t) masks of size t via lexicographic combinations
            idx = np.fromiter(
                (i for c in combinations(range(M), t) for i in c),
                np.int64).reshape(-1, t)
            z = np.zeros((idx.shape[0], M), np.float64)
            np.put_along_axis(z, idx, 1.0, axis=1)
            masks.append(z)
            weights.append(np.full(idx.shape[0], p[t - 1] / comb(M, t)))
            enumerated[t - 1] = True
        remaining -= count

    left = ~enumerated
    if left.any() and remaining > 0:
        p_left = p[left] / p[left].sum()
        sizes_left = np.arange(1, M)[left]
        draw = rng.choice(sizes_left, size=remaining, p=p_left)
        z = np.zeros((remaining, M), np.float64)
        for i, t in enumerate(draw):
            z[i, rng.choice(M, size=t, replace=False)] = 1.0
        masks.append(z)
        weights.append(np.full(remaining, p[left].sum() / remaining))

    Z = np.concatenate(masks, axis=0)
    w = np.concatenate(weights, axis=0)
    return Z, w


def _rows(a, dtype, device) -> torch.Tensor:
    if torch.is_tensor(a):
        return a.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def kernel_shap(predict: Callable[[torch.Tensor], torch.Tensor],
                X, background, nsamples: Optional[int] = None,
                random_state: int = 0, batch_rows: int = 1 << 17,
                device=None) -> np.ndarray:
    """SHAP values for ``predict`` (e.g. a classifier's probabilities) at
    each row of ``X`` against a ``background`` distribution.

    ``predict`` maps an (r, M) tensor to an (r, C) tensor on the same
    device. A tensor ``X`` keeps its device and dtype; an array ``X`` is
    taken as float64, as the reference takes it, onto ``device`` (the card
    when None; ``"cpu"`` asks for the CPU). ``background`` follows ``X``.

    Returns (n_samples, n_features, n_outputs) float64 attributions that
    satisfy ``base + phi.sum(axis=1) == predict(X)`` (local accuracy), where
    ``base = predict(background).mean(axis=0)``.
    """
    if torch.is_tensor(X):
        dev, dtype = X.device, X.dtype
    else:
        dev, dtype = resolve_device(device), torch.float64
    X = _rows(X, dtype, dev)
    bg = _rows(background, dtype, dev)
    n, M = X.shape
    base = predict(bg).double().mean(dim=0)            # (C,)
    fx = predict(X).double()                           # (n, C)
    C = fx.shape[1]
    if M == 1:
        return (fx - base)[:, None, :].cpu().numpy()

    if nsamples is None:
        nsamples = min(2 * M + 2 ** 11, 2 ** min(M, 30) - 2)
    rng = np.random.default_rng(random_state)
    Z, w = _build_coalitions(M, int(nsamples), rng)
    S = Z.shape[0]
    B = bg.shape[0]

    # y[k, i, :] = E_bg[ f(where(Z[k], X[i], bg)) ], one (i, k) pair per
    # coalition of each explained row, pairs numbered i * S + k and cut
    # into chunks of about batch_rows synthetic rows
    Zd = torch.as_tensor(Z > 0, device=dev)
    pairs = n * S
    per_call = max(1, batch_rows // max(B, 1))
    y_dev = torch.empty((pairs, C), dtype=torch.float64, device=dev)
    for p0 in range(0, pairs, per_call):
        p = torch.arange(p0, min(p0 + per_call, pairs), device=dev)
        synth = torch.where(Zd[p % S][:, None, :], X[p // S][:, None, :],
                            bg[None, :, :])            # (kc, B, M)
        out = predict(synth.reshape(-1, M)).double()
        y_dev[p0:p0 + len(p)] = out.reshape(len(p), B, C).mean(dim=1)
    y = np.ascontiguousarray(                          # (S, n, C)
        y_dev.reshape(n, S, C).permute(1, 0, 2).cpu().numpy())
    fx = fx.cpu().numpy()
    base = base.cpu().numpy()

    # constrained weighted least squares, eliminating phi_{M-1}:
    #   sum(phi) = fx - base  =>  phi_{M-1} = (fx-base) - sum_{j<M-1} phi_j
    fxb = fx - base                                    # (n, C)
    y -= base
    y -= Z[:, -1][:, None, None] * fxb[None, :, :]
    Zp = Z[:, :-1] - Z[:, -1:]                         # (S, M-1)
    ZpW = Zp * w[:, None]
    A = ZpW.T @ Zp                                     # (M-1, M-1)
    b = ZpW.T @ y.reshape(S, n * C)                    # (M-1, n*C)
    phi_head = np.linalg.lstsq(A, b, rcond=None)[0].reshape(M - 1, n, C)
    phi_last = fxb[None] - phi_head.sum(axis=0, keepdims=True)
    phi = np.concatenate([phi_head, phi_last], axis=0)  # (M, n, C)
    return np.moveaxis(phi, 0, 1)                       # (n, M, C)
