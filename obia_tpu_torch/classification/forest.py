"""Random-forest inference in torch (port of
``obia_tpu/classification/forest.py``).

The forest is fitted on the host with sklearn and exported to dense
(n_trees, n_nodes) tables; inference walks every object through every tree
at once, one depth level per step, with ``torch.gather``. In OBIA the fitted
forest is the model, so :func:`forest_from_jax` also carries a forest
exported by the JAX package across unchanged.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import telemetry
from ..device import resolve_device


class ForestArrays:
    """Dense forest tables: feature (T, N) int64 (-1 at leaves), threshold
    (T, N) float32, left/right (T, N) int64 (leaves point to themselves),
    leaf_proba (T, N, C) float32, the class labels, and the depth."""

    def __init__(self, feature, threshold, left, right, leaf_proba, classes,
                 max_depth: int):
        self.feature = feature
        self.threshold = threshold
        self.left = left
        self.right = right
        self.leaf_proba = leaf_proba
        self.classes = np.asarray(classes)
        self.max_depth = int(max_depth)

    def to(self, device) -> "ForestArrays":
        """The same forest with its tables on ``device``."""
        return ForestArrays(*(t.to(device) for t in (
            self.feature, self.threshold, self.left, self.right,
            self.leaf_proba)), self.classes, self.max_depth)

    @classmethod
    def from_numpy(cls, feature, threshold, left, right, leaf_proba, classes,
                   max_depth: int, device=None) -> "ForestArrays":
        """The tables on ``device`` (the card when None)."""
        dev = resolve_device(device)

        def t(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        return cls(t(feature, torch.int64), t(threshold, torch.float32),
                   t(left, torch.int64), t(right, torch.int64),
                   t(leaf_proba, torch.float32), classes, max_depth)

    @classmethod
    def from_sklearn(cls, rf, device=None) -> "ForestArrays":
        """Export a fitted ``sklearn.ensemble.RandomForestClassifier`` to
        ``device`` (the card when None)."""
        trees = [est.tree_ for est in rf.estimators_]
        T = len(trees)
        N = max(t.node_count for t in trees)
        C = len(rf.classes_)
        feature = np.full((T, N), -1, np.int64)
        threshold = np.zeros((T, N), np.float32)
        left = np.zeros((T, N), np.int64)
        right = np.zeros((T, N), np.int64)
        proba = np.zeros((T, N, C), np.float32)
        for t, tr in enumerate(trees):
            n = tr.node_count
            idx = np.arange(n)
            feature[t, :n] = tr.feature
            threshold[t, :n] = tr.threshold
            left[t, :n] = np.where(tr.children_left < 0, idx,
                                   tr.children_left)
            right[t, :n] = np.where(tr.children_right < 0, idx,
                                    tr.children_right)
            v = tr.value[:, 0, :].astype(np.float64)
            proba[t, :n] = (v / np.maximum(v.sum(axis=1, keepdims=True),
                                           1e-12)).astype(np.float32)
        depth = max(max(int(tr.max_depth) for tr in trees), 1)
        return cls.from_numpy(feature, threshold, left, right, proba,
                              rf.classes_, depth, device)


def forest_from_jax(arrays, device=None) -> ForestArrays:
    """Carry a forest exported by ``obia_tpu.classification.forest.
    ForestArrays`` (numpy fields) into the port's tensors on ``device``
    (the card when None)."""
    return ForestArrays.from_numpy(arrays.feature, arrays.threshold,
                                   arrays.left, arrays.right,
                                   arrays.leaf_proba, arrays.classes,
                                   arrays.max_depth, device)


@telemetry.timed("forest.predict")
def forest_proba(forest: ForestArrays, X: torch.Tensor) -> torch.Tensor:
    """(B, F) features -> (B, C) mean leaf distribution over the trees.
    Level-synchronous: each step moves every (object, tree) pair one level
    down; leaves point to themselves, so extra steps change nothing."""
    X = X.to(device=forest.feature.device, dtype=torch.float32)
    B = X.shape[0]
    T = forest.feature.shape[0]
    tree = torch.arange(T, device=X.device)[None, :].expand(B, T)
    node = torch.zeros((B, T), dtype=torch.int64, device=X.device)
    for _ in range(forest.max_depth):
        f = forest.feature[tree, node]
        xv = torch.gather(X, 1, f.clamp(min=0))
        nxt = torch.where(xv <= forest.threshold[tree, node],
                          forest.left[tree, node], forest.right[tree, node])
        node = torch.where(f < 0, node, nxt)
    return forest.leaf_proba[tree, node].mean(dim=1)


# fitted-forest cache: refitting the same table with the same seeded
# hyper-parameters is pure recomputation, so deterministic fits are memoised
_FIT_CACHE: dict = {}
_FIT_CACHE_MAX = 8


def _fit_cache_key(params: dict, X: np.ndarray, y: np.ndarray):
    if not isinstance(params.get("random_state"), (int, np.integer)):
        return None  # unseeded (or a generator instance): not repeatable
    import hashlib
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(X).tobytes())
    h.update(np.ascontiguousarray(y).tobytes())
    return (repr(sorted(params.items())), X.shape, str(X.dtype),
            y.shape, str(y.dtype), h.hexdigest())


class TorchForestClassifier:
    """sklearn-compatible facade: host ``fit`` (sklearn, memoised for
    seeded refits of the same table), ``predict_proba``/``predict`` on
    ``device`` (the card when None; ``"cpu"`` asks for the CPU). The
    constructor imports sklearn, so it raises ``ImportError`` where sklearn
    is not installed."""

    def __init__(self, device=None, **kwargs):
        from sklearn.ensemble import RandomForestClassifier
        self.device = resolve_device(device)
        self._skl = RandomForestClassifier(**kwargs)
        self._arrays: Optional[ForestArrays] = None

    def fit(self, X, y):
        X = np.asarray(X)
        y = np.asarray(y)
        key = _fit_cache_key(self._skl.get_params(), X, y)
        hit = _FIT_CACHE.get(key) if key is not None else None
        if hit is not None:
            self._skl, host = hit
        else:
            if hasattr(self._skl, "estimators_"):
                # the estimator may be shared with a cache entry: refit a
                # clone, never the shared object
                from sklearn.base import clone
                self._skl = clone(self._skl)
            self._skl.fit(X, y)
            host = ForestArrays.from_sklearn(self._skl, device="cpu")
            if key is not None:
                if len(_FIT_CACHE) >= _FIT_CACHE_MAX:
                    _FIT_CACHE.pop(next(iter(_FIT_CACHE)))
                _FIT_CACHE[key] = (self._skl, host)
        self._arrays = host.to(self.device)
        return self

    @property
    def classes_(self):
        return self._skl.classes_

    @property
    def sklearn_model(self):
        """The fitted ``RandomForestClassifier`` (TreeSHAP reads its
        trees)."""
        return self._skl

    def get_params(self) -> dict:
        return self._skl.get_params()

    def predict_proba(self, X) -> np.ndarray:
        if self._arrays is None:
            from sklearn.exceptions import NotFittedError
            raise NotFittedError("This TorchForestClassifier instance is not "
                                 "fitted yet. Call 'fit' first.")
        X = torch.as_tensor(np.asarray(X, np.float32), device=self.device)
        return forest_proba(self._arrays, X).cpu().numpy()

    def predict(self, X) -> np.ndarray:
        return self.classes_[np.argmax(self.predict_proba(X), axis=1)]
