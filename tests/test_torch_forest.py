"""obia_tpu_torch forest inference (classification/forest.py) against the
JAX reference and sklearn on the CPU.

Bars: a forest exported by the JAX package and carried across with
``forest_from_jax`` gives the JAX ``_forest_proba`` probabilities to atol
1e-6 (both average the same float32 leaf distributions over the trees);
the port's own sklearn export gives sklearn's ``predict_proba`` to atol
1e-5, the bar the JAX package's forest is held to.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from obia_tpu.classification import forest as jforest
from obia_tpu_torch.classification.forest import (ForestArrays,
                                                  TorchForestClassifier,
                                                  forest_from_jax,
                                                  forest_proba)


def data(seed, n=300, f=8, classes=2):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    score = X[:, 0] + 2 * X[:, 1] + rng.normal(0, 0.3, n)
    y = np.digitize(score, np.quantile(score, np.linspace(0, 1, classes + 1)
                                       [1:-1]))
    return X, y


@pytest.mark.parametrize("seed,classes,trees", [(0, 2, 25), (1, 3, 40)])
def test_forest_from_jax_matches_jax_proba(seed, classes, trees):
    X, y = data(seed, classes=classes)
    clf = jforest.JaxForestClassifier(n_estimators=trees, random_state=0)
    clf.fit(X[:200], y[:200])
    a = clf._arrays
    T, N, _ = a.leaf_proba.shape
    want = np.asarray(jforest._forest_proba(
        *a.device_arrays(), jnp.asarray(X[200:].astype(np.float32)),
        max_depth=a.max_depth, n_trees=T, n_nodes=N))
    got = forest_proba(forest_from_jax(a, device="cpu"), torch.as_tensor(X[200:]))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


@pytest.mark.parametrize("seed", [2, 3])
def test_torch_forest_matches_sklearn(seed):
    X, y = data(seed)
    clf = TorchForestClassifier(n_estimators=25, random_state=0,
                                device="cpu")
    clf.fit(X[:200], y[:200])
    want = clf._skl.predict_proba(X[200:])
    np.testing.assert_allclose(clf.predict_proba(X[200:]), want, atol=1e-5)
    np.testing.assert_array_equal(clf.predict(X[200:]),
                                  clf._skl.predict(X[200:]))


def test_fit_cache_reuses_a_seeded_fit():
    X, y = data(4)
    a = TorchForestClassifier(n_estimators=10, random_state=3,
                              device="cpu").fit(X, y)
    b = TorchForestClassifier(n_estimators=10, random_state=3,
                              device="cpu").fit(X, y)
    assert a._skl is b._skl
    np.testing.assert_array_equal(a.predict_proba(X), b.predict_proba(X))


def test_forest_arrays_to_keeps_tables():
    X, y = data(5)
    clf = TorchForestClassifier(n_estimators=5, random_state=0,
                                device="cpu").fit(X, y)
    moved = clf._arrays.to("cpu")
    assert isinstance(moved, ForestArrays)
    assert moved.max_depth == clf._arrays.max_depth
    assert torch.equal(moved.feature, clf._arrays.feature)


def test_unfitted_classifier_raises():
    from sklearn.exceptions import NotFittedError
    with pytest.raises(NotFittedError):
        TorchForestClassifier(n_estimators=3, device="cpu").predict_proba(np.zeros((2, 3)))
