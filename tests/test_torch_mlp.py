"""obia_tpu_torch's MLP classifier against the JAX package's Flax MLP.

Bars: weights carried with ``mlp_from_flax`` give JAX's ``predict_proba`` to
atol 1e-6 (float32 logits of unit-scale features; both softmaxes run on the
host in float32); one training epoch from the same parameters, on the same
numpy permutation, lands within rtol 1e-4 / atol 1e-6 of JAX's parameters
(Adam's update in another rounding order); a full fit reaches the accuracy
bar of tests/test_classification.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obia_tpu.classification import mlp as jmlp
from obia_tpu_torch.classification import forest as tforest
from obia_tpu_torch.classification import mlp as tmlp


def table(n=450, f=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = np.where(X[:, 0] + X[:, 1] > 0, "a", "b")
    return X, y


def flax_layers(params):
    tree = params["params"]
    return [tree[f"Dense_{i}"] for i in range(len(tree))]


@pytest.mark.parametrize("hidden,activation", [((32,), "relu"),
                                               ((16, 8), "tanh"),
                                               ((12,), "logistic"),
                                               ((10,), "identity")])
def test_carried_weights_give_jax_proba(hidden, activation):
    X, y = table()
    jc = jmlp.FlaxMLPClassifier(hidden_layer_sizes=hidden,
                                activation=activation, max_iter=20,
                                random_state=0).fit(X, y)
    tc = tmlp.mlp_from_flax(jc._params, jc.classes_, hidden, activation,
                            device="cpu")
    np.testing.assert_allclose(tc.predict_proba(X), jc.predict_proba(X),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tc.predict(X), jc.predict(X))


@pytest.mark.parametrize("n,batch_size,alpha", [(450, "auto", 1e-2),
                                                (300, 64, 1e-4)])
def test_one_epoch_matches_jax(monkeypatch, n, batch_size, alpha):
    """The port's fit (max_iter=1) from JAX's initial parameters against
    JAX's ``train_chunk`` for one epoch on the same permutation."""
    X, y = table(n)
    y_idx = np.unique(y, return_inverse=True)[1]
    hidden, lr, seed = (16, 8), 1e-3, 5
    model, tx, train_chunk = jmlp._train_fns(hidden, "relu", 2, alpha, lr)
    params = model.init(jax.random.PRNGKey(3), jnp.zeros((1, X.shape[1])))
    bs = min(200, n) if batch_size == "auto" else batch_size
    nb = -(-n // bs)
    perm = np.random.default_rng(seed).permutation(n)
    idx = np.concatenate([perm, np.zeros(nb * bs - n, np.int64)]).reshape(
        1, nb, bs)
    w = (np.arange(nb * bs) < n).astype(np.float32).reshape(1, nb, bs)
    want, _, _ = train_chunk(params, tx.init(params), jnp.asarray(X[idx]),
                             jnp.asarray(y_idx[idx]), jnp.asarray(w),
                             jnp.float32(nb))

    def inject(model, random_state):
        with torch.no_grad():
            for layer, d in zip(model.layers, flax_layers(params)):
                layer.weight.copy_(torch.tensor(np.array(d["kernel"]).T))
                layer.bias.copy_(torch.tensor(np.array(d["bias"])))

    monkeypatch.setattr(tmlp, "_init_params", inject)
    clf = tmlp.TorchMLPClassifier(hidden_layer_sizes=hidden, alpha=alpha,
                                  learning_rate_init=lr, max_iter=1,
                                  batch_size=batch_size, random_state=seed,
                                  device="cpu")
    clf.fit(X, y)
    for layer, d, d0 in zip(clf._model.layers, flax_layers(want),
                            flax_layers(params)):
        k = np.asarray(d["kernel"]).T
        assert np.abs(k - np.asarray(d0["kernel"]).T).max() > 1e-4  # moved
        np.testing.assert_allclose(layer.weight.detach().numpy(), k,
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(layer.bias.detach().numpy(),
                                   np.asarray(d["bias"]), rtol=1e-4,
                                   atol=1e-6)


def test_init_is_lecun_normal_and_seeded():
    m = tmlp.MLP(400, (300,), 2)
    tmlp._init_params(m, 0)
    w = m.layers[0].weight.detach()
    assert abs(float(w.std()) - (1 / 400) ** 0.5) < 2e-3
    assert float(w.abs().max()) <= 2 * (1 / 400) ** 0.5 / .87962566103423978
    assert float(m.layers[0].bias.detach().abs().max()) == 0.0
    m2 = tmlp.MLP(400, (300,), 2)
    tmlp._init_params(m2, 0)
    assert torch.equal(m2.layers[0].weight, m.layers[0].weight)


def test_fit_learns_like_the_reference():
    """The case of tests/test_classification.py::test_flax_mlp_learns."""
    rng = np.random.default_rng(42)
    X = rng.normal(size=(400, 4)).astype(np.float32)
    y = np.where(X[:, 0] + X[:, 1] > 0, "a", "b")
    clf = tmlp.TorchMLPClassifier(hidden_layer_sizes=(32,), max_iter=100,
                                  random_state=0, device="cpu")
    clf.fit(X[:300], y[:300])
    assert (clf.predict(X[300:]) == y[300:]).mean() > 0.9
    proba = clf.predict_proba(X[300:])
    np.testing.assert_allclose(proba.sum(axis=1), 1.0, atol=1e-5)


def test_predict_returns_classes():
    X, y = table(200)
    clf = tmlp.TorchMLPClassifier(hidden_layer_sizes=(8,), max_iter=5,
                                  device="cpu")
    clf.fit(X, y)
    assert list(clf.classes_) == ["a", "b"]
    assert set(clf.predict(X)) <= {"a", "b"}
    assert clf.get_params()["hidden_layer_sizes"] == (8,)


def test_fit_cache_hits_and_misses():
    X, y = table(240, seed=1)
    kw = dict(hidden_layer_sizes=(8,), max_iter=3, random_state=2,
              device="cpu")
    a = tmlp.TorchMLPClassifier(**kw).fit(X, y)
    b = tmlp.TorchMLPClassifier(**kw).fit(X, y)
    assert b._model is a._model
    c = tmlp.TorchMLPClassifier(alpha=1e-3, **kw).fit(X, y)
    assert c._model is not a._model
    d = tmlp.TorchMLPClassifier(tol=1e-2, **kw).fit(X, y)
    assert d._model is not a._model
    assert len(tforest._FIT_CACHE) <= tforest._FIT_CACHE_MAX


def test_stops_at_the_exact_epoch(monkeypatch):
    """A zero learning rate keeps the loss flat, so the stale rule stops
    after n_iter_no_change + 1 epochs, not at a chunk boundary."""
    X, y = table(100)
    epochs = []
    real = np.random.default_rng

    class Counting:
        def __init__(self, seed):
            self.rng = real(seed)

        def permutation(self, n):
            epochs.append(n)
            return self.rng.permutation(n)

    monkeypatch.setattr(tmlp.np.random, "default_rng", Counting)
    tmlp.TorchMLPClassifier(hidden_layer_sizes=(4,), learning_rate_init=0.0,
                            max_iter=50, n_iter_no_change=3,
                            random_state=None, device="cpu").fit(X, y)
    assert len(epochs) == 4


def test_unfitted_predict_raises():
    with pytest.raises(RuntimeError, match="not fitted"):
        tmlp.TorchMLPClassifier(device="cpu").predict_proba(np.zeros((2, 3)))
