"""MLP classifier in torch (port of ``obia_tpu/classification/mlp.py``).

An ``nn.Module`` of ``nn.Linear`` layers with an sklearn-``MLPClassifier``
surface, fitted with ``torch.optim.Adam`` (optax's defaults: betas 0.9 and
0.999, eps 1e-8) on ``device``. Defaults mirror sklearn: hidden (100,),
relu, learning_rate_init 1e-3, alpha (L2) 1e-4, max_iter 200, batch 200.

The fit is the reference's, step for step: lecun-normal kernels (truncated
normal) and zero biases, drawn from a ``torch.Generator`` seeded with
``random_state`` (not JAX's bits, so weights differ from the reference's
unless carried across with :func:`mlp_from_flax`); one
``np.random.default_rng(random_state)`` permutation per epoch, cut into
batches whose tail is simply shorter; each batch's loss is the mean
softmax cross-entropy plus ``alpha / 2 * sum(W^2) / batch_rows`` over the
weight matrices only (never the biases); the epoch loss is the mean of the
batch losses. The sklearn ``tol`` / ``n_iter_no_change`` rule stops at the
exact epoch: the reference stops on a 10-epoch chunk boundary, which only
saved TPU dispatches.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device

_ACTIVATIONS = {
    "relu": torch.relu,
    "tanh": torch.tanh,
    "logistic": torch.sigmoid,
    "identity": lambda x: x,
}


class MLP(nn.Module):
    """Dense layers of widths ``hidden`` with ``activation`` between them,
    then a linear layer to ``n_classes`` logits (reference ``_MLP``)."""

    def __init__(self, n_features: int, hidden: Sequence[int],
                 n_classes: int, activation: str = "relu"):
        super().__init__()
        if activation not in _ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}")
        widths = [n_features, *hidden, n_classes]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in
                                    zip(widths[:-1], widths[1:]))
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = _ACTIVATIONS[self.activation]
        for layer in self.layers[:-1]:
            x = act(layer(x))
        return self.layers[-1](x)


def _init_params(model: MLP, random_state: int) -> None:
    """Flax's ``nn.Dense`` init: lecun-normal kernels (a normal truncated
    at two standard deviations, scaled so the variance is 1 / fan_in) and
    zero biases, drawn layer by layer from one seeded generator."""
    g = torch.Generator().manual_seed(int(random_state))
    with torch.no_grad():
        for layer in model.layers:
            w = torch.empty(layer.weight.shape)
            std = math.sqrt(1.0 / layer.in_features) / .87962566103423978
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=g)
            layer.weight.copy_(w)
            layer.bias.zero_()


class TorchMLPClassifier:
    """sklearn-style MLP: ``fit``, ``predict_proba``, ``predict``,
    ``get_params`` and ``classes_``; fit and inference run on ``device``
    (the card when None; ``"cpu"`` asks for the CPU)."""

    def __init__(self, hidden_layer_sizes=(100,), activation="relu",
                 alpha=1e-4, learning_rate_init=1e-3, max_iter=200,
                 batch_size="auto", random_state=0, tol=1e-4,
                 n_iter_no_change=10, device=None, **_ignored):
        self.hidden = tuple(int(h) for h in (
            hidden_layer_sizes if isinstance(hidden_layer_sizes, (tuple, list))
            else (hidden_layer_sizes,)))
        self.activation = activation
        self.alpha = float(alpha)
        self.lr = float(learning_rate_init)
        self.max_iter = int(max_iter)
        self.batch_size = batch_size
        self.random_state = int(random_state or 0)
        self.tol = float(tol)
        self.n_iter_no_change = int(n_iter_no_change)
        self.device = resolve_device(device)
        self._model: Optional[MLP] = None
        self.classes_ = None

    def get_params(self) -> dict:
        return {
            "hidden_layer_sizes": self.hidden, "activation": self.activation,
            "alpha": self.alpha, "learning_rate_init": self.lr,
            "max_iter": self.max_iter, "random_state": self.random_state,
        }

    def fit(self, X, y) -> "TorchMLPClassifier":
        X = np.asarray(X, np.float32)
        y = np.asarray(y)
        # seeded fits of the same table are memoised, keyed as the
        # reference keys them, plus the device (fits on two devices round
        # differently)
        from .forest import _FIT_CACHE, _FIT_CACHE_MAX, _fit_cache_key
        key = _fit_cache_key(
            {"mlp": True, "random_state": self.random_state,
             "batch_size": self.batch_size, "tol": self.tol,
             "n_iter_no_change": self.n_iter_no_change,
             "device": str(self.device), **self.get_params()}, X, y)
        hit = _FIT_CACHE.get(key) if key is not None else None
        if hit is not None:
            self._model, self.classes_ = hit
            return self
        self._fit_impl(X, y)
        if key is not None:
            if len(_FIT_CACHE) >= _FIT_CACHE_MAX:
                _FIT_CACHE.pop(next(iter(_FIT_CACHE)))
            _FIT_CACHE[key] = (self._model, self.classes_)
        return self

    def _fit_impl(self, X: np.ndarray, y: np.ndarray) -> None:
        self.classes_, y_idx = np.unique(y, return_inverse=True)
        n, f = X.shape
        model = MLP(f, self.hidden, len(self.classes_), self.activation)
        _init_params(model, self.random_state)
        model.to(self.device)
        kernels = [layer.weight for layer in model.layers]
        opt = torch.optim.Adam(model.parameters(), lr=self.lr,
                               betas=(0.9, 0.999), eps=1e-8)
        bs = min(200, n) if self.batch_size == "auto" else min(
            int(self.batch_size), n)
        Xd = torch.as_tensor(X, device=self.device)
        yd = torch.as_tensor(y_idx, dtype=torch.int64, device=self.device)
        rng = np.random.default_rng(self.random_state)
        n_batches = -(-n // bs)
        best = np.inf
        stale = 0
        for _ in range(self.max_iter):
            perm = torch.as_tensor(rng.permutation(n), device=self.device)
            total = torch.zeros((), device=self.device)
            for b in range(n_batches):
                idx = perm[b * bs:(b + 1) * bs]
                loss = F.cross_entropy(model(Xd[idx]), yd[idx]) + sum(
                    (w * w).sum() for w in kernels) * (
                        self.alpha / 2) / idx.numel()
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
                total = total + loss.detach()
            epoch_loss = float(total) / n_batches
            # sklearn's rule: stale counts epochs not better than
            # best - tol; best follows every improvement
            if epoch_loss > best - self.tol:
                stale += 1
            else:
                stale = 0
            best = min(best, epoch_loss)
            if stale >= self.n_iter_no_change:
                break
        model.eval()
        self._model = model

    def to(self, device) -> "TorchMLPClassifier":
        """A copy of this fitted classifier with its model on ``device``."""
        import copy
        clf = copy.copy(self)
        clf.device = torch.device(device)
        clf._model = copy.deepcopy(self._model).to(clf.device)
        return clf

    def proba_tensor(self, x: torch.Tensor) -> torch.Tensor:
        """Class probabilities of the rows of ``x`` on the model's device:
        the logits, then a float32 softmax in the reference's max-subtract
        form. ``predict_proba`` and Kernel SHAP both call this."""
        if self._model is None:
            raise RuntimeError("This TorchMLPClassifier instance is not "
                               "fitted yet. Call 'fit' first.")
        with torch.no_grad():
            logits = self._model(x.to(self.device, torch.float32))
            z = logits - logits.amax(dim=1, keepdim=True)
            e = torch.exp(z)
            return e / e.sum(dim=1, keepdim=True)

    def predict_proba(self, X) -> np.ndarray:
        return self.proba_tensor(torch.as_tensor(
            np.asarray(X, np.float32))).cpu().numpy()

    def predict(self, X) -> np.ndarray:
        return self.classes_[np.argmax(self.predict_proba(X), axis=1)]

    # -- checkpointing, in the reference's layout -------------------------
    def save(self, path: str) -> None:
        """The weights as the reference saves its Flax variables
        (``params/params/Dense_i/{kernel, bias}``, kernels (in, out)) in
        ``path.npz``, and a ``path.meta.json`` sidecar with the classes and
        the hyper-parameters the network depends on."""
        import json

        from ..checkpoint import save_pytree
        dense = {f"Dense_{i}": {"kernel": layer.weight.detach().cpu().numpy().T,
                                "bias": layer.bias.detach().cpu().numpy()}
                 for i, layer in enumerate(self._model.layers)}
        save_pytree(path, {"params": {"params": dense}})
        meta = {"classes": np.asarray(self.classes_).tolist(),
                "hidden": list(self.hidden),
                "activation": self.activation,
                "alpha": self.alpha,
                "learning_rate_init": self.lr}
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f)

    def load(self, path: str) -> "TorchMLPClassifier":
        """Restore a checkpoint written by :meth:`save`, or by the
        reference's ``FlaxMLPClassifier.save`` on its ``.npz`` path, onto
        this classifier's device."""
        import json

        from ..checkpoint import load_pytree
        with open(path + ".meta.json") as f:
            meta = json.load(f)
        self.classes_ = np.asarray(meta["classes"])
        self.hidden = tuple(int(h) for h in meta["hidden"])
        self.activation = str(meta["activation"])
        self.alpha = float(meta["alpha"])
        self.lr = float(meta["learning_rate_init"])
        state = load_pytree(path)
        self._model = mlp_from_flax(state["params"], self.classes_,
                                    self.hidden, self.activation,
                                    device=self.device)._model
        return self


def mlp_from_flax(params, classes, hidden, activation: str = "relu",
                  device=None) -> TorchMLPClassifier:
    """A fitted classifier from the reference's Flax parameters
    (``FlaxMLPClassifier._params``: ``{"params": {"Dense_i": {"kernel",
    "bias"}}}``, kernels (in, out)) and its ``classes_``, on ``device``
    (the card when None)."""
    tree = params["params"] if "params" in params else params
    dense = [tree[f"Dense_{i}"] for i in range(len(tree))]
    n_features = np.asarray(dense[0]["kernel"]).shape[0]
    clf = TorchMLPClassifier(hidden_layer_sizes=tuple(hidden),
                             activation=activation, device=device)
    clf.classes_ = np.asarray(classes)
    model = MLP(n_features, clf.hidden, len(clf.classes_), activation)
    with torch.no_grad():
        for layer, d in zip(model.layers, dense):
            layer.weight.copy_(torch.tensor(np.array(d["kernel"]).T))
            layer.bias.copy_(torch.tensor(np.array(d["bias"])))
    clf._model = model.to(clf.device).eval()
    return clf
