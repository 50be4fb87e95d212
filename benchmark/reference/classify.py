"""The classify tail in plain numpy and torch: the training table, the
seeded stand-in forest and its traversal, and the (64,) MLP's seeded start
and fit.

``training_table`` and ``forest_fields`` are frozen copies of
``obia_tpu_torch/bench.py``'s, taking columns by name instead of the
program's table; the benchmark's driver feeds the program's classifiers
through the same two functions, so both sides start from the same recipe.
The MLP fit follows sklearn's ``MLPClassifier`` as the configuration
states it, in float32 and in a fixed order of operations, because a fit
of 60 epochs on the raw features amplifies a difference in the last bit
into a different model: lecun-normal kernels
(a normal truncated at two standard deviations) and zero biases drawn
from a CPU ``torch.Generator`` seeded with the classifier's seed; Adam
(0.9, 0.999, 1e-8) at 1e-3; batches of min(200, n) rows from one
``numpy.random.default_rng(seed)`` permutation an epoch; the loss the mean
cross-entropy plus ``alpha / 2 * sum(W^2) / rows`` over the kernels; and
sklearn's ``tol`` / ``n_iter_no_change`` stop.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import REFERENCE, Precision


def training_table(columns: dict, seed: int, train_frac: float = 0.2):
    """(X float64, y, subset indices) from the feature columns (in
    order): all-NaN columns dropped, NaN as 0, a median-split target of
    the first column and a seeded ``train_frac`` subset."""
    X = np.stack([np.asarray(v, np.float64) for v in columns.values()],
                 axis=1)
    X = np.nan_to_num(X[:, ~np.isnan(X).all(axis=0)])
    y = (X[:, 0] > np.median(X[:, 0])).astype(int)
    n_train = max(10, int(len(X) * train_frac))
    idx = np.random.default_rng(seed).permutation(len(X))[:n_train]
    return X, y, idx


def forest_fields(X: np.ndarray, n_trees: int, depth: int = 8,
                  seed: int = 0) -> dict:
    """The stand-in forest: ``n_trees`` full binary trees of ``depth``
    (heap-ordered nodes), each inner node splitting a random feature at a
    random quantile (0.1-0.9) of ``X``'s rows, each leaf a random class
    distribution."""
    rng = np.random.default_rng(seed)
    n_int = 2 ** depth - 1
    n_nodes = 2 ** (depth + 1) - 1
    feature = np.full((n_trees, n_nodes), -1, np.int64)
    feature[:, :n_int] = rng.integers(0, X.shape[1], (n_trees, n_int))
    q = rng.uniform(0.1, 0.9, (n_trees, n_int))
    rank = np.floor(q * (X.shape[0] - 1)).astype(np.int64)
    threshold = np.zeros((n_trees, n_nodes), np.float32)
    threshold[:, :n_int] = np.sort(X, axis=0)[rank, feature[:, :n_int]]
    idx = np.arange(n_nodes)
    left = np.where(idx < n_int, 2 * idx + 1, idx)[None].repeat(n_trees, 0)
    right = np.where(idx < n_int, 2 * idx + 2, idx)[None].repeat(n_trees, 0)
    p = rng.uniform(0, 1, (n_trees, n_nodes, 1)).astype(np.float32)
    proba = np.concatenate([p, 1 - p], axis=2)
    return dict(feature=feature, threshold=threshold, left=left, right=right,
                leaf_proba=proba, classes=np.array([0, 1]), max_depth=depth)


def forest_predict(fields: dict, X: np.ndarray,
                   p: Precision = REFERENCE) -> np.ndarray:
    """(n, 2) mean leaf distribution of each row over the trees: a row goes
    left where its feature is at most the node's threshold."""
    x = torch.as_tensor(X).to(p.ft)
    thr = torch.as_tensor(fields["threshold"]).to(p.ft)
    feat = torch.as_tensor(fields["feature"])
    T = feat.shape[0]
    node = torch.zeros((x.shape[0], T), dtype=torch.int64)
    t = torch.arange(T)[None, :]
    for _ in range(int(fields["max_depth"])):
        f = feat[t, node]
        leaf = f < 0
        go_left = torch.gather(x, 1, f.clamp(min=0)) <= thr[t, node]
        nxt = torch.where(go_left, 2 * node + 1, 2 * node + 2)
        node = torch.where(leaf, node, nxt)
    leaf_p = torch.as_tensor(fields["leaf_proba"]).to(p.acc)
    return leaf_p[t, node].mean(dim=1).numpy()


def _trunc_normal(shape, std: float, g: torch.Generator) -> torch.Tensor:
    w = torch.empty(shape)
    torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                generator=g)
    return w


def mlp_fit_predict(X: np.ndarray, y: np.ndarray, idx: np.ndarray,
                    seed: int, clf: dict, device,
                    p: Precision = REFERENCE) -> np.ndarray:
    """(n, n_classes) probabilities of every row of ``X`` from an MLP of
    ``clf["hidden"]`` ReLU units fitted on the rows ``idx`` in ``p.ft``
    (float32, the configuration's; bfloat16 for the control). Each step is
    written as the configuration states it, in this order: the layers as
    ``F.linear``, the loss as the batch's mean cross-entropy plus the
    kernels' penalty, the epoch's loss summed on the device, the softmax
    in its max-subtracted form."""
    dt = p.ft
    Xt, yt = X[idx].astype(np.float32), y[idx]
    classes, y_idx = np.unique(yt, return_inverse=True)
    n, f = Xt.shape
    widths = [f, *clf["hidden"], len(classes)]
    g = torch.Generator().manual_seed(int(seed))
    params = []
    for a, b in zip(widths[:-1], widths[1:]):
        std = math.sqrt(1.0 / a) / .87962566103423978
        w = _trunc_normal((b, a), std, g)
        params += [w.to(device, dt).requires_grad_(),
                   torch.zeros(b, device=device, dtype=dt,
                               requires_grad=True)]
    kernels = params[0::2]

    def forward(x):
        for i in range(0, len(params) - 2, 2):
            x = torch.relu(F.linear(x, params[i], params[i + 1]))
        return F.linear(x, params[-2], params[-1])

    opt = torch.optim.Adam(params, lr=float(clf.get("learning_rate", 1e-3)),
                           betas=(0.9, 0.999), eps=1e-8)
    alpha = float(clf.get("alpha", 1e-4))
    tol = float(clf.get("tol", 1e-4))
    patience = int(clf.get("n_iter_no_change", 10))
    bs = min(200, n)
    xd = torch.as_tensor(Xt, device=device).to(dt)
    yd = torch.as_tensor(y_idx, dtype=torch.int64, device=device)
    rng = np.random.default_rng(int(seed))
    n_batches = -(-n // bs)
    best, stale = np.inf, 0
    for _ in range(int(clf["max_iter"])):
        perm = torch.as_tensor(rng.permutation(n), device=device)
        total = torch.zeros((), device=device, dtype=dt)
        for b in range(n_batches):
            rows = perm[b * bs:(b + 1) * bs]
            loss = F.cross_entropy(forward(xd[rows]), yd[rows]) + sum(
                (w * w).sum() for w in kernels) * (alpha / 2) / rows.numel()
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            total = total + loss.detach()
        epoch_loss = float(total) / n_batches
        stale = stale + 1 if epoch_loss > best - tol else 0
        best = min(best, epoch_loss)
        if stale >= patience:
            break
    with torch.no_grad():
        z = forward(torch.as_tensor(X.astype(np.float32),
                                    device=device).to(dt))
        z = z - z.amax(dim=1, keepdim=True)
        e = torch.exp(z)
        return (e / e.sum(dim=1, keepdim=True)).to(p.acc).cpu().numpy()


def classify(columns: dict, seeds: dict, clf: dict, device,
             p: Precision = REFERENCE) -> np.ndarray:
    """The configuration's class probabilities of every object from its
    feature ``columns``: the stand-in forest or the MLP."""
    X, y, idx = training_table(columns, seeds["table"],
                               float(clf.get("train_frac", 0.2)))
    if clf["kind"] == "stand_in_forest":
        fields = forest_fields(X[idx], int(clf["n_trees"]),
                               int(clf["depth"]), seeds["forest"])
        return forest_predict(fields, X.astype(np.float32), p)
    if clf["kind"] == "mlp":
        return mlp_fit_predict(X, y, idx, seeds["mlp"], clf, device, p)
    raise ValueError(f"unknown classifier {clf['kind']!r}")
