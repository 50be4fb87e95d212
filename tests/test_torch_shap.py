"""obia_tpu_torch's SHAP against the JAX package's.

Bars: the native TreeSHAP (the port's copy of the C++) bitwise equal to
``obia_tpu.native.tree_shap_forest`` on the same sklearn forests; Kernel
SHAP's coalitions and weights bitwise equal to the reference's, and its
values within 1e-10 of the reference's ``kernel_shap`` on the same float64
numpy model (the means over the background are summed in another order on
the device), for any chunking of the synthetic rows; the reference's own
cases (the exact linear model at 1e-8, local accuracy of a sampled run at
1e-8). The card against the CPU for the same model runs only on a card
(``-m cuda``).

JAX, the JAX package and sklearn are imported inside the tests that use
them, so that the ``cuda`` test also runs where only torch is installed
(``pytest --noconftest -m cuda``).
"""
import numpy as np
import pytest
import torch

from obia_tpu_torch import native
from obia_tpu_torch.classification import kernel_shap as tks
from obia_tpu_torch.classification.mlp import mlp_from_flax


def _forest(n_classes, depth, seed=0):
    from sklearn.ensemble import RandomForestClassifier
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(240, 7))
    score = X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + rng.normal(0, 0.3, 240)
    y = np.digitize(score, np.quantile(score, np.linspace(0, 1, n_classes + 1)
                                       [1:-1]))
    rf = RandomForestClassifier(n_estimators=12, max_depth=depth,
                                random_state=seed).fit(X, y)
    return rf, X


@pytest.mark.parametrize("n_classes", [2, 3])
@pytest.mark.parametrize("depth", [4, None])
def test_tree_shap_bitwise_jax(n_classes, depth):
    from obia_tpu import native as jnative
    rf, X = _forest(n_classes, depth)
    rows = X[:40]
    got = native.tree_shap_forest(rf, rows)
    want = jnative.tree_shap_forest(rf, rows)
    assert got.shape == (40, X.shape[1], n_classes)
    np.testing.assert_array_equal(got, want)
    # local accuracy against sklearn's probabilities
    base = np.mean([e.tree_.value[0, 0] / e.tree_.value[0, 0].sum()
                    for e in rf.estimators_], axis=0)
    np.testing.assert_allclose(base + got.sum(axis=1), rf.predict_proba(rows),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("M,nsamples,seed", [(5, 30, 0), (9, 100, 3),
                                             (12, 300, 0), (40, 2128, 7)])
def test_coalitions_bitwise_jax(M, nsamples, seed):
    from obia_tpu.classification import kernel_shap as jks
    Z, w = tks._build_coalitions(M, nsamples, np.random.default_rng(seed))
    Zj, wj = jks._build_coalitions(M, nsamples, np.random.default_rng(seed))
    np.testing.assert_array_equal(Z, Zj)
    np.testing.assert_array_equal(w, wj)


def _nonlinear(X):
    a = np.tanh(X[:, 0] * X[:, 1] + X[:, 2:].sum(axis=1))
    return np.stack([a, -a, 0.5 * np.sin(X[:, 3])], axis=1)


def _on_tensor(predict):
    return lambda t: torch.as_tensor(predict(t.numpy()))


@pytest.mark.parametrize("M,nsamples,batch_rows", [(6, None, 1 << 17),
                                                   (12, 300, 1 << 17),
                                                   (12, 300, 55),
                                                   (12, 300, 7)])
def test_kernel_shap_matches_jax(M, nsamples, batch_rows):
    """batch_rows 55 and 7 cut the rows of one explained row into several
    chunks (20 background rows: 2 and 1 coalitions a chunk)."""
    from obia_tpu.classification import kernel_shap as jks
    rng = np.random.default_rng(M)
    X = rng.normal(size=(5, M))
    bg = rng.normal(size=(20, M))
    got = tks.kernel_shap(_on_tensor(_nonlinear), X, bg, nsamples=nsamples,
                          random_state=2, batch_rows=batch_rows, device="cpu")
    want = jks.kernel_shap(_nonlinear, X, bg, nsamples=nsamples,
                           random_state=2, batch_rows=batch_rows)
    assert got.shape == want.shape == (5, M, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


def test_kernel_shap_several_rows_in_a_chunk():
    """A chunk larger than one row's coalitions holds several explained
    rows; the values do not depend on the chunking."""
    rng = np.random.default_rng(4)
    X = rng.normal(size=(7, 6))
    bg = rng.normal(size=(9, 6))
    one = tks.kernel_shap(_on_tensor(_nonlinear), X, bg, batch_rows=9,
                          device="cpu")
    many = tks.kernel_shap(_on_tensor(_nonlinear), X, bg, batch_rows=9 * 200,
                           device="cpu")
    np.testing.assert_allclose(one, many, rtol=0, atol=1e-12)


def test_kernel_shap_exact_linear():
    """Full-enumeration Kernel SHAP on a linear model equals the analytic
    Shapley values: phi_j = w_j * (x_j - E[bg_j]) (the reference's case)."""
    rng = np.random.default_rng(0)
    M = 5
    w = rng.normal(size=M)

    def predict(X):
        return (X @ torch.as_tensor(w) + 0.3)[:, None]

    X = rng.normal(size=(4, M))
    bg = rng.normal(size=(50, M))
    phi = tks.kernel_shap(predict, X, bg, device="cpu")
    expected = w[None, :] * (X - bg.mean(axis=0)[None, :])
    np.testing.assert_allclose(phi[:, :, 0], expected, atol=1e-8)


def test_kernel_shap_local_accuracy_sampled():
    """With M large enough to force sampling, base + sum(phi) == f(x) (the
    reference's case)."""
    rng = np.random.default_rng(1)
    M = 12
    X = rng.normal(size=(3, M))
    bg = rng.normal(size=(20, M))
    phi = tks.kernel_shap(_on_tensor(_nonlinear), X, bg, nsamples=300,
                          random_state=0, device="cpu")
    base = _nonlinear(bg).mean(axis=0)
    np.testing.assert_allclose(base[None] + phi.sum(axis=1), _nonlinear(X),
                               atol=1e-8)


def test_kernel_shap_single_feature():
    X = np.array([[1.0], [2.0]])
    bg = np.array([[0.0], [4.0]])
    phi = tks.kernel_shap(lambda t: t * 3.0, X, bg, device="cpu")
    np.testing.assert_allclose(phi[:, 0, 0], [-3.0, 0.0])


def test_kernel_shap_tensor_keeps_dtype():
    """A float32 tensor is evaluated in float32: the synthetic rows are the
    float32 rows of the float64 ones."""
    rng = np.random.default_rng(5)
    X = rng.normal(size=(3, 6))
    bg = rng.normal(size=(8, 6))
    seen = []

    def predict(t):
        seen.append(t.dtype)
        return torch.stack([t.sum(dim=1), t[:, 0]], dim=1)

    got = tks.kernel_shap(predict, torch.as_tensor(X, dtype=torch.float32),
                          bg)
    want = tks.kernel_shap(
        lambda t: predict(t.float()), X.astype(np.float32).astype(np.float64),
        bg.astype(np.float32).astype(np.float64), device="cpu")
    assert set(seen) == {torch.float32}
    np.testing.assert_array_equal(got, want)


def _random_mlp(device, n_features=10, seed=0):
    rng = np.random.default_rng(seed)
    params = {"params": {
        "Dense_0": {"kernel": rng.normal(size=(n_features, 16)) * 0.4,
                    "bias": rng.normal(size=16) * 0.1},
        "Dense_1": {"kernel": rng.normal(size=(16, 3)),
                    "bias": np.zeros(3)}}}
    return mlp_from_flax(params, ["a", "b", "c"], (16,), device=device)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernel_shap_matches_cpu(cuda_device):
    """The same MLP on the card and on the CPU: SHAP values within 1e-5,
    local accuracy on the card to 1e-6."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(6, 10))
    bg = rng.normal(size=(40, 10))
    card = _random_mlp(cuda_device)
    cpu = card.to("cpu")
    xs = torch.as_tensor(X, dtype=torch.float32)
    got = tks.kernel_shap(card.proba_tensor, xs.to(cuda_device), bg,
                          batch_rows=4096)
    want = tks.kernel_shap(cpu.proba_tensor, xs, bg, batch_rows=4096)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    f = card.proba_tensor(xs.to(cuda_device)).double().cpu().numpy()
    base = card.proba_tensor(torch.as_tensor(
        bg, dtype=torch.float32, device=cuda_device)).double().mean(0)
    np.testing.assert_allclose(base.cpu().numpy() + got.sum(axis=1), f,
                               rtol=0, atol=1e-6)
