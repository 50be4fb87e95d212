"""Entry points whose input is not yet a tensor run on the card by default:
with no card, a call without ``device`` raises instead of running on the
CPU, and ``device="cpu"`` runs there."""
import types

import numpy as np
import pytest
import torch

from obia_tpu_torch.classification import forest as tforest
from obia_tpu_torch.classification import mlp as tmlp
from obia_tpu_torch.geometry.affine import Affine
from obia_tpu_torch.handlers.geotif import image_from_array
from obia_tpu_torch.ops import quickshift as tqs
from obia_tpu_torch.parallel.mesh import make_mesh
from obia_tpu_torch.segmentation import segment as tsegment
from obia_tpu_torch.segmentation import segment_boundaries as tsb


def _image():
    rng = np.random.default_rng(0)
    arr = (rng.random((24, 28, 3)) * 255).astype(np.uint8)
    return image_from_array(arr, Affine(1, 0, 0, 0, -1, 24),
                            crs="EPSG:32633")


def _forest_fields():
    return dict(feature=[[0, -1, -1]], threshold=[[0.5, 0, 0]],
                left=[[1, 1, 2]], right=[[2, 1, 2]],
                leaf_proba=[[[0.5, 0.5], [1.0, 0.0], [0.0, 1.0]]],
                classes=[0, 1], max_depth=1)


def _xy():
    rng = np.random.default_rng(1)
    X = rng.random((30, 3))
    return X, (X[:, 0] > 0.5).astype(int)


def _sklearn_forest():
    from sklearn.ensemble import RandomForestClassifier
    return RandomForestClassifier(n_estimators=2, random_state=0).fit(*_xy())


def _flax_params():
    rng = np.random.default_rng(2)
    return {"params": {
        "Dense_0": {"kernel": rng.normal(size=(3, 4)), "bias": np.zeros(4)},
        "Dense_1": {"kernel": rng.normal(size=(4, 2)), "bias": np.zeros(2)}}}


def _run_forest_classifier(device):
    X, y = _xy()
    clf = tforest.TorchForestClassifier(n_estimators=2, random_state=0,
                                        **device)
    return clf.fit(X, y).predict_proba(X)


def _run_mlp_classifier(device):
    X, y = _xy()
    clf = tmlp.TorchMLPClassifier(hidden_layer_sizes=(4,), max_iter=2,
                                  **device)
    return clf.fit(X, y).predict_proba(X)


def _run_make_mesh(device):
    devices = [device["device"]] if device else None
    return make_mesh(8, devices)


def _quickshift_image():
    return np.random.default_rng(3).random((12, 14, 3)).astype(np.float32)


ENTRY_POINTS = {
    "create_segments": lambda device: tsb.create_segments(
        _image(), n_segments=6, **device),
    "segment": lambda device: tsegment.segment(
        _image(), n_segments=6, **device),
    "ForestArrays.from_numpy": lambda device: tforest.ForestArrays.from_numpy(
        **_forest_fields(), **device),
    "ForestArrays.from_sklearn": lambda device:
        tforest.ForestArrays.from_sklearn(_sklearn_forest(), **device),
    "forest_from_jax": lambda device: tforest.forest_from_jax(
        types.SimpleNamespace(**_forest_fields()), **device),
    "TorchForestClassifier": _run_forest_classifier,
    "TorchMLPClassifier": _run_mlp_classifier,
    "mlp_from_flax": lambda device: tmlp.mlp_from_flax(
        _flax_params(), [0, 1], (4,), **device).predict_proba(np.ones((2, 3))),
    "make_mesh": _run_make_mesh,
    "quickshift": lambda device: tqs.quickshift(
        _quickshift_image(), kernel_size=1, max_dist=3, **device),
    "quickshift_tree": lambda device: tqs.quickshift_tree(
        _quickshift_image(), kernel_size=1, max_dist=3, **device),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = ENTRY_POINTS[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call({})
    assert call({"device": "cpu"}) is not None
