"""Runs of small cells with the timed path broken underneath, and the
control in the program's place: each comes out not correct."""
import numpy as np
import pytest
import torch

from benchmark.reference import CONTROL, compare
from small import run_small, small_cell

SLIC = "c4-tiles-1024"
QS = "c2-quickshift-1024"


def _wrong(cell, name=None):
    res, lines = run_small(cell)
    assert not res["correct"], res["checks"]
    if name is not None:
        c = res["checks"][name]
        assert c["value"] > c["limit"], res["checks"]
    assert lines[-1].startswith("check ")
    return res


def test_slic_step_returns_its_state(monkeypatch):
    import obia_tpu_torch.ops.slic as slic
    monkeypatch.setattr(slic, "update_centers",
                        lambda sums, cnts, centers: centers)
    _wrong(SLIC, "label_mismatch")


def test_quickshift_density_unchanged(monkeypatch):
    import obia_tpu_torch.ops.quickshift as qs
    monkeypatch.setattr(qs, "quickshift_density",
                        lambda img, r, k: torch.ones(img.shape[1:]))
    _wrong(QS, "label_mismatch")


def test_forest_half_the_batch_left_out(monkeypatch):
    import obia_tpu_torch.classification.forest as forest
    real = forest.forest_proba

    def half(trees, X):
        n = X.shape[0] // 2
        p = real(trees, X[:n])
        return torch.cat([p, p.mean(0, keepdim=True).expand(
            X.shape[0] - n, -1)])
    monkeypatch.setattr(forest, "forest_proba", half)
    _wrong(SLIC, "proba_gap")


def test_mlp_half_the_batch_left_out(monkeypatch):
    from obia_tpu_torch.classification.mlp import TorchMLPClassifier
    real = TorchMLPClassifier.predict_proba

    def half(self, X):
        n = len(X) // 2
        p = real(self, X[:n])
        return np.concatenate([p, np.repeat(p.mean(0, keepdims=True),
                                            len(X) - n, 0)])
    monkeypatch.setattr(TorchMLPClassifier, "predict_proba", half)
    _wrong(QS, "proba_mean_gap")


def test_feature_altered(monkeypatch):
    import obia_tpu_torch.ops.stats as stats
    real = stats.spectral_moments_packed

    def altered(*a, **k):
        names, packed = real(*a, **k)
        packed = packed.copy()
        packed[names.index("mean"), 0, 0] *= 1.01
        return names, packed
    monkeypatch.setattr(stats, "spectral_moments_packed", altered)
    _wrong(SLIC, "feature_gap")


def test_polygon_altered(monkeypatch):
    import obia_tpu_torch.geometry.polygonize as poly
    real = poly.polygonize_labels_rle

    def altered(*a, **k):
        out = real(*a, **k)
        first = out[min(out)][0]
        first.exterior.coords_array[1:-1] += 0.5
        return out
    monkeypatch.setattr(poly, "polygonize_labels_rle", altered)
    _wrong(SLIC, "polygon_faults")


def test_labels_altered(monkeypatch):
    import obia_tpu_torch.ops.slic as slic
    real = slic.download_labels_rle

    def altered(lab):
        lab = lab.clone()
        lab[: lab.shape[0] // 2] = 0
        return real(lab)
    monkeypatch.setattr(slic, "download_labels_rle", altered)
    _wrong(SLIC)


@pytest.mark.parametrize("cell", [SLIC, QS])
def test_control_is_not_correct(cell):
    """The reference in bfloat16 (float32 sums) in the program's place."""
    from benchmark.drivers.scene_stream import Driver
    from benchmark.scenes import make_pool
    w = small_cell(cell)
    cfg = w["config_data"]
    drv = Driver(cfg, w["traffic_data"], 2 ** 31 + 9, "cpu")
    scene = torch.as_tensor(make_pool(w["traffic_data"], cfg["bands"],
                                      drv.seed, "cpu")[1])
    out = compare.control(scene, cfg, drv.seeds, "cpu", CONTROL)
    nums = compare.judge(scene, out, cfg, drv.seeds, "cpu")
    limits = {k: v for k, v in w["limits"].items() if k != "polygon_faults"}
    assert not compare.verdict(nums, limits), nums
