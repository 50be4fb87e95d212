"""The plain reference agrees with the port at tiny sizes on the CPU."""
import numpy as np
import pytest
import torch

from benchmark.reference import compare, features, segment
from benchmark.reference.classify import (forest_fields, forest_predict,
                                          mlp_fit_predict, training_table)
from small import run_small


def _blocks(seed, H=40, W=50, k=5):
    """(H, W) labels 0..k-1 in blocks of 4 x 5 pixels."""
    g = torch.Generator().manual_seed(seed)
    b = torch.randint(0, k, (H // 4 + 1, W // 5 + 1), generator=g)
    return b.repeat_interleave(4, 0).repeat_interleave(5, 1)[:H, :W]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_components_as_the_port(seed):
    from obia_tpu_torch.ops.connectivity import ccl_dense_labels
    lab = _blocks(seed)
    want, k = ccl_dense_labels(lab)
    got = segment.components(lab)
    assert torch.equal(got, want.long()) and int(got.max()) + 1 == k


@pytest.mark.parametrize("bands,n", [((0, 3, 6), 40), ((0, 1, 2), 12)])
def test_slic_as_the_port(bands, n):
    from benchmark.scenes import make_scene
    from obia_tpu_torch.ops.slic import slic_dense
    from obia_tpu_torch.segmentation.segment_boundaries import \
        _normalize_select
    scene = make_scene(96, 8, 3, "cpu")
    want, _ = slic_dense(_normalize_select(scene.float(), list(bands)),
                         n_segments=n, compactness=10)
    got = segment.segment(scene, {"segmentation_bands": list(bands),
                                  "method": "slic", "n_segments": n,
                                  "compactness": 10})
    assert torch.equal(got, want.long())


def test_quickshift_as_the_port():
    from benchmark.scenes import make_scene
    from obia_tpu_torch.ops.connectivity import ccl_dense_labels
    from obia_tpu_torch.ops.quickshift import quickshift_tree
    from obia_tpu_torch.segmentation.segment_boundaries import \
        _normalize_select
    scene = make_scene(48, 3, 4, "cpu")
    root = quickshift_tree(_normalize_select(scene.float(), [0, 1, 2]),
                           ratio=1.0, kernel_size=5, max_dist=10.0)[0]
    want, _ = ccl_dense_labels(root)
    got = segment.segment(scene, {"method": "quickshift", "ratio": 1.0,
                                  "kernel_size": 5, "max_dist": 10.0})
    assert compare.partition_mismatch(got, want) == 0.0


def test_texture_as_skimage():
    from obia_tpu_torch.ops.glcm import (graycomatrix_reference,
                                         graycoprops_reference)
    g = torch.Generator().manual_seed(0)
    band = torch.randint(0, 256, (12, 9), generator=g).to(torch.uint8)
    lab = torch.zeros((12, 9), dtype=torch.int64)
    got = features.texture(band[:, :, None], lab, 1, [0],
                           {"levels": 256, "distance": 2,
                            "angles_deg": [0, 45, 90, 135]})
    v = band.numpy().astype(np.float32)
    inv = np.float32(255) / np.float32(v.max() - v.min())
    q = np.clip(np.floor((v - v.min()) * inv), 0, 255).astype(np.int64)
    P = graycomatrix_reference(q)
    for prop in features.TEXTURE:
        want = graycoprops_reference(P, prop).mean()
        assert float(got[f"b0_{prop}"][0]) == pytest.approx(want, rel=1e-9)


def test_features_as_the_port():
    from benchmark.scenes import make_scene
    from obia_tpu_torch.ops.glcm import segment_glcm_props
    from obia_tpu_torch.ops.stats import segment_spectral_moments
    scene = make_scene(64, 8, 5, "cpu")
    lab = _blocks(7, 64, 64, 6)
    lab = segment.components(lab)
    K = int(lab.max()) + 1
    img = scene.float()
    mom = segment_spectral_moments(img, lab.to(torch.int32), K)
    tex = segment_glcm_props(img, lab.to(torch.int32), K)
    port = {f"b{b}_{s}": mom[s][:, b].numpy() for s in features.SPECTRAL
            for b in range(8)}
    port.update({f"b{b}_{t}": tex[t][:, b] for t in features.TEXTURE
                 for b in range(8)})
    cfg = {"segment": {"statistics_bands": list(range(8))},
           "glcm": {"levels": 256, "distance": 2,
                    "angles_deg": [0, 45, 90, 135]}}
    ref = compare.as_float32(features.features(scene, lab, K, cfg))
    assert compare.feature_gap(port, ref) < 1e-4


def test_forest_as_the_port():
    from obia_tpu_torch.classification.forest import (ForestArrays,
                                                      forest_proba)
    rng = np.random.default_rng(0)
    cols = {f"c{i}": rng.normal(size=300) for i in range(6)}
    X, _, idx = training_table(cols, 3)
    fields = forest_fields(X[idx], 20, 5, 4)
    want = forest_proba(ForestArrays.from_numpy(**fields, device="cpu"),
                        torch.as_tensor(X, dtype=torch.float32)).numpy()
    got = forest_predict(fields, X.astype(np.float32))
    assert np.abs(got - want).max() < 1e-6


def test_mlp_as_the_port():
    from obia_tpu_torch.classification.mlp import TorchMLPClassifier
    rng = np.random.default_rng(1)
    cols = {f"c{i}": rng.normal(size=400) for i in range(5)}
    X, y, idx = training_table(cols, 2)
    clf = TorchMLPClassifier(hidden_layer_sizes=(64,), max_iter=20,
                             random_state=2 ** 31 + 3, device="cpu")
    want = clf.fit(X[idx], y[idx]).predict_proba(X)
    got = mlp_fit_predict(X, y, idx, 2 ** 31 + 3,
                          {"hidden": [64], "max_iter": 20}, "cpu")
    assert np.abs(got - want).max() < 1e-4


@pytest.mark.parametrize("cell", ["c4-northstar-100mp", "c4-tiles-1024",
                                  "c2-quickshift-1024"])
@pytest.mark.parametrize("trace", [0, 1])
def test_small_run_is_correct(cell, trace):
    res, lines = run_small(cell, trace)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert len(lines) == len(res["checks"]) == 5
    if trace:
        assert "segment_kernel_ms" in res["metrics"]
        assert "breakdown" in res
    else:
        assert "setup_s" in res["metrics"]
        assert "scene_mp_per_s" in res["metrics"]
