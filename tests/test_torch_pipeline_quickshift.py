"""The obia_tpu_torch config-2 slice end to end against the JAX package on
the CPU: the RGB scene of bench.py's config 2, cut to 64 x 80 pixels, with
kernel_size=2 and max_dist=8 (about 14 pixels a root, near config 2's ~19
pixels an object at 1024^2); quickshift on all bands (RGB->Lab runs),
spectral and GLCM features of the 3 bands, then an MLP. The port draws the
JAX package's tie noise.

Bars: object counts within 1% and label partitions agreeing on >= 99.5% of
the pixels; on the objects that are the same pixel set in both, every
feature column within rtol 2e-4 / atol 1e-5 of JAX (GLCM correlation atol
2e-3, see tests/test_torch_pipeline.py); and the JAX-fitted MLP, carried
across with ``mlp_from_flax``, giving JAX's probabilities to atol 1e-6. The
MLP sees z-scored features (the JAX table's column statistics): on raw
features (variances near 1e4) float32 logits reach ~1e3, and two matmul
orders then differ by ~1e-4 in probability on the very same input.
"""
import numpy as np
import pytest
import torch

from bench import build_scene
from obia_tpu.classification.mlp import FlaxMLPClassifier
from obia_tpu.geometry.affine import Affine
from obia_tpu.handlers.geotif import image_from_array as jax_image
from obia_tpu.ops import quickshift as jqs
from obia_tpu.segmentation.segment import segment as jax_segment
from obia_tpu_torch.classification.mlp import mlp_from_flax
from obia_tpu_torch.ops import quickshift as tqs
from obia_tpu_torch.segmentation.segment import segment

H, W = 64, 80
KW = dict(method="quickshift", ratio=1.0, kernel_size=2, max_dist=8.0)
FAMILIES = ["mean", "variance", "min", "max", "skewness", "kurtosis",
            "contrast", "dissimilarity", "homogeneity", "ASM", "energy",
            "correlation"]


@pytest.fixture(scope="module")
def runs():
    image = jax_image(build_scene(h=H, w=W), Affine(1.0, 0, 0, 0, -1.0, H),
                      crs="EPSG:32633")
    js = jax_segment(image, **KW)
    mp = pytest.MonkeyPatch()
    mp.setattr(tqs, "_tie_noise", lambda seed, shape, device: torch.tensor(
        np.asarray(jqs._tie_noise(int(seed), tuple(shape)))).to(device))
    try:
        ts = segment(image, device="cpu", **KW)
    finally:
        mp.undo()
    return js, ts


def matched_objects(a: np.ndarray, b: np.ndarray):
    """(ids in a, ids in b) of the objects that are the same pixel set in
    both label rasters."""
    pairs, counts = np.unique(np.stack([a.ravel(), b.ravel()]), axis=1,
                              return_counts=True)
    size_a = np.bincount(a.ravel())
    size_b = np.bincount(b.ravel())
    ok = (counts == size_a[pairs[0]]) & (counts == size_b[pairs[1]])
    return pairs[0][ok], pairs[1][ok]


def test_objects_and_partition_agree(runs):
    js, ts = runs
    nj, nt = len(js.segments), len(ts.table)
    assert nj > 100 and abs(nt - nj) <= 0.01 * nj
    a, b = ts.label_raster, np.asarray(js.label_raster)
    ia, _ = matched_objects(a, b)
    agree = np.isin(a, ia).mean()
    assert agree >= 0.995, agree
    assert len(ts.table.geometry) == nt
    assert ts.method == "quickshift" and ts.params["kernel_size"] == 2


@pytest.mark.parametrize("family", FAMILIES)
def test_feature_columns_match_on_matched_objects(runs, family):
    js, ts = runs
    it, ij = matched_objects(ts.label_raster, np.asarray(js.label_raster))
    for b in range(3):
        c = f"b{b}_{family}"
        want = js.segments[c].to_numpy(np.float64)[ij]
        got = ts.table[c][it]
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        if family == "correlation":
            np.testing.assert_allclose(got, want, rtol=0, atol=2e-3,
                                       err_msg=c)
        else:
            np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5,
                                       err_msg=c)


def test_carried_mlp_gives_jax_proba(runs):
    js, ts = runs
    cols = [c for c in ts.table.columns if c != "segment_id"
            and not np.isnan(ts.table[c]).all()]
    Xj = np.nan_to_num(np.stack([js.segments[c].to_numpy() for c in cols],
                                axis=1).astype(np.float64))
    Xt = np.nan_to_num(np.stack([ts.table[c] for c in cols],
                                axis=1).astype(np.float64))
    mu, sd = Xj.mean(axis=0), Xj.std(axis=0) + 1e-12
    y = (Xj[:, 0] > np.median(Xj[:, 0])).astype(int)
    clf = FlaxMLPClassifier(hidden_layer_sizes=(64,), max_iter=60,
                            random_state=0).fit((Xj - mu) / sd, y)
    want = clf.predict_proba((Xj - mu) / sd)
    got = mlp_from_flax(clf._params, clf.classes_, (64,), "relu"
                        ).predict_proba((Xt - mu) / sd)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_quickshift_rejects_a_mask():
    """Reference quirk #12: skimage's quickshift takes no mask."""
    from obia_tpu_torch.segmentation.segment_boundaries import \
        create_segments
    image = jax_image(build_scene(h=16, w=16), Affine(1, 0, 0, 0, -1, 16))
    with pytest.raises(TypeError, match="quirk #12"):
        create_segments(image, method="quickshift", mask=np.ones((16, 16)))
    with pytest.raises(Exception, match="unknown segmentation method"):
        create_segments(image, method="watershed")
