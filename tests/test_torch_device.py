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
from obia_tpu_torch.utils import cost as tcost
from obia_tpu_torch.utils import seeds as tseeds


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


def _run_classify(device):
    from obia_tpu_torch.classification.classify import classify
    from obia_tpu_torch.geometry.geom import box
    from obia_tpu_torch.segmentation.segment_statistics import ObjectTable
    X, y = _xy()
    layer = tsb.SegmentLayer(len(X), [box(i, 0, i + 1, 1)
                                      for i in range(len(X))],
                             None, None, None, None, None)
    table = ObjectTable({"segment_id": np.arange(1, len(X) + 1),
                         **{f"b{i}_mean": X[:, i] for i in range(3)}}, layer)
    return classify(table, table.with_columns(feature_class=y),
                    method="mlp", hidden_layer_sizes=(4,), max_iter=2,
                    **device)


def _run_tiled(device):
    import tempfile

    from obia_tpu_torch.io.tiff import write_tiff
    from obia_tpu_torch.utils.tiling import create_tiled_segments
    with tempfile.TemporaryDirectory() as d:
        write_tiff(f"{d}/s.tif", (_image().img_data).astype(np.uint8),
                   transform=Affine(1, 0, 0, 0, -1, 24), crs="EPSG:32633")
        return create_tiled_segments(f"{d}/s.tif", f"{d}/out", tile_size=16,
                                     buffer=4, n_segments=3, **device)


def _run_canopy(step):
    """One step of the canopy workflow on 48^2 inputs (made on the CPU);
    returns what it wrote, read back."""
    def run(device):
        import tempfile

        import chip_smoke
        from obia_tpu_torch.io.tiff import TiffReader
        from obia_tpu_torch.vector.features import read_features
        with tempfile.TemporaryDirectory() as d:
            p = chip_smoke.write_canopy_inputs(d, 48, 0, "cpu", n_segments=6)
            out = f"{d}/out.gpkg"
            if step == "make_cost_surface":
                tcost.make_cost_surface(p["wv3"], p["chm"], f"{d}/c.tif",
                                        slic=p["slic"],
                                        weights=(0.4, 0.2, 0.2, 0.2),
                                        **device)
                return TiffReader(f"{d}/c.tif").read()
            if step == "make_canonical_seeds":
                for fn, src in ((tseeds.make_chm_seeds, "chm"),
                                (tseeds.make_density_seeds, "density")):
                    fn(p[src], f"{d}/{src}.gpkg", device="cpu")
                return tseeds.make_canonical_seeds(
                    f"{d}/chm.gpkg", f"{d}/density.gpkg", p["chm"], p["chm"],
                    out, **device)
            getattr(tseeds, step)(p["chm" if step == "make_chm_seeds"
                                    else "density"], out, **device)
            return read_features(out)
    return run


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
    "classify": _run_classify,
    "create_tiled_segments": _run_tiled,
    "make_chm_seeds": _run_canopy("make_chm_seeds"),
    "make_density_seeds": _run_canopy("make_density_seeds"),
    "make_cost_surface": _run_canopy("make_cost_surface"),
    "make_canonical_seeds": _run_canopy("make_canonical_seeds"),
    "build_distance_matrix": lambda device: tseeds.build_distance_matrix(
        np.arange(3.0), np.arange(3.0),
        np.ones((4, 4), np.float32), Affine(1, 0, 0, 0, -1, 4), 0.5, 0.8,
        **device),
    "chm_gradient": lambda device: tcost.chm_gradient(
        np.random.default_rng(4).random((9, 11)), **device),
    "texture_entropy": lambda device: tcost.texture_entropy(
        np.random.default_rng(5).random((9, 11)), **device),
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
