"""obia_tpu_torch's tools against the JAX package on the CPU: checkpoints
(``checkpoint.py``, and the MLP's ``save``/``load``), the typed configs
(``config.py``) and the command line (``cli.py``).

Bars: checkpoints round-trip bitwise, with ``like=`` restoring containers
and dtypes, and each package reads the other's ``.npz``; a JAX-fitted MLP
checkpoint loads into ``TorchMLPClassifier`` and predicts JAX's
probabilities within atol 1e-6; every config's ``kwargs()`` drives the
port's function and validates as JAX's does; the CLI's GeoPackages have the
row counts of JAX's CLI, and it registers JAX's commands but the five whose
modules are not ported yet.
"""
import collections
import json
import os

import numpy as np
import pytest
import torch

from obia_tpu_torch import checkpoint as tck

UNPORTED_COMMANDS = {"bench"}


def _jax_npz_only(monkeypatch):
    """Make the JAX package's save_pytree take its .npz path, as
    tests/test_checkpoint.py forces it (orbax fails, the fallback runs)."""
    import orbax.checkpoint as ocp

    class Boom:
        def save(self, path, tree, force=True):
            raise IOError("orbax unavailable (simulated)")

    monkeypatch.setattr(ocp, "StandardCheckpointer", Boom)


# -- checkpoint ----------------------------------------------------------------

Pair = collections.namedtuple("Pair", "w m")


def test_pytree_roundtrip_with_like(tmp_path):
    tree = {"a": np.arange(5.0), "b": {"c": np.ones((2, 3), np.float32)},
            "t": (np.arange(3, dtype=np.int16), [np.zeros(2, np.uint8)]),
            "p": Pair(torch.arange(4, dtype=torch.float32),
                      np.float64(2.5))}
    path = str(tmp_path / "ckpt")
    tck.save_pytree(path, tree)
    assert os.path.exists(path + ".npz")
    back = tck.load_pytree(path, like=tree)
    assert isinstance(back["t"], tuple) and isinstance(back["t"][1], list)
    assert isinstance(back["p"], Pair)
    np.testing.assert_array_equal(back["a"], tree["a"])
    assert back["b"]["c"].dtype == np.float32
    assert back["t"][0].dtype == np.int16
    np.testing.assert_array_equal(back["p"].w, np.arange(4, dtype=np.float32))
    plain = tck.load_pytree(path)
    assert set(plain) == {"a", "b", "t", "p"}
    np.testing.assert_array_equal(plain["t"]["1"]["0"], np.zeros(2))


def test_each_package_reads_the_others_npz(tmp_path, monkeypatch):
    from obia_tpu import checkpoint as jck
    _jax_npz_only(monkeypatch)
    tree = ({"w": np.arange(4, dtype=np.float32)},
            {"m": np.ones(2, np.float64)})
    jax_path, port_path = str(tmp_path / "jax"), str(tmp_path / "port")
    with pytest.warns(UserWarning, match="falling back"):
        jck.save_pytree(jax_path, tree)
    tck.save_pytree(port_path, tree)
    for got in (tck.load_pytree(jax_path, like=tree),
                jck.load_pytree(port_path, like=tree)):
        assert isinstance(got, tuple)
        np.testing.assert_array_equal(got[0]["w"], tree[0]["w"])
        assert got[1]["m"].dtype == np.float64
    np.testing.assert_array_equal(tck.load_pytree(jax_path)["0"]["w"],
                                  jck.load_pytree(port_path)["0"]["w"])


def test_orbax_directory_raises(tmp_path):
    os.makedirs(tmp_path / "ckpt")
    with pytest.raises(ValueError, match="orbax"):
        tck.load_pytree(str(tmp_path / "ckpt"))


def test_tile_manifest_matches_jax(tmp_path):
    from obia_tpu.checkpoint import TileManifest as JaxManifest
    path = str(tmp_path / "manifest.json")
    m = tck.TileManifest(path)
    assert not m.is_done("t1")
    m.mark("t1", "done", n_segments=5)
    m.mark("t2", "failed", error="boom")
    for again in (tck.TileManifest(path), JaxManifest(path)):
        assert again.is_done("t1")
        assert again.failed() == ["t2"]
        assert again.pending(["t1", "t2", "t3"]) == ["t2", "t3"]


# -- the MLP's save / load -----------------------------------------------------

@pytest.fixture(scope="module")
def jax_mlp():
    from obia_tpu.classification.mlp import FlaxMLPClassifier
    rng = np.random.default_rng(42)
    X = rng.normal(size=(200, 4)).astype(np.float32)
    y = np.where(X[:, 0] > 0, "x", "y")
    return FlaxMLPClassifier(hidden_layer_sizes=(8,), max_iter=30,
                             activation="tanh").fit(X, y), X


def test_jax_npz_checkpoint_loads_into_the_port(jax_mlp, tmp_path,
                                                monkeypatch):
    from obia_tpu_torch.classification.mlp import TorchMLPClassifier
    clf, X = jax_mlp
    _jax_npz_only(monkeypatch)
    path = str(tmp_path / "mlp")
    with pytest.warns(UserWarning, match="falling back"):
        clf.save(path)
    port = TorchMLPClassifier(device="cpu").load(path)
    assert list(port.classes_) == list(clf.classes_)
    assert port.hidden == (8,) and port.activation == "tanh"
    np.testing.assert_allclose(port.predict_proba(X), clf.predict_proba(X),
                               atol=1e-6)


def test_port_checkpoint_round_trips_and_loads_into_jax(jax_mlp, tmp_path):
    from obia_tpu.classification.mlp import FlaxMLPClassifier
    from obia_tpu_torch.classification.mlp import TorchMLPClassifier
    _, X = jax_mlp
    y = np.where(X[:, 1] > 0, 3, 7)
    clf = TorchMLPClassifier(hidden_layer_sizes=(6, 5), max_iter=5,
                             alpha=1e-3, device="cpu").fit(X, y)
    path = str(tmp_path / "port_mlp")
    clf.save(path)
    meta = json.load(open(path + ".meta.json"))
    assert meta == {"classes": [3, 7], "hidden": [6, 5], "activation": "relu",
                    "alpha": 1e-3, "learning_rate_init": 1e-3}
    back = TorchMLPClassifier(device="cpu").load(path)
    np.testing.assert_array_equal(back.predict_proba(X),
                                  clf.predict_proba(X))
    assert list(back.predict(X)) == list(clf.predict(X))
    theirs = FlaxMLPClassifier().load(path)
    np.testing.assert_allclose(theirs.predict_proba(X), clf.predict_proba(X),
                               atol=1e-6)


# -- config --------------------------------------------------------------------

def _image(h=48, w=64):
    from obia_tpu_torch.geometry.affine import Affine
    from obia_tpu_torch.handlers.geotif import image_from_array
    rng = np.random.default_rng(0)
    arr = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    arr[: h // 2] //= 3
    return image_from_array(arr, Affine(1, 0, 0, 0, -1, h), crs="EPSG:32633")


def test_segment_configs_drive_create_segments():
    from obia_tpu_torch.config import QuickshiftConfig, SlicConfig
    from obia_tpu_torch.segmentation.segment_boundaries import create_segments
    image = _image()
    cfg = SlicConfig(n_segments=12, compactness=5.0)
    layer = create_segments(image, device="cpu", **cfg.kwargs())
    same = create_segments(image, device="cpu", n_segments=12,
                           compactness=5.0)
    assert len(layer) == len(same) > 3
    np.testing.assert_array_equal(np.asarray(layer.label_raster),
                                  np.asarray(same.label_raster))
    qs = create_segments(image, device="cpu", method="quickshift",
                         **QuickshiftConfig(kernel_size=2,
                                            max_dist=6).kwargs())
    assert len(qs) > 3


def test_stats_tiling_classify_mosaic_configs():
    from obia_tpu_torch.config import (ClassifyConfig, MosaicConfig,
                                       StatsConfig, TilingConfig)
    from obia_tpu_torch.parallel.mesh import make_mesh
    from obia_tpu_torch.parallel.mosaic import mosaic_pipeline
    from obia_tpu_torch.segmentation.segment_boundaries import create_segments
    from obia_tpu_torch.segmentation.segment_statistics import create_objects
    import inspect

    from obia_tpu_torch.utils.tiling import create_tiled_segments
    image = _image()
    layer = create_segments(image, device="cpu", n_segments=12)
    table = create_objects(layer, image, **StatsConfig(
        calc_kurtosis=False).kwargs())
    assert "b0_kurtosis" not in table.columns
    assert np.isfinite(table["b0_skewness"]).all()
    tiling_args = inspect.signature(create_tiled_segments).parameters
    assert set(TilingConfig().kwargs()) <= set(tiling_args)
    kw = ClassifyConfig(method="mlp", compute_reports=True).kwargs()
    assert kw["method"] == "mlp" and kw["compute_reports"] is True
    from obia_tpu_torch.classification.classify import classify
    assert set(kw) <= set(inspect.signature(classify).parameters)
    objects = mosaic_pipeline(image, mesh=make_mesh(8, ["cpu"]),
                              objects_kwargs={"glcm_levels": 32},
                              **MosaicConfig(n_segments=12).kwargs())
    assert len(objects) > 3


def test_config_validation_and_replace():
    from obia_tpu_torch.config import (ClassifyConfig, QuickshiftConfig,
                                       SlicConfig, TilingConfig)
    with pytest.raises(ValueError):
        SlicConfig(n_segments=0)
    with pytest.raises(ValueError):
        SlicConfig(compactness=0)
    with pytest.raises(ValueError):
        ClassifyConfig(method="svm")
    with pytest.raises(ValueError):
        ClassifyConfig(test_size=1.5)
    with pytest.raises(ValueError):
        TilingConfig(tile_size=10, buffer=20)
    with pytest.raises(ValueError):
        QuickshiftConfig(max_dist=0)
    cfg = SlicConfig(n_segments=100)
    cfg2 = cfg.replace(n_segments=50)
    assert cfg.n_segments == 100 and cfg2.n_segments == 50


def test_configs_equal_jax():
    import dataclasses

    from obia_tpu import config as jcfg
    from obia_tpu_torch import config as tcfg
    for name in ("SlicConfig", "QuickshiftConfig", "StatsConfig",
                 "ClassifyConfig", "TilingConfig", "MosaicConfig"):
        mine, theirs = getattr(tcfg, name)(), getattr(jcfg, name)()
        assert ([(f.name, f.default) for f in dataclasses.fields(mine)]
                == [(f.name, f.default) for f in dataclasses.fields(theirs)])
        assert mine.kwargs() == theirs.kwargs()


# -- the CLI -------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_scene(tmp_path_factory):
    from obia_tpu_torch.geometry.affine import Affine
    from obia_tpu_torch.io.tiff import write_tiff
    rng = np.random.default_rng(42)
    h, w = 96, 128
    base = np.zeros((h, w, 3), np.float32)
    base[:h // 2, :, 0] = 0.8
    base[h // 2:, :, 1] = 0.6
    base[:, w // 2:, 2] = 0.9
    arr = np.clip(base + rng.normal(0, 0.03, (h, w, 3)), 0, 1)
    path = str(tmp_path_factory.mktemp("cli") / "scene.tif")
    write_tiff(path, (arr * 255).astype(np.uint8),
               transform=Affine(2.0, 0.0, 600000.0, 0.0, -2.0, 5100000.0),
               crs="EPSG:32610")
    return path


def _invoke(args, jax=False):
    from click.testing import CliRunner
    if jax:
        from obia_tpu.cli import main as group
    else:
        from obia_tpu_torch.cli import build_cli
        group = build_cli()
    res = CliRunner().invoke(group, args)
    assert res.exit_code == 0, res.output
    return res.output


def test_cli_segment_rows_equal_jax(cli_scene, tmp_path):
    from obia_tpu.vector import read_file
    mine, theirs = str(tmp_path / "port.gpkg"), str(tmp_path / "jax.gpkg")
    _invoke(["segment", cli_scene, mine, "--n-segments", "12", "--device",
             "cpu"])
    _invoke(["segment", cli_scene, theirs, "--n-segments", "12"], jax=True)
    got, want = read_file(mine), read_file(theirs)
    assert len(got) == len(want) >= 4
    assert list(got.columns) == list(want.columns)


def test_cli_tiled_segments_rows_equal_jax(cli_scene, tmp_path):
    from obia_tpu.vector import read_file
    args = ["--tile-size", "64", "--buffer", "16", "--n-segments", "8"]
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    out = _invoke(["tiled-segments", cli_scene, mine, "--device", "cpu",
                   *args])
    _invoke(["tiled-segments", cli_scene, theirs, *args], jax=True)
    got = read_file(os.path.join(mine, "segments.gpkg"))
    want = read_file(os.path.join(theirs, "segments.gpkg"))
    assert len(got) == len(want) > 4
    assert f"wrote {len(got):,} segments" in out
    manifest = json.load(open(os.path.join(mine, "manifest.json")))
    assert manifest and all(v["status"] == "done"
                            for v in manifest.values())


def test_cli_info_with_a_card_mocked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=0: "NVIDIA H100 80GB HBM3")
    info = json.loads(_invoke(["info"]))
    assert info["cuda"] is True and info["count"] == 1
    assert info["devices"] == ["NVIDIA H100 80GB HBM3"]
    assert isinstance(info["native_library"], bool)
    assert isinstance(info["kernel_library"], bool)


def test_cli_registers_jax_commands_but_the_unported():
    from obia_tpu.cli import main as jax_main
    from obia_tpu_torch.cli import build_cli
    assert set(build_cli().commands) == set(jax_main.commands) - \
        UNPORTED_COMMANDS
    assert "tiled-segments" in _invoke(["--help"])


def test_cli_module_imports_without_click():
    import subprocess
    import sys
    code = ("import builtins; real = builtins.__import__\n"
            "def block(n, *a, **k):\n"
            "    if n.split('.')[0] == 'click': raise ImportError(n)\n"
            "    return real(n, *a, **k)\n"
            "builtins.__import__ = block\n"
            "import obia_tpu_torch.cli as c; assert callable(c.main)\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
