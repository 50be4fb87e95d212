"""obia_tpu_torch/bench.py against the repository's bench.py (the JAX
package) on the CPU at small sizes, one run each (``OBIA_BENCH_RUNS=1``).

Bars: the object counts of configs 1 and 4 at 128^2, config 3 at 256^2 and
config 5 at 256^2 (the port's logical 2 x 4 mesh on the CPU against JAX's
8-device CPU mesh) equal bench.py's; config 2 at 96^2 within 1%, the port
drawing the JAX package's tie noise. On the same object table, the forest
that bench._featurize_classify fits, carried across with
``forest_from_jax``, sees the port's training rows exactly and gives its
probabilities within atol 1e-6; the stand-in forest's fields, built into
the JAX package's ``ForestArrays``, give the port's stand-in probabilities
within atol 1e-6. Nothing falls back: ``forest="fit"`` without sklearn, a
tile the manifest marks failed, a sweep with a failed configuration and a
default device without a card all raise or exit non-zero.
"""
import builtins
import json
import os
import sys

import numpy as np
import pytest
import torch

import bench
from obia_tpu.classification import forest as jforest
from obia_tpu.ops import quickshift as jqs
from obia_tpu_torch import bench as tbench
from obia_tpu_torch.classification import forest as tforest
from obia_tpu_torch.ops import quickshift as tqs

ROW_KEYS = {"metric", "value", "unit", "elapsed_s", "first_run_s",
            "megapixels", "n_objects", "config", "device", "forest",
            "launches"}


@pytest.fixture(autouse=True)
def one_run(monkeypatch):
    monkeypatch.setenv("OBIA_BENCH_RUNS", "1")


def _jax_row(config, size):
    fn = getattr(bench, f"bench_config{config}")
    return fn(size, emit=False) if config in (1, 3, 4) else fn(size)


@pytest.mark.parametrize("config,size", [(1, 128), (4, 128), (3, 256),
                                         (5, 256)])
def test_object_counts_equal_bench_py(config, size):
    want = _jax_row(config, size)
    got = tbench.CONFIGS[config](size, device="cpu", emit=False)
    assert got["config"] == want["config"]
    assert got["n_objects"] == want["n_objects"] > 100
    assert got["megapixels"] == size * size / 1e6
    if config == 5:
        assert got["mesh"] == want["mesh"] == [2, 4]


def test_config2_object_count_within_one_percent(monkeypatch):
    want = _jax_row(2, 96)["n_objects"]
    monkeypatch.setattr(
        tqs, "_tie_noise", lambda seed, shape, device: torch.tensor(
            np.asarray(jqs._tie_noise(int(seed), tuple(shape)))).to(device))
    got = tbench.bench_config2(96, device="cpu", emit=False)["n_objects"]
    assert want > 100 and abs(got - want) <= 0.01 * want


@pytest.fixture(scope="module")
def tables():
    """The port's config-1 and config-4 object tables at 128^2."""
    s1, _ = tbench.run_config1(tbench.as_image(tbench.build_scene(128, 128)),
                               "cpu")
    s4, _ = tbench.run_config4(tbench.as_image(tbench.config4_scene(128)),
                               "cpu")
    return {1: s1.table, 4: s4.table}


@pytest.mark.parametrize("config", [1, 4])
def test_fit_forest_matches_bench_featurize_classify(tables, config,
                                                     monkeypatch):
    """bench._featurize_classify on the table as a frame (its JAX forest
    fitted by sklearn), and the port's ``forest="fit"`` with that forest
    carried across in place of its own fit: the same training rows, the
    same probabilities."""
    import pandas as pd
    table = tables[config]
    frame = pd.DataFrame({c: np.asarray(table[c]) for c in table.columns})
    seen = {}
    real_fit = jforest.JaxForestClassifier.fit

    def jax_fit(self, X, y):
        seen["jax"] = (np.asarray(X), np.asarray(y))
        return real_fit(self, X, y)

    monkeypatch.setattr(jforest.JaxForestClassifier, "fit", jax_fit)
    jclf = jforest.JaxForestClassifier(n_estimators=tbench.N_TREES,
                                       random_state=0)
    want = bench._featurize_classify(frame, jclf)

    def port_fit(self, X, y):
        seen["port"] = (np.asarray(X), np.asarray(y))
        self._arrays = tforest.forest_from_jax(jclf._arrays, self.device)
        return self

    monkeypatch.setattr(tforest.TorchForestClassifier, "fit", port_fit)
    got = tbench.featurize_classify(table, "cpu", forest="fit")
    np.testing.assert_array_equal(seen["port"][0], seen["jax"][0])
    np.testing.assert_array_equal(seen["port"][1], seen["jax"][1])
    assert got.shape == want.shape == (len(table), 2)
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("config", [1, 4])
def test_stand_in_forest_matches_jax_forest(tables, config):
    table = tables[config]
    X, _, idx = tbench.training_table(table)
    fields = tbench.forest_fields(X[idx], tbench.N_TREES)
    jclf = jforest.JaxForestClassifier.__new__(jforest.JaxForestClassifier)
    jclf._arrays = jforest.ForestArrays(
        fields["feature"].astype(np.int32), fields["threshold"],
        fields["left"].astype(np.int32), fields["right"].astype(np.int32),
        fields["leaf_proba"], fields["classes"], fields["max_depth"])
    want = jclf.predict_proba(X)
    got = tbench.featurize_classify(table, "cpu")  # the default forest
    assert got.shape == (len(table), 2)
    np.testing.assert_allclose(got, want, atol=1e-6)
    # a forest that discriminates: its leaves are not all one value
    assert got[:, 0].std() > 1e-3


def test_row_keys_and_values():
    row = tbench.bench_config1(96, device="cpu", emit=False)
    assert set(row) == ROW_KEYS
    assert row["unit"] == "MP/s" and row["device"] == "cpu"
    assert row["forest"] == "stand-in" and "vs_baseline" not in row
    assert row["value"] == row["megapixels"] / row["elapsed_s"]
    assert row["elapsed_s"] == row["first_run_s"]  # one run
    assert row["launches"] == dict.fromkeys(
        ("glcm_sums", "glcm_hist", "qs_density", "qs_parent", "slic_pass"),
        0)
    row2 = tbench.bench_config2(48, device="cpu", emit=False)
    assert set(row2) == ROW_KEYS and row2["forest"] is None


def test_runs_take_the_best(monkeypatch):
    monkeypatch.setenv("OBIA_BENCH_RUNS", "3")
    clock = iter([0.0, 5.0, 10.0, 12.0, 20.0, 23.0])
    monkeypatch.setattr(tbench.time, "perf_counter", lambda: next(clock))
    calls = []
    n, best, first, launches = tbench._timed(lambda: calls.append(1) or 7)
    assert (n, best, first, len(calls)) == (7, 2.0, 5.0, 3)


def test_fit_without_sklearn_raises(monkeypatch):
    real = builtins.__import__

    def blocked(name, *a, **k):
        if name.split(".")[0] == "sklearn":
            raise ImportError(f"No module named {name!r} (blocked)")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", blocked)
    for mod in [m for m in sys.modules if m.split(".")[0] == "sklearn"]:
        monkeypatch.delitem(sys.modules, mod)
    with pytest.raises(ImportError, match="sklearn"):
        tbench.bench_config1(64, device="cpu", forest="fit", emit=False)
    with pytest.raises(ImportError, match="scikit-learn"):
        tbench.run(64, 4, forest="fit", device="cpu")
    with pytest.raises(ValueError, match="forest must be one of"):
        tbench.run(64, 1, forest="probe", device="cpu")


def test_failed_tile_raises(monkeypatch, tmp_path):
    from obia_tpu_torch.utils import tiling

    def boom(*a, **k):
        raise RuntimeError("tile exploded")

    monkeypatch.setattr(tiling, "create_segments", boom)
    monkeypatch.setattr(tbench.tempfile, "tempdir", str(tmp_path))
    with pytest.raises(RuntimeError, match="tiles not done"):
        tbench.bench_config3(256, device="cpu", emit=False)
    assert os.listdir(tmp_path) == []  # the scene and outputs removed


def _fake_row(config):
    return lambda size, device=None, *a, **k: {
        "config": config, "value": 1.0, "n_objects": size}


def test_sweep_with_a_failed_config_exits_nonzero(monkeypatch, capsys):
    def boom(*a, **k):
        raise RuntimeError("config 3 exploded")

    monkeypatch.setattr(tbench, "bench_config1", _fake_row(
        "1-quickstart-slic-rf"))
    monkeypatch.setattr(tbench, "bench_config4", _fake_row(tbench.PRIMARY))
    monkeypatch.setattr(tbench, "bench_config5", _fake_row(
        "5-sharded-mosaic"))
    monkeypatch.setattr(tbench, "bench_config3", boom)
    monkeypatch.setattr(sys, "argv", ["bench", "64", "--device", "cpu"])
    assert tbench.script() == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["config"] == tbench.PRIMARY
    assert [r["config"] for r in line["rows"]] == [
        "1-quickstart-slic-rf", tbench.PRIMARY, "3-tiled-slic",
        "5-sharded-mosaic"]
    assert "config 3 exploded" in line["rows"][2]["error"]
    # config 3 once at min(size, 2048), config 5 once at size
    monkeypatch.setattr(tbench, "bench_config3", _fake_row("3-tiled-slic"))
    seen = []
    monkeypatch.setattr(tbench, "bench_config5", lambda size, *a, **k: (
        seen.append((size, k.get("runs"))) or {"config": "5"}))
    monkeypatch.setattr(sys, "argv", ["bench", "4096", "--device", "cpu"])
    assert tbench.script() == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["rows"][2]["n_objects"] == 2048 and seen == [(4096, 1)]


def test_cli_sweep_with_a_failed_config_exits_nonzero(monkeypatch):
    from click.testing import CliRunner

    from obia_tpu_torch.cli import build_cli

    def boom(*a, **k):
        raise RuntimeError("config 5 exploded")

    for c, name in ((1, "1-quickstart-slic-rf"), (4, tbench.PRIMARY),
                    (3, "3-tiled-slic")):
        monkeypatch.setattr(tbench, f"bench_config{c}", _fake_row(name))
    monkeypatch.setattr(tbench, "bench_config5", boom)
    res = CliRunner().invoke(build_cli(), ["bench", "--size", "64",
                                           "--device", "cpu"])
    assert res.exit_code != 0
    assert "5-sharded-mosaic" in res.output


def test_script_prints_a_zero_row_and_reraises(monkeypatch, capsys):
    def boom(*a, **k):
        raise RuntimeError("config 1 exploded")

    monkeypatch.setattr(tbench, "bench_config1", boom)
    monkeypatch.setattr(tbench, "CONFIGS", {**tbench.CONFIGS, 1: boom})
    monkeypatch.setattr(sys, "argv", ["bench", "--config", "1", "64",
                                      "--device", "cpu"])
    with pytest.raises(RuntimeError, match="exploded"):
        tbench.script()
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["value"] == 0.0 and "exploded" in line["error"]


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for config in (None, 1, 2, 3, 4, 5):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tbench.run(64, config)


def test_default_sizes_follow_bench_py():
    assert tbench.default_size(None) == tbench.default_size(1) == 4096
    assert tbench.default_size(2) == 1024
    assert tbench.default_size(5) == 4096  # the real size, not 768


# -- the detection configuration (tools/bench_detection.py) -------------------

def _tool_draws(monkeypatch, capsys, size, batch):
    """Run tools/bench_detection.py's ``main`` with its model, train step
    and predict replaced by recorders: returns (tiles, targets, scene) as
    the tool draws them, and the row it prints."""
    import importlib
    import importlib.util

    import jax.numpy as jnp

    from obia_tpu.detection import models as jmodels
    from obia_tpu.detection import train as jtrain
    # the module: the package's ``predict`` attribute is a function
    jpredict = importlib.import_module("obia_tpu.detection.predict")

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    seen = {}
    real_pad = jtrain._pad_batch

    class Model:
        params = {"w": jnp.zeros(1)}
        batch_stats = {}

        def anchors(self, hw):
            return np.zeros((1, 4), np.float32)

    def pad(images, targets):
        seen["images"], seen["targets"] = images, targets
        return real_pad(images, targets)

    def make_step(model, tx):
        return lambda params, bs, opt, *args, hw: (params, bs, opt,
                                                   jnp.float32(0.5))

    def infer(model, scene, **kw):
        seen["scene"] = scene
        return {"boxes": np.zeros((0, 4))}

    monkeypatch.setattr(jmodels, "build_detection_model",
                        lambda **kw: Model())
    monkeypatch.setattr(jtrain, "_pad_batch", pad)
    monkeypatch.setattr(jtrain, "_make_train_step", make_step)
    monkeypatch.setattr(jpredict, "infer_image_array", infer)
    monkeypatch.setattr(sys, "argv", ["bench_detection.py", str(size),
                                      str(batch)])
    monkeypatch.setattr(sys, "path", list(sys.path))
    for var in ("JAX_COMPILATION_CACHE_DIR",
                "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"):
        monkeypatch.setenv(var, os.environ.get(var, ""))
    spec = importlib.util.spec_from_file_location(
        "tool_bench_detection", os.path.join(root, "tools",
                                             "bench_detection.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    tool.main()
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return seen["images"], seen["targets"], seen["scene"], row


def test_detection_inputs_are_the_tools_draws(monkeypatch, capsys):
    images, targets, scene, _ = _tool_draws(monkeypatch, capsys, 96, 2)
    got_images, got_targets, got_scene = tbench.detection_inputs(96, 2)
    assert len(got_images) == len(images) == 2
    for g, w in zip(got_images, images):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    for g, w in zip(got_targets, targets):
        for k in ("boxes", "labels"):
            assert g[k].dtype == w[k].dtype
            assert np.array_equal(g[k], w[k])
    assert got_scene.dtype == scene.dtype and np.array_equal(got_scene,
                                                             scene)


def test_detection_row_has_the_tools_keys(monkeypatch, capsys):
    *_, tool_row = _tool_draws(monkeypatch, capsys, 128, 1)
    row = tbench.bench_detection(128, device="cpu", batch=1, emit=False,
                                 warm_runs=1)
    assert list(row) == list(tool_row) == ["detection_bench"]
    got, want = row["detection_bench"], tool_row["detection_bench"]
    assert set(got) == set(want) | {"device", "launches"}
    for k in ("tile", "batch", "backbone"):
        assert got[k] == want[k]
    assert got["device"] == "cpu" and not any(got["launches"].values())
    assert np.isfinite(got["loss"]) and got["loss"] > 0
    assert got["train_step_s"] > 0 and got["train_step_first_s"] > 0
    assert got["predict_s"] > 0 and got["n_detections"] >= 0
    assert got["train_images_per_s"] == 1 / got["train_step_s"]


def test_detection_command_routes_size_batch_and_device(monkeypatch):
    seen = []
    monkeypatch.setattr(tbench, "bench_detection", lambda *a: (
        seen.append(a) or {"detection_bench": {}}))
    tbench.main(["--config", "detection", "--device", "cpu"])
    tbench.main(["256", "--config", "detection", "--batch", "1",
                 "--device", "cpu"])
    assert seen == [(1024, "cpu", 2), (256, "cpu", 1)]
    assert tbench.default_size("detection") == 1024
    from click.testing import CliRunner

    from obia_tpu_torch.cli import build_cli
    res = CliRunner().invoke(build_cli(), [
        "bench", "--config", "detection", "--size", "64", "--batch", "3",
        "--device", "cpu"])
    assert res.exit_code == 0, res.output
    assert seen[-1] == (64, "cpu", 3)
    with pytest.raises(SystemExit):
        tbench.main(["--config", "6", "--device", "cpu"])


def test_detection_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbench.run(64, "detection")
