"""obia_tpu_torch's detection training and inference against the JAX
package on the CPU: a model trained by JAX carried into the port, the
port's own overfit run, ``train_model`` with its checkpoints, and
``predict`` on a GeoTIFF.

Bars: JAX's overfit model (tests/test_detection.py:243, trained by JAX in
a module fixture) carried into the port gives, through ``predict`` and
``evaluate_model``, the same box count and labels, boxes within atol 1e-3
px, scores within atol 1e-5 and an equal AP; predict's uint8 raster is
bitwise JAX's; the port's own overfit run meets JAX's bar (loss below 10%
of its first value, AP@0.5 >= 0.9); a checkpoint of ``train_model`` loads
back equal on every tensor, and into JAX's model bitwise.
"""
import importlib
import json
import os

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from obia_tpu.detection import dataset as jdataset
from obia_tpu.detection import metrics as jmetrics
from obia_tpu.detection import models as jmodels
from obia_tpu.detection import train as jtrain
from obia_tpu.geometry import Affine as JAffine
from obia_tpu.io.tiff import write_tiff as jwrite_tiff
from obia_tpu_torch.detection import dataset as tdataset
from obia_tpu_torch.detection import metrics as tmetrics
from obia_tpu_torch.detection import models as tmodels
from obia_tpu_torch.detection import train as ttrain
from obia_tpu_torch.detection import utils as tutils

# the packages export a function ``predict`` over the module's name
jpredict = importlib.import_module("obia_tpu.detection.predict")
tpredict = importlib.import_module("obia_tpu_torch.detection.predict")

S = 128
CFG = dict(num_classes=2, in_channels=3, backbone_width=8, fpn_channels=32,
           stage_sizes=(1, 1, 1, 1))


def _scene(seed):
    """tests/test_detection.py:243's scenes: two bright 24-px squares on
    noise."""
    r = np.random.default_rng(seed)
    img = r.normal(0.0, 0.05, (S, S, 3)).astype(np.float32)
    boxes = []
    coords = [(20, 30), (70, 80)] if seed == 0 else [(40, 16), (90, 60)]
    for (x0, y0) in coords:
        img[y0:y0 + 24, x0:x0 + 24] += 1.0
        boxes.append([x0, y0, x0 + 24, y0 + 24])
    return img, np.array(boxes, np.float32), np.array([1, 1], np.int64)


def _as_predict_sees(img):
    """The scene as predict hands it to the network: min-max scaled to
    uint8 (predict.py:81-86), as float32."""
    lo, hi = float(img.min()), float(img.max())
    out = 255.0 * (img.astype(np.float64) - lo) / (hi - lo + 1e-8)
    return np.clip(out, 0, 255).astype(np.uint8).astype(np.float32)


class _Scenes:
    def __init__(self, imgs, boxes, labels):
        self.imgs, self.boxes, self.labels = imgs, boxes, labels

    def __len__(self):
        return len(self.imgs)

    def __getitem__(self, i):
        return (np.transpose(self.imgs[i], (2, 0, 1)),
                {"boxes": self.boxes[i], "labels": self.labels[i]})


def _overfit_scenes(scaled: bool):
    imgs, boxes, labels = zip(*[_scene(i) for i in range(2)])
    if scaled:
        imgs = [_as_predict_sees(i) for i in imgs]
    return _Scenes(list(imgs), list(boxes), list(labels))


@pytest.fixture(scope="module")
def jax_trained(tmp_path_factory):
    """JAX's overfit run of tests/test_detection.py:243 (Adam 2e-3, 400
    steps, its own jitted step), on the scenes as predict sees them, and
    the first scene written as a float32 GeoTIFF."""
    ds = _overfit_scenes(scaled=True)
    model = jmodels.build_detection_model(seed=0, image_size=(S, S), **CFG)
    tx = optax.adam(2e-3)
    opt_state = tx.init(model.params)
    step = jtrain._make_train_step(model, tx)
    pimgs, pboxes, plabels, pvalid, hw = jtrain._pad_batch(
        [ds[i][0] for i in range(2)], [ds[i][1] for i in range(2)])
    anchors = jnp.asarray(model.anchors(hw))
    args = tuple(jnp.asarray(a) for a in (pimgs, pboxes, plabels, pvalid))
    losses = []
    for _ in range(400):
        model.params, model.batch_stats, opt_state, loss = step(
            model.params, model.batch_stats, opt_state, args[0], anchors,
            args[1], args[2], args[3], hw)
        losses.append(float(loss))
    assert losses[-1] < 0.1 * losses[0], (losses[0], losses[-1])
    path = str(tmp_path_factory.mktemp("scene") / "scene0.tif")
    jwrite_tiff(path, _scene(0)[0], transform=JAffine(1, 0, 0, 0, -1, S))
    return model, ds, path


def _same_detections(got, want):
    assert len(got["boxes"]) == len(want["boxes"]) > 0
    assert np.array_equal(got["labels"], want["labels"])
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=1e-5)


def test_trained_jax_model_carried_into_the_port(jax_trained, monkeypatch):
    jm, ds, path = jax_trained
    tm = tmodels.detection_model_from_jax(jm.params, jm.batch_stats,
                                          device="cpu", **CFG)
    seen = {}

    def spy(pkg, fn):
        def wrapped(model, hwc, *a):
            seen[pkg] = np.asarray(hwc.cpu() if hasattr(hwc, "cpu")
                                   else hwc)
            return fn(model, hwc, *a)
        return wrapped

    monkeypatch.setattr(jpredict, "infer_image_array",
                        spy("jax", jpredict.infer_image_array))
    monkeypatch.setattr(tpredict, "infer_image_array",
                        spy("port", tpredict.infer_image_array))
    for thr in (0.5, 0.05):
        want = jpredict.predict(jm, path, score_threshold=thr)
        got = tpredict.predict(tm, path, device="cpu", score_threshold=thr)
        _same_detections(got, want)
        assert seen["port"].dtype == seen["jax"].dtype == np.uint8
        assert np.array_equal(seen["port"], seen["jax"])
        assert np.array_equal(seen["port"], _as_predict_sees(
            _scene(0)[0]).astype(np.uint8))
    assert len(want["boxes"]) >= 2

    want = jmetrics.evaluate_model(jm, ds, score_threshold=0.05)
    got = tmetrics.evaluate_model(tm, ds, score_threshold=0.05)
    assert got == want
    assert got["AP"] >= 0.9


def test_port_overfits_two_scenes():
    """The port's own run of tests/test_detection.py:243: the RetinaNet
    (same topology, narrow channels) memorises two synthetic scenes with
    Adam 2e-3 in 400 steps: the loss falls below 10% of its first value
    and AP@0.5 on the scenes reaches >= 0.9 through decode + NMS."""
    ds = _overfit_scenes(scaled=False)
    model = tmodels.build_detection_model(seed=0, image_size=(S, S),
                                          device="cpu", **CFG)
    step = ttrain.make_train_step(model, torch.optim.Adam(
        model.parameters(), lr=2e-3))
    images = [ds[i][0] for i in range(2)]
    targets = [ds[i][1] for i in range(2)]
    losses = [float(step(images, targets)) for _ in range(400)]
    assert np.isfinite(losses).all()
    assert losses[-1] < 0.1 * losses[0], (losses[0], losses[-1])
    res = tmetrics.evaluate_model(model, ds, score_threshold=0.05)
    assert res["AP"] >= 0.9, res
    assert res["n_images"] == 2 and res["n_ground_truth"] == 4


@pytest.fixture
def tiff_tiles(tmp_path):
    """Four 128^2 4-band uint16 GeoTIFF tiles with two boxes each, and an
    annotations.json (file_name/boxes/labels)."""
    rng = np.random.default_rng(20)
    ann = {}
    for i in range(4):
        img = (rng.random((S, S, 4)) * 4000).astype(np.uint16)
        boxes = []
        for _ in range(2):
            x0, y0 = (int(v) for v in rng.integers(8, 90, 2))
            img[y0:y0 + 28, x0:x0 + 28] += 20000
            boxes.append([x0, y0, x0 + 28, y0 + 28])
        name = f"tile_{i}.tif"
        jwrite_tiff(str(tmp_path / name), img,
                    transform=JAffine(1, 0, 0, 0, -1, S))
        ann[f"t{i}"] = {"file_name": name, "boxes": boxes, "labels": [1, 1]}
    with open(tmp_path / "annotations.json", "w") as f:
        json.dump(ann, f)
    return str(tmp_path), str(tmp_path / "annotations.json")


def test_train_model_checkpoints_round_trip(tiff_tiles, tmp_path, capsys):
    """``train_model`` for two epochs on a TIFF dataset: JAX's epoch line,
    one ``epoch_{i}.npz`` an epoch; the last loads into a fresh port model
    equal on every tensor and into JAX's model bitwise, and both forwards
    agree."""
    from obia_tpu.checkpoint import load_pytree as jload

    images_dir, ann_path = tiff_tiles
    ds = tdataset.TreeDetectionDataset(images_dir, ann_path,
                                       transforms=tutils.get_transforms(True))
    loader = tdataset.DataLoader(ds, batch_size=2, seed=0)
    cfg = dict(CFG, in_channels=4)
    model = tmodels.build_detection_model(device="cpu", **cfg)
    ckpt = str(tmp_path / "ckpt")
    out = ttrain.train_model(model, loader, num_epochs=2,
                             checkpoint_dir=ckpt)
    assert out is model
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(" - ")[0] for ln in lines] == ["Epoch 1/2", "Epoch 2/2"]
    assert all(np.isfinite(float(ln.split("Loss: ")[1])) for ln in lines)
    assert sorted(os.listdir(ckpt)) == ["epoch_1.npz", "epoch_2.npz"]

    back = tmodels.load_detection_checkpoint(
        os.path.join(ckpt, "epoch_2.npz"), device="cpu", **cfg)
    sd, sb = model.state_dict(), back.state_dict()
    assert set(sd) == set(sb)
    assert all(torch.equal(sd[k], sb[k]) for k in sd)

    tree = jload(os.path.join(ckpt, "epoch_2"))
    jm = jmodels.build_detection_model(image_size=(32, 32), **cfg)
    jm.params, jm.batch_stats = tree["params"], tree["batch_stats"]
    x = np.random.default_rng(21).random((1, S, S, 4)).astype(np.float32)
    jc, jb = jm.apply(jnp.asarray(x))
    with torch.no_grad():
        tc, tb = back.eval()(torch.as_tensor(x).permute(0, 3, 1, 2))
    for a, b in ((tc, jc), (tb, jb)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-4 * np.abs(b).max()


def test_dataset_loader_feeds_jax_batches_to_train_model(tiff_tiles):
    """The port's loader gives ``train_model`` JAX's loader's batches for a
    seed, epoch after epoch (the numpy shuffle and transform draws)."""
    images_dir, ann_path = tiff_tiles
    loaders = [
        mod.DataLoader(mod.TreeDetectionDataset(
            images_dir, ann_path, transforms=tf.get_transforms(True)),
            batch_size=3, seed=5)
        for mod, tf in ((tdataset, tutils),
                        (jdataset, importlib.import_module(
                            "obia_tpu.detection.utils")))]
    for _ in range(3):
        for (ti, tt), (ji, jt) in zip(*loaders):
            assert len(ti) == len(ji)
            assert all(np.array_equal(a, b) for a, b in zip(ti, ji))
            assert all(np.array_equal(a["boxes"], b["boxes"])
                       for a, b in zip(tt, jt))
