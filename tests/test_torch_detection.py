"""obia_tpu_torch's detection subsystem against the JAX package on the CPU
(``device="cpu"``): anchors, IoU, matching, losses, the RetinaNet forward
with weights carried across, BatchNorm's running statistics, one train
step, Adam, the batch pad, the dataset and loader, predict's raster, the
metrics, the drawing and the checkpoints.

Bars: anchors, pairwise IoU, ``match_anchors``' indices and labels, the
padded batch, the dataset's samples and the loader's order, predict's uint8
raster, ``nms_numpy``, ``calculate_iou`` and ``average_precision`` are
bitwise; box encode within rtol 1e-6 and decode within 1e-6 of each box's
largest coordinate; the losses within rtol 1e-5;
the carried-weight forward within rtol 1e-4 of each output's largest
magnitude (measured: <= 1e-6 at both depths); BatchNorm's running
statistics within rtol 1e-5 of each tensor's largest magnitude (the
unbiased variance ``torch.nn.BatchNorm2d`` stores would miss it by ~3e-4 at
C5); one train step's loss within rtol 1e-5 and each gradient within 1e-4
of its largest magnitude; Adam's update on equal gradients within 1e-7.
"""
import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from obia_tpu.detection import anchors as janchors
from obia_tpu.detection import dataset as jdataset
from obia_tpu.detection import metrics as jmetrics
from obia_tpu.detection import models as jmodels
from obia_tpu.detection import train as jtrain
from obia_tpu.detection import utils as jutils
from obia_tpu.geometry import Affine as JAffine
from obia_tpu.io.tiff import write_tiff as jwrite_tiff
from obia_tpu_torch import checkpoint as tck
from obia_tpu_torch.detection import anchors as tanchors
from obia_tpu_torch.detection import dataset as tdataset
from obia_tpu_torch.detection import metrics as tmetrics
from obia_tpu_torch.detection import models as tmodels
from obia_tpu_torch.detection import train as ttrain
from obia_tpu_torch.detection import utils as tutils

# the packages export a function ``predict`` over the module's name
tpredict = importlib.import_module("obia_tpu_torch.detection.predict")

SMALL = dict(num_classes=2, in_channels=3, backbone_width=8,
             fpn_channels=32, stage_sizes=(1, 1, 1, 1))
DEEP = dict(num_classes=2, in_channels=10, backbone_width=8,
            fpn_channels=32, stage_sizes=(3, 4, 6, 3))


def _t(a):
    return torch.as_tensor(np.array(a))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close_to_max(got, want, rtol, what=""):
    """|got - want| <= rtol * max|want|, elementwise."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= rtol * scale, (what, err, scale)


def _boxes(rng, n, lo=0.0, span=100.0, size=40.0):
    xy = rng.random((n, 2)) * span + lo
    return np.concatenate([xy, xy + 2.0 + rng.random((n, 2)) * size],
                          axis=1).astype(np.float32)


@pytest.fixture(scope="module")
def trees():
    """Flax ``{"params", "batch_stats"}`` trees at two depths, drawn by the
    port's initialiser and carried out with ``detection_state_to_jax_tree``
    (JAX's own eager init of the deep model alone takes ~20 s here)."""
    return {which: tmodels.detection_state_to_jax_tree(
        tmodels.build_detection_model(device="cpu", seed=i, **cfg))
        for i, (which, cfg) in enumerate((("small", SMALL), ("deep", DEEP)))}


def _jax_module(cfg):
    return jmodels.RetinaNet(**{k: v for k, v in cfg.items()})


def _carry(tree, cfg):
    return tmodels.detection_model_from_jax(tree["params"],
                                            tree["batch_stats"],
                                            device="cpu", **cfg)


def _walk(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


# -- anchors, IoU, matching ----------------------------------------------------

@pytest.mark.parametrize("hw", [(128, 128), (200, 333), (512, 384)])
def test_anchors_for_shape_bitwise(hw):
    want = janchors.anchors_for_shape(hw)
    got = tanchors.anchors_for_shape(hw)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_pairwise_iou_bitwise():
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, 300), _boxes(rng, 40)
    b[:3] = a[:3]  # exact overlaps
    b[3] = [5, 5, 5, 9]  # a degenerate box
    want = np.asarray(janchors.pairwise_iou(jnp.asarray(a), jnp.asarray(b)))
    got = tanchors.pairwise_iou(_t(a), _t(b)).numpy()
    assert np.array_equal(got, want)


def test_encode_decode_boxes():
    rng = np.random.default_rng(1)
    anchors, boxes = _boxes(rng, 500), _boxes(rng, 500)
    deltas = rng.normal(0, 2, (500, 4)).astype(np.float32)
    deltas[:5, 2:] = [[-20, 9], [7, -11], [6, 6], [-10, -10], [0, 0]]
    want = np.asarray(janchors.encode_boxes(jnp.asarray(anchors),
                                            jnp.asarray(boxes)))
    got = tanchors.encode_boxes(_t(anchors), _t(boxes)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    want = np.asarray(janchors.decode_boxes(jnp.asarray(anchors),
                                            jnp.asarray(deltas)))
    got = tanchors.decode_boxes(_t(anchors), _t(deltas)).numpy()
    # a corner is centre -/+ half the size: where the two nearly cancel,
    # an ulp of exp (the libraries' exp differ) counts at the size's scale
    row = np.abs(want).max(axis=1, keepdims=True)
    assert (np.abs(got - want) <= 1e-6 * row).all()


@pytest.mark.parametrize("case", ["dense", "padded", "ties", "none"])
def test_match_anchors_bitwise(case):
    rng = np.random.default_rng(2)
    anchors = janchors.anchors_for_shape((128, 96))
    gt = _boxes(rng, 12, span=80.0, size=50.0)
    valid = np.ones(12, bool)
    if case == "padded":
        valid[7:] = False
    elif case == "ties":
        gt[1] = gt[0]  # two gts with one best anchor: the first wins
        gt[5] = anchors[100]
    elif case == "none":
        valid[:] = False
    jb, jl = janchors.match_anchors(jnp.asarray(anchors), jnp.asarray(gt),
                                    jnp.asarray(valid))
    tb, tl = tanchors.match_anchors(_t(anchors), _t(gt), _t(valid))
    assert np.array_equal(tb.numpy(), np.asarray(jb))
    assert np.array_equal(tl.numpy(), np.asarray(jl))
    assert (tl.numpy() == 1).any() == (case != "none")
    if case == "padded":  # the valid rows alone, no mask: the same match
        tb2, tl2 = tanchors.match_anchors(_t(anchors), _t(gt[:7]))
        assert np.array_equal(tb2.numpy(), tb.numpy())
        assert np.array_equal(tl2.numpy(), tl.numpy())
    if case == "none":  # no gt rows at all: background, matched to row 0
        tb0, tl0 = tanchors.match_anchors(_t(anchors),
                                          torch.zeros((0, 4)))
        assert not tb0.any() and not tl0.any()


def test_match_anchors_low_quality_forced():
    """tests/test_detection.py's forced low-quality case in both packages:
    a thin box below fg_thresh still gets its best anchor."""
    anchors = np.array([[0.0, 0.0, 10.0, 10.0], [20.0, 20.0, 30.0, 30.0]],
                       np.float32)
    gt = np.array([[0.0, 0.0, 10.0, 4.0]], np.float32)
    jb, jl = janchors.match_anchors(jnp.asarray(anchors), jnp.asarray(gt),
                                    jnp.asarray([True]))
    tb, tl = tanchors.match_anchors(_t(anchors), _t(gt), _t([True]))
    assert tl.tolist() == np.asarray(jl).tolist() == [1, 0]
    assert tb.tolist() == np.asarray(jb).tolist() == [0, 0]


@pytest.mark.parametrize("kind", ["plain", "ties", "offset_classes",
                                  "huge_and_nan", "degenerate", "float32"])
def test_nms_numpy_equal(kind):
    """The port's windowed NMS keeps JAX's boxes in JAX's order: dense
    overlaps, score ties (the same unstable argsort), the per-class offset
    of predict, huge and NaN boxes, zero-area boxes, float32 input; at
    thresholds 0, 0.3, 0.5, 0.9 and -0.1, with and without the cap."""
    rng = np.random.default_rng(["plain", "ties", "offset_classes",
                                 "huge_and_nan", "degenerate",
                                 "float32"].index(kind))
    for _ in range(5):
        n = int(rng.integers(1, 1000))
        xy = rng.random((n, 2)) * rng.choice([50.0, 500.0, 4000.0])
        wh = rng.random((n, 2)) * rng.choice([5.0, 60.0, 400.0]) * \
            rng.random((n, 1)) ** 3
        boxes = np.concatenate([xy, xy + wh], axis=1)
        scores = rng.random(n).astype(np.float32)
        if kind == "ties":
            scores = np.round(scores * 4) / 4
        elif kind == "offset_classes":
            labels = rng.integers(1, 3, n)
            boxes = boxes + labels.astype(np.float64)[:, None] * (
                float(boxes.max()) + 1.0)
        elif kind == "huge_and_nan":
            boxes[rng.integers(0, n, 5)] *= 1e4
            boxes[rng.integers(0, n, 3), 2] = np.nan
        elif kind == "degenerate":
            boxes[::2, 2:] = boxes[::2, :2]
        elif kind == "float32":
            boxes = boxes.astype(np.float32)
        for thr in (0.0, 0.3, 0.5, 0.9, -0.1):
            for cap in (300, 7, 10 ** 9):
                want = janchors.nms_numpy(boxes, scores, thr, max_out=cap)
                got = tanchors.nms_numpy(boxes, scores, thr, max_out=cap)
                assert np.array_equal(got, want), (thr, cap, n)


# -- losses --------------------------------------------------------------------

def test_losses_match_jax():
    rng = np.random.default_rng(4)
    anchors = janchors.anchors_for_shape((128, 128))
    n = len(anchors)
    logits = rng.normal(-2, 3, (n, 3)).astype(np.float32)
    deltas = rng.normal(0, 0.5, (n, 4)).astype(np.float32)
    labels = rng.integers(0, 3, n)
    np.testing.assert_allclose(
        tmodels.focal_loss(_t(logits), _t(labels)).numpy(),
        np.asarray(jmodels.focal_loss(jnp.asarray(logits),
                                      jnp.asarray(labels))), rtol=1e-5,
        atol=1e-7)
    np.testing.assert_allclose(
        tmodels.smooth_l1(_t(deltas)).numpy(),
        np.asarray(jmodels.smooth_l1(jnp.asarray(deltas))), rtol=1e-5)
    gt = _boxes(rng, 5, span=70.0, size=40.0)
    gl = np.array([1, 2, 1, 1, 2])
    for m in (5, 0):
        pad = np.zeros((8, 4), np.float32)
        pad[:m] = gt[:m]
        pl = np.zeros(8, np.int32)
        pl[:m] = gl[:m]
        valid = np.arange(8) < m
        want = jmodels.retinanet_loss(
            jnp.asarray(logits), jnp.asarray(deltas), jnp.asarray(anchors),
            jnp.asarray(pad), jnp.asarray(pl), jnp.asarray(valid))
        got = tmodels.retinanet_loss(_t(logits), _t(deltas), _t(anchors),
                                     _t(gt[:m]), _t(gl[:m]))
        for g, w in zip(got, want):
            np.testing.assert_allclose(float(g), float(w), rtol=1e-5)


# -- the model -----------------------------------------------------------------

def test_flax_tree_paths_and_shapes_match(trees):
    """The port's model holds exactly the leaves of the reference's Flax
    init (paths, shapes, dtypes), and the carry and its inverse give a
    tree back bitwise."""
    want = jax.eval_shape(lambda: _jax_module(DEEP).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 10)), train=False))
    tree = trees["deep"]
    back = tmodels.detection_state_to_jax_tree(_carry(tree, DEEP))
    for coll in ("params", "batch_stats"):
        shapes = {k: (v.shape, v.dtype) for k, v in _walk(want[coll])}
        got = dict(_walk(tree[coll]))
        assert {k: (v.shape, v.dtype) for k, v in got.items()} == shapes
        for k, v in _walk(back[coll]):
            assert np.array_equal(v, got[k]), k


def test_init_distributions():
    """Flax's initialisers: truncated LeCun normal kernels, zero biases but
    the focal prior, BatchNorm at identity; the seed decides the draw."""
    m = tmodels.build_detection_model(device="cpu", **SMALL)
    for name, mod in m.named_modules():
        if isinstance(mod, torch.nn.Conv2d):
            w = mod.weight
            fan_in = w.shape[1] * w.shape[2] * w.shape[3]
            std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
            w = w.detach()
            assert float(w.abs().max()) <= 2 * std * (1 + 1e-6)
            if w.numel() > 1000:
                assert abs(float(w.std()) / ((1.0 / fan_in) ** 0.5) - 1) < 0.1
            if mod.bias is not None:
                want = -4.595 if name.endswith("cls_out") else 0.0
                assert torch.all(mod.bias == want), name
    a = tmodels.build_detection_model(device="cpu", seed=3, **SMALL)
    b = tmodels.build_detection_model(device="cpu", seed=3, **SMALL)
    c = tmodels.build_detection_model(device="cpu", seed=4, **SMALL)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["ResNet50_0.conv1.weight"],
                           sc["ResNet50_0.conv1.weight"])


@pytest.mark.parametrize("which", ["small", "deep"])
def test_forward_with_carried_weights(trees, which):
    """The eval forward at (1, 1, 1, 1) x 3 bands and at the real depth
    (3, 4, 6, 3) x 10 bands, width 8, FPN 32, 128^2: class logits and box
    deltas within rtol 1e-4 of each output's largest magnitude."""
    cfg = SMALL if which == "small" else DEEP
    tree = trees[which]
    tm = _carry(tree, cfg).eval()
    x = np.random.default_rng(5).random(
        (2, 128, 128, cfg["in_channels"])).astype(np.float32)
    jc, jb = jax.jit(lambda v, x: _jax_module(cfg).apply(v, x))(
        tree, jnp.asarray(x))
    with torch.no_grad():
        tc, tb = tm(_t(x).permute(0, 3, 1, 2))
    _close_to_max(tc, jc, 1e-4, "class logits")
    _close_to_max(tb, jb, 1e-4, "box deltas")


def _as64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("which", ["small", "deep"])
def test_batchnorm_running_statistics(trees, which, dtype):
    """One train-mode forward moves the running statistics by Flax's rule
    (biased batch variance, momentum 0.99). In float64 (JAX under
    ``enable_x64``) every running statistic is within 1e-10 of its
    tensor's largest magnitude (measured 1.4e-13 at the real depth). In
    float32 each running variance is within rtol 1e-5 of its largest
    magnitude; the running means, near zero, carry the float32 rounding of
    the train-mode activations: within 2e-4 of their largest magnitude
    (measured 1.1e-5 at (1, 1, 1, 1), 9.6e-5 at C5 of the real depth)."""
    cfg = SMALL if which == "small" else DEEP
    tree = trees[which]
    tm = _carry(tree, cfg).train()
    x = np.random.default_rng(6).random(
        (2, 128, 128, cfg["in_channels"]))
    with jax.enable_x64(dtype == "float64"):
        if dtype == "float64":
            tree, tm = _as64(tree), tm.double()
        else:
            x = x.astype(np.float32)
        _, new = jax.jit(lambda v, x: _jax_module(cfg).apply(
            v, x, train=True, mutable=["batch_stats"]))(tree, jnp.asarray(x))
    with torch.no_grad():
        tm(_t(x).permute(0, 3, 1, 2))
    got = dict(_walk(tmodels.detection_state_to_jax_tree(tm)["batch_stats"]))
    for k, v in _walk(new["batch_stats"]):
        bar = 1e-10 if dtype == "float64" else (
            1e-5 if k.endswith("var") else 2e-4)
        _close_to_max(got[k], v, bar, k)
    before = dict(_walk(tree["batch_stats"]))
    assert all(not np.array_equal(got[k], before[k]) for k in got)


def _two_images(rng, bands):
    """Two unequal images (100 x 120 and 128 x 90) with their boxes: the
    batch pads to 128 x 128."""
    imgs = [rng.random((bands, 100, 120)).astype(np.float32),
            rng.random((bands, 128, 90)).astype(np.float32)]
    for img in imgs:
        img[:, 20:50, 30:70] += 1.0
    targets = [{"boxes": np.array([[30, 20, 70, 50], [5, 60, 40, 95]],
                                  np.float32),
                "labels": np.array([1, 1], np.int64)},
               {"boxes": np.array([[30, 20, 70, 50]], np.float32),
                "labels": np.array([1], np.int64)}]
    return imgs, targets


def test_pad_batch_matches_jax():
    rng = np.random.default_rng(7)
    imgs, targets = _two_images(rng, 4)
    n = jtrain.MAX_GT + 40  # dense ground truth is kept whole
    targets[0] = {"boxes": np.tile([1.0, 1.0, 5.0, 5.0], (n, 1)).astype(
        np.float32), "labels": np.ones(n, np.int64)}
    jimg, jbox, jlab, jval, jhw = jtrain._pad_batch(imgs, targets)
    timg, tbox, tlab, thw = ttrain._pad_batch(imgs, targets, "cpu")
    assert thw == jhw == (128, 128)
    assert np.array_equal(timg.permute(0, 2, 3, 1).numpy(), jimg)
    for i in range(2):
        m = int(jval[i].sum())
        assert len(tbox[i]) == len(tlab[i]) == m
        assert np.array_equal(tbox[i].numpy(), jbox[i, :m])
        assert np.array_equal(tlab[i].numpy(), jlab[i, :m])
    assert len(tbox[0]) == n


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_train_step_loss_and_gradients(trees, dtype):
    """One train step on a padded batch of two unequal images, against
    JAX's loss (``_pad_batch``, ``retinanet_loss`` per image,
    ``cls.mean() + box.mean()``) differentiated by JAX. In float64 the loss
    is within rtol 1e-12 and each gradient within 1e-9 of its tensor's
    largest magnitude (measured 3.1e-13): the same function. In float32 the
    loss is within rtol 1e-5 and each gradient within 1e-3 of its tensor's
    largest magnitude, or 1e-6 of the model's largest gradient where a
    tensor's own gradients nearly cancel (measured 8.8e-4 for a backbone
    BatchNorm bias; 2.7e-3 of a P4 output kernel whose gradients, 2e-6,
    sum terms 1e3 times larger)."""
    tree = trees["small"]
    tm = _carry(tree, SMALL)
    imgs, targets = _two_images(np.random.default_rng(8), 3)
    jimg, jbox, jlab, jval, hw = jtrain._pad_batch(imgs, targets)
    timg, tbox, tlab, thw = ttrain._pad_batch(imgs, targets, "cpu")
    f64 = dtype == "float64"
    with jax.enable_x64(f64):
        if f64:
            tree = _as64(tree)
            jimg, jbox = jimg.astype(np.float64), jbox.astype(np.float64)
            tm, timg = tm.double(), timg.double()
            tbox = [b.double() for b in tbox]
        anchors = jnp.asarray(janchors.anchors_for_shape(hw), dtype)
        module = _jax_module(SMALL)

        def loss_fn(p):
            (cl, bd), _ = module.apply(
                {"params": p, "batch_stats": tree["batch_stats"]},
                jnp.asarray(jimg), train=True, mutable=["batch_stats"])
            cls_l, box_l = jax.vmap(
                lambda c, b, bx, lb, vl: jmodels.retinanet_loss(
                    c, b, anchors, bx, lb, vl))(
                cl, bd, jnp.asarray(jbox), jnp.asarray(jlab),
                jnp.asarray(jval))
            return cls_l.mean() + box_l.mean()

        jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(tree["params"])
    loss = ttrain.batch_loss(tm, timg, tbox, tlab, thw)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-12 if f64 else 1e-5)
    grads = {}
    for name, mod in tm.named_modules():
        path = name.replace(".", "/")
        if isinstance(mod, torch.nn.Conv2d):
            grads[f"{path}/kernel"] = mod.weight.grad.permute(2, 3, 1, 0)
            if mod.bias is not None:
                grads[f"{path}/bias"] = mod.bias.grad
        elif isinstance(mod, tmodels.BatchNorm):
            grads[f"{path}/scale"] = mod.weight.grad
            grads[f"{path}/bias"] = mod.bias.grad
    want = {k: np.asarray(v) for k, v in _walk(jgrads)}
    assert set(grads) == set(want)
    top = max(float(np.abs(v).max()) for v in want.values())
    for k, v in want.items():
        g = _np(grads[k])
        scale = float(np.abs(v).max())
        bar = 1e-9 * scale if f64 else max(1e-3 * scale, 1e-6 * top)
        assert float(np.abs(g - v).max()) <= bar, k


def test_adam_update_on_equal_gradients():
    """torch.optim.Adam(lr=1e-4) and optax.adam(1e-4) make the same update
    on the same gradients, step after step, within 1e-7 (the update is the
    parameter's change; the parameters start near zero, so that change is
    read without the rounding of a large parameter)."""
    rng = np.random.default_rng(9)
    p0 = rng.normal(0, 1e-3, (64, 33)).astype(np.float32)
    grads = [rng.normal(0, s, p0.shape).astype(np.float32)
             for s in (1.0, 1e-6, 3.0, 1e-3)]
    tx = optax.adam(1e-4)
    jp = jnp.asarray(p0)
    state = tx.init(jp)
    tp = torch.nn.Parameter(_t(p0))
    opt = torch.optim.Adam([tp], lr=1e-4)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        before = tp.detach().clone()
        tp.grad = _t(g)
        opt.step()
        np.testing.assert_allclose((tp.detach() - before).numpy(),
                                   np.asarray(upd), rtol=0, atol=1e-7)
        assert float(np.abs(np.asarray(upd)).max()) > 5e-5


def test_build_without_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmodels.build_detection_model(**SMALL)


def test_anchor_cache_follows_the_model():
    m = tmodels.build_detection_model(device="cpu", **SMALL)
    a = m.anchors((128, 256))
    assert a.device == m.device and a is m.anchors((128, 256))
    assert np.array_equal(a.numpy(), janchors.anchors_for_shape((128, 256)))


# -- dataset, transforms, loader -------------------------------------------------

@pytest.fixture
def tiff_dataset(tmp_path):
    """Six 4-band GeoTIFFs (float32, uint16, uint8) with a bright square
    each and its box."""
    rng = np.random.default_rng(10)
    images_dir = str(tmp_path / "imgs")
    os.makedirs(images_dir)
    ann = {}
    for i in range(6):
        img = rng.random((96 + 8 * i, 128, 4)) * 0.2
        x0, y0 = (int(v) for v in rng.integers(10, 60, 2))
        img[y0:y0 + 30, x0:x0 + 30] += 0.8
        img = {0: img.astype(np.float32),
               1: (img * 40000).astype(np.uint16),
               2: (img * 250).astype(np.uint8)}[i % 3]
        name = f"img_{i}.tif"
        jwrite_tiff(os.path.join(images_dir, name), img,
                    transform=JAffine(1, 0, 0, 0, -1, 128))
        ann[str(i)] = {"file_name": name,
                       "boxes": [[float(x0), float(y0), float(x0 + 30),
                                  float(y0 + 30)]],
                       "labels": [1]}
    ann_path = str(tmp_path / "annotations.json")
    with open(ann_path, "w") as f:
        json.dump(ann, f)
    return images_dir, ann_path


@pytest.mark.parametrize("train", [True, False])
def test_dataset_transforms_and_loader_bitwise(tiff_dataset, train):
    images_dir, ann_path = tiff_dataset
    jds = jdataset.TreeDetectionDataset(
        images_dir, ann_path, transforms=jutils.get_transforms(train))
    tds = tdataset.TreeDetectionDataset(
        images_dir, ann_path, transforms=tutils.get_transforms(train))
    for i in range(len(jds)):  # the transforms' draws advance together
        (ji, jt), (ti, tt) = jds[i], tds[i]
        assert ti.dtype == ji.dtype and np.array_equal(ti, ji)
        for k in ("boxes", "labels"):
            assert tt[k].dtype == jt[k].dtype
            assert np.array_equal(tt[k], jt[k])
    for collate in (None, jutils.collate_fn):
        jl = jdataset.DataLoader(jds, batch_size=4, seed=3,
                                 collate_fn=collate)
        tl = tdataset.DataLoader(tds, batch_size=4, seed=3,
                                 collate_fn=collate and tutils.collate_fn)
        assert len(tl) == len(jl) == 2
        for _ in range(2):  # two epochs: the shuffles advance together
            for (jimgs, jtg), (timgs, ttg) in zip(jl, tl):
                assert len(timgs) == len(jimgs)
                for a, b in zip(timgs, jimgs):
                    assert np.array_equal(a, b)
                for a, b in zip(ttg, jtg):
                    assert np.array_equal(a["boxes"], b["boxes"])


def test_calculate_iou_equal():
    rng = np.random.default_rng(11)
    for a, b in zip(_boxes(rng, 50).tolist(), _boxes(rng, 50).tolist()):
        assert tutils.calculate_iou(a, b) == jutils.calculate_iou(a, b)
    assert tutils.calculate_iou([0, 0, 2, 2], [1, 1, 3, 3]) == \
        pytest.approx(1 / 7)
    assert tutils.calculate_iou([0, 0, 1, 1], [5, 5, 6, 6]) == 0.0


# -- predict's raster --------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.uint16, np.uint8, np.float32,
                                   np.int16, np.uint32])
def test_predict_scaling_bitwise(tmp_path, dtype):
    """predict's global min-max scaling to uint8 equals the reference's
    (tests/test_detection.py:220: no integer wrap), a constant raster
    included."""
    rng = np.random.default_rng(12)
    info = np.iinfo(dtype) if np.issubdtype(dtype, np.integer) else None
    hi = min(info.max, 60000) if info else 1e4
    lo = max(info.min, -3000) if info else -50.0
    arr = rng.uniform(lo, hi, (40, 50, 3)).astype(dtype)
    arr[0, 0, 0] = dtype(hi)
    for a in (arr, np.full_like(arr, 7)):
        p = str(tmp_path / "r.tif")
        jwrite_tiff(p, a, transform=JAffine(1, 0, 0, 0, -1, 0))
        from obia_tpu.io.tiff import TiffReader
        image_array = TiffReader(p).read()
        data_min = float(image_array.min())
        data_max = float(image_array.max())
        want = image_array
        if data_max > data_min:  # the reference's predict.py:81-86
            want = 255.0 * (image_array.astype(np.float64) - data_min) / \
                (data_max - data_min + 1e-8)
        want = np.clip(want, 0, 255).astype(np.uint8)
        from obia_tpu_torch.io.tiff import TiffReader as TReader
        got = tpredict.scale_to_uint8(TReader(p).read(), "cpu")
        assert got.dtype == torch.uint8
        assert np.array_equal(got.numpy(), want)
    assert want.max() == 7 and got.numpy().max() == 7


# -- metrics ---------------------------------------------------------------------

def test_average_precision_equal():
    rng = np.random.default_rng(13)
    preds, gts = [], []
    for _ in range(5):
        gb = _boxes(rng, 6, span=80.0, size=20.0)
        pb = np.concatenate([gb + rng.normal(0, 3, gb.shape),
                             _boxes(rng, 4, span=80.0, size=20.0)])
        preds.append({"boxes": pb, "scores": rng.random(10),
                      "labels": rng.integers(1, 3, 10)})
        gts.append({"boxes": gb, "labels": rng.integers(1, 3, 6)})
    for thr in (0.3, 0.5, 0.75):
        assert tmetrics.average_precision(preds, gts, thr) == \
            jmetrics.average_precision(preds, gts, thr)
        blind_p = [{k: v for k, v in p.items() if k != "labels"}
                   for p in preds]
        assert tmetrics.average_precision(blind_p, gts, thr) == \
            jmetrics.average_precision(blind_p, gts, thr)


def test_average_precision_class_aware():
    """tests/test_detection.py:202 in both packages."""
    gt = [{"boxes": np.array([[0, 0, 10, 10.0]]), "labels": np.array([1])}]
    wrong = [{"boxes": np.array([[0, 0, 10, 10.0]]),
              "scores": np.array([0.9]), "labels": np.array([2])}]
    right = [dict(wrong[0], labels=np.array([1]))]
    blind = [{"boxes": np.array([[0, 0, 10, 10.0]]),
              "scores": np.array([0.9])}]
    for mod in (tmetrics, jmetrics):
        assert mod.average_precision(wrong, gt) == 0.0
        assert mod.average_precision(right, gt) == 1.0
        assert mod.average_precision(blind, [{"boxes": gt[0]["boxes"]}]) \
            == 1.0
        assert mod.average_precision(
            [{"boxes": np.zeros((0, 4)), "scores": np.zeros(0)}], gt) == 0.0


# -- drawing ---------------------------------------------------------------------

def test_visualize_predictions_same_rectangles():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rng = np.random.default_rng(14)
    img = rng.random((4, 64, 80)).astype(np.float32)
    boxes = _boxes(rng, 6, span=40.0, size=20.0)
    scores = rng.random(6).astype(np.float32)
    labels = np.array([1, 1, 2, 1, 2, 2])
    drawn = []
    for fn, args in ((jutils.visualize_predictions,
                      (img, boxes, scores, labels)),
                     (tutils.visualize_predictions,
                      (img, boxes, scores, labels))):
        fig, ax = plt.subplots()
        fn(*args, score_threshold=0.3, ax=ax)
        drawn.append(([(p.get_xy(), p.get_width(), p.get_height())
                       for p in ax.patches],
                      [t.get_text() for t in ax.texts],
                      ax.images[0].get_array().tolist()))
        plt.close(fig)
    assert drawn[0] == drawn[1]
    assert 0 < len(drawn[0][0]) < 6


# -- checkpoints -----------------------------------------------------------------

def test_jax_npz_tree_loads_into_the_port(trees, tmp_path):
    """A Flax tree saved as .npz (the reference's own flattening, its .npz
    layout) loads into the port, which then computes JAX's forward; the
    port's tree saved as .npz loads back into JAX bitwise."""
    from obia_tpu.checkpoint import load_pytree as jload
    from obia_tpu.checkpoint import _flatten as jflatten

    tree = trees["small"]
    path = str(tmp_path / "jax_epoch.npz")
    np.savez(path, **jflatten(tree))
    tm = tmodels.load_detection_checkpoint(path, device="cpu", **SMALL)
    x = np.random.default_rng(15).random((1, 128, 128, 3)).astype(np.float32)
    jc, _ = jax.jit(lambda v, x: _jax_module(SMALL).apply(v, x))(
        tree, jnp.asarray(x))
    with torch.no_grad():
        tc, _ = tm.eval()(_t(x).permute(0, 3, 1, 2))
    _close_to_max(tc, jc, 1e-4, "class logits")

    back = str(tmp_path / "port_epoch")
    tck.save_pytree(back, tmodels.detection_state_to_jax_tree(tm))
    got = jload(back)
    for coll in ("params", "batch_stats"):
        flat = dict(_walk(got[coll]))
        for k, v in _walk(tree[coll]):
            assert np.array_equal(flat[k], v), k
