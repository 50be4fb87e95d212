"""obia_tpu_torch/models/pipeline.py (the fused OBIA model and its sharded
training step) against obia_tpu/models/pipeline.py on the CPU, the JAX
head's parameters carried across with ``params_from_jax``.

Bars, and the gaps measured when they were set:
- ``_object_features`` on the same labels: means and log-counts rtol 1e-5,
  variances atol 1e-6 (measured: bitwise; the float32 sums add in the same
  pixel order);
- ``_standardize`` ddof 0: 1e-5 of the largest magnitude against JAX and
  against numpy's float64 population std (measured ~2e-7; the port works
  it in float64 and rounds once);
- the head on the same features: atol 1e-6 (measured ~1e-7);
- ``obia_forward`` at 128^2 x 4 and 96^2 x 3, 64 segments: labels equal or
  partitions agreeing on >= 99.9% of the pixels (measured: equal), logits
  within 1e-4 of their largest magnitude (measured 2.7e-6 / 3.8e-6);
- ``make_flagship``'s image bitwise JAX's;
- ``make_sharded_train_step`` on a 2 x 4 mesh of CPU shards against JAX's
  on the 8-device CPU mesh, the dry run's 256 x 512 x 3 with 16 segments
  (K = 18, Kpad 24: two shards hold only padding) and with 32 (K = 32),
  3 steps: loss rtol 1e-5 (measured 5.7e-6 / 1.8e-6), w1 and w2 within
  1e-5 of their largest magnitude (measured 1e-7), centres within 1e-5 in
  colour (measured 1.2e-6; JAX's centre sums are float32, the port's
  float64 rounded once) and 1e-3 px. The biases start at zero and hold
  only three updates: within 5e-5 of their largest magnitude (measured
  1.7e-5 / 5.0e-6). Both packages are 1.1e-5 to 9.8e-5 from the same step
  run in float64 there (the float32 variance s2/n - mean^2 cancels, and
  standardising a column whose objects barely differ amplifies it), so
  no bar between two float32 runs can be tighter; the port's error from
  float64 is held within 2x JAX's (measured <= 1.23x).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from obia_tpu.models import pipeline as jp
from obia_tpu.parallel.sharded import make_mesh as jax_mesh
from obia_tpu_torch.models import pipeline as tp
from obia_tpu_torch.parallel.mesh import make_mesh

from test_torch_quickshift import partition_agreement

DRY = (256, 512, 3)  # __graft_entry__.dryrun_multichip on 8 devices
N_CLASSES = 4
STEPS = 3


def _carry(params) -> dict:
    return {k: np.asarray(v) for k, v in params.items()}


def _rel(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


def test_params_round_trip_is_bitwise():
    p = _carry(jp.init_mlp_params(jax.random.PRNGKey(3), 9, 5))
    back = tp.params_to_jax(tp.params_from_jax(p, device="cpu"))
    assert set(back) == set(p)
    for k in p:
        assert back[k].dtype == p[k].dtype and np.array_equal(back[k], p[k])


def test_init_mlp_params_shapes_and_scale():
    m = tp.init_mlp_params(torch.Generator().manual_seed(1), 9, 8,
                           device="cpu")
    want = {"w1": (9, 64), "b1": (64,), "w2": (64, 8), "b2": (8,)}
    assert {k: tuple(v.shape) for k, v in m.named_parameters()} == want
    assert not m.b1.any() and not m.b2.any()
    assert abs(float(m.w1.detach().std()) * 3.0 - 1.0) < 0.15  # 1/sqrt(9)
    again = tp.init_mlp_params(1, 9, 8, device="cpu")
    assert torch.equal(again.w1, m.w1) and torch.equal(again.w2, m.w2)


@pytest.mark.parametrize("h,w,c,k", [(64, 80, 4, 30), (48, 40, 3, 7)])
def test_object_features_match_jax(h, w, c, k):
    rng = np.random.default_rng(h)
    img = rng.random((h, w, c)).astype(np.float32)
    lab = rng.integers(0, k, (h, w)).astype(np.int32)
    lab[: h // 4] = -1   # unlabelled pixels stay out
    lab[lab == 2] = 3    # an empty object
    jf, jc = (np.asarray(a) for a in jp._object_features(
        jnp.asarray(img), jnp.asarray(lab), k))
    tf, tc = tp._object_features(torch.as_tensor(img),
                                 torch.as_tensor(lab).long(), k)
    tf = tf.numpy()
    assert np.array_equal(tc.numpy(), jc)
    np.testing.assert_allclose(tf[:, :c], jf[:, :c], rtol=1e-5)
    np.testing.assert_allclose(tf[:, c:2 * c], jf[:, c:2 * c], atol=1e-6)
    np.testing.assert_allclose(tf[:, 2 * c], jf[:, 2 * c], rtol=1e-5)
    assert not tf[2].any()   # count 0: mean, variance, log1p all 0


def test_ordered_segment_sum_adds_in_row_order():
    """The moment sums on the CPU add each segment's float32 rows in row
    order (np.add.at's order), bitwise and run to run, at a size where a
    multi-threaded ``index_put_(accumulate=True)`` would add them with
    atomics in another order."""
    rng = np.random.default_rng(11)
    rows = (rng.random((256 * 256, 9)) * 1000).astype(np.float32)
    seg = rng.integers(0, 256, 256 * 256)
    want = np.zeros((256, 9), np.float32)
    np.add.at(want, seg, rows)
    for _ in range(3):
        got = tp._ordered_segment_sum(torch.as_tensor(rows),
                                      torch.as_tensor(seg), 256)
        assert np.array_equal(got.numpy(), want)


def test_standardize_is_population_std():
    rng = np.random.default_rng(5)
    f = (rng.normal(3.0, 2.0, (40, 9)) * rng.random(9) * 10).astype(
        np.float32)
    got = tp._standardize(torch.as_tensor(f)).numpy()
    want = np.asarray(jp._standardize(jnp.asarray(f)))
    ref = (f - f.mean(0, dtype=np.float64)) / (
        f.astype(np.float64).std(0, ddof=0) + 1e-6)
    assert got.dtype == np.float32
    assert _rel(got, want) < 1e-5 and _rel(got, ref) < 1e-5
    bessel = (f - f.mean(0)) / (f.std(0, ddof=1) + 1e-6)
    assert _rel(got, bessel) > 1e-3


def test_head_matches_mlp_apply():
    rng = np.random.default_rng(6)
    params = jp.init_mlp_params(jax.random.PRNGKey(1), 9, 8)
    x = rng.normal(size=(50, 9)).astype(np.float32)
    want = np.asarray(jp.mlp_apply(params, jnp.asarray(x)))
    got = tp.params_from_jax(_carry(params), device="cpu")(
        torch.as_tensor(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("h,w,c", [(128, 128, 4), (96, 96, 3)])
def test_obia_forward_matches_jax(h, w, c):
    img = np.random.default_rng(c).random((h, w, c)).astype(np.float32)
    gh, gw = jp._grid_shape(h, w, 64)
    params = jp.init_mlp_params(jax.random.PRNGKey(0), 2 * c + 1, 8)
    jl, jlab = (np.asarray(a) for a in jp.obia_forward(
        jnp.asarray(img), params, gh=gh, gw=gw))
    model = tp.params_from_jax(_carry(params), device="cpu")
    tl, tlab = tp.obia_forward(torch.as_tensor(img), model, gh=gh, gw=gw)
    tl, tlab = tl.detach().numpy(), tlab.numpy()
    assert tl.shape == jl.shape == (gh * gw, 8) and tlab.shape == (h, w)
    if not np.array_equal(tlab, jlab):
        assert partition_agreement(tlab, jlab) >= 0.999
        # the logits on JAX's labels: ties moved a few pixels
        feats, _ = tp._object_features(torch.as_tensor(img),
                                       torch.as_tensor(jlab).long(), gh * gw)
        tl = model(tp._standardize(feats)).detach().numpy()
    assert _rel(tl, jl) < 1e-4


def test_make_flagship_image_and_shapes():
    _, (image, model) = tp.make_flagship(device="cpu")
    _, (jimage, _) = jp.make_flagship()
    assert image.dtype == torch.float32
    assert np.array_equal(image.numpy(), np.asarray(jimage))
    fn, (image, model) = tp.make_flagship(64, 64, 3, 16, 4, device="cpu")
    jfn, (jimage, jparams) = jp.make_flagship(64, 64, 3, 16, 4)
    logits, labels = fn(image, model)
    jlogits, jlabels = jax.jit(jfn)(jimage, jparams)
    assert logits.shape == jlogits.shape == (16, 4)
    assert labels.shape == jlabels.shape == (64, 64)
    assert torch.isfinite(logits).all()


@functools.lru_cache(maxsize=None)
def _jax_run(n_segments: int):
    """JAX's sharded step, jitted once, run STEPS times on the dry run's
    scene: (the carried initial parameters, the scene, the targets, the
    parameters, losses and centres after each step)."""
    H, W, C = DRY
    mesh = jax_mesh(8)
    step, init, (gh, gw, K) = jp.make_sharded_train_step(
        mesh, H, W, C, n_segments, N_CLASSES)
    rng = np.random.default_rng(0)
    scene = rng.random((H, W, C)).astype(np.float32)
    targets = rng.integers(0, N_CLASSES, K).astype(np.int32)
    params, opt = init()
    p0 = _carry(params)
    image = jax.device_put(jnp.asarray(scene),
                           NamedSharding(mesh, P("ty", "tx", None)))
    centers = jp.initial_centers(jnp.asarray(scene), gh, gw)
    step = jax.jit(step)
    losses = []
    for _ in range(STEPS):
        params, opt, loss, centers = step(image, jnp.asarray(targets),
                                          centers, params, opt)
        losses.append(float(loss))
    return p0, scene, targets, _carry(params), losses, np.asarray(centers)


def _port_run(n_segments: int, p0, scene, targets, dtype=torch.float32):
    H, W, C = DRY
    step, init, (gh, gw, K) = tp.make_sharded_train_step(
        make_mesh(8, ["cpu"]), H, W, C, n_segments, N_CLASSES)
    assert K == len(targets)
    model, opt = init()
    assert opt == () and model.w1.device.type == "cpu"
    model = tp.params_from_jax(p0, device="cpu").to(dtype)
    image = torch.as_tensor(scene).to(dtype)
    centers = tp.initial_centers(torch.as_tensor(scene), gh, gw)
    losses = []
    for _ in range(STEPS):
        model, opt, loss, centers = step(image, torch.as_tensor(targets),
                                         centers, model, opt)
        losses.append(float(loss))
    return tp.params_to_jax(model), losses, centers.numpy()


@pytest.mark.parametrize("n_segments,K", [(16, 18), (32, 32)])
def test_sharded_train_step_matches_jax(n_segments, K):
    p0, scene, targets, jparams, jlosses, jcenters = _jax_run(n_segments)
    assert len(targets) == K
    params, losses, centers = _port_run(n_segments, p0, scene, targets)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert losses[-1] < losses[0]
    for k, bar in (("w1", 1e-5), ("w2", 1e-5), ("b1", 5e-5), ("b2", 5e-5)):
        assert _rel(params[k], jparams[k]) < bar, k
    C = DRY[2]
    np.testing.assert_allclose(centers[..., :C], jcenters[..., :C],
                               atol=1e-5)
    np.testing.assert_allclose(centers[..., C:], jcenters[..., C:],
                               atol=1e-3)


@pytest.mark.parametrize("n_segments", [16, 32])
def test_sharded_train_step_as_close_to_float64_as_jax(n_segments):
    p0, scene, targets, jparams, _, _ = _jax_run(n_segments)
    params, _, _ = _port_run(n_segments, p0, scene, targets)
    exact, _, _ = _port_run(n_segments, p0, scene, targets, torch.float64)
    for k in ("b1", "b2"):
        scale = np.abs(exact[k]).max()
        port = np.abs(params[k] - exact[k]).max() / scale
        ref = np.abs(jparams[k] - exact[k]).max() / scale
        assert port <= 2.0 * ref + 1e-6, (k, port, ref)


def test_ragged_split_raises():
    mesh = make_mesh(8, ["cpu"])   # (2, 4)
    with pytest.raises(ValueError, match="split evenly"):
        tp.make_sharded_train_step(mesh, 255, 512, 3, 16, 4)
    with pytest.raises(ValueError, match="split evenly"):
        tp.make_sharded_train_step(mesh, 256, 510, 3, 16, 4)
    step, init, _ = tp.make_sharded_train_step(mesh, 256, 512, 3, 16, 4)
    model, opt = init()
    with pytest.raises(ValueError, match="built for 256 x 512"):
        step(torch.zeros((128, 512, 3)), torch.zeros(18, dtype=torch.long),
             torch.zeros((3, 6, 5)), model, opt)
