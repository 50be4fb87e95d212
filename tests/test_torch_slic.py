"""obia_tpu_torch segmentation ops (color, normalisation, SLIC,
connectivity, merge, RLE) against the JAX reference on the CPU.

Bars: rgb_to_lab and the band normalisation at rtol 1e-5 (atol 1e-4 for Lab,
whose a/b channels cross 0; both are float32 chains of about ten operations);
SLIC labels as partitions (the k-means sums may be taken in another order);
CCL, dense relabel, small-segment merge and RLE bitwise, given the same input
raster (they are integer computations).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from obia_tpu.ops import connectivity as jconn
from obia_tpu.ops import slic as jslic
from obia_tpu_torch.ops import connectivity as tconn
from obia_tpu_torch.ops import slic as tslic


def same_partition(a, b) -> bool:
    """True when a and b split the pixels identically (ids may differ)."""
    a = np.asarray(a).reshape(-1)
    b = np.asarray(b).reshape(-1)
    pairs = np.unique(np.stack([a, b]), axis=1).shape[1]
    return pairs == len(np.unique(a)) == len(np.unique(b))


def lab_scene(seed, h=48, w=64):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([np.sin(yy / 9.0) + np.cos(xx / 13.0),
                     np.sin((yy + xx) / 15.0),
                     ((yy // 16 + xx // 16) % 3) / 2.0], axis=-1)
    img = base + rng.normal(0, 0.05, (h, w, 3))
    img = (img - img.min()) / (img.max() - img.min())
    return img.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_rgb_to_lab_matches_jax(seed):
    from obia_tpu.ops.color import rgb_to_lab as jlab
    from obia_tpu_torch.ops.color import rgb_to_lab

    rgb = np.random.default_rng(seed).uniform(-0.1, 1.1, (37, 3)).astype(
        np.float32)
    rgb[:4] = [[0, 0, 0], [1, 1, 1], [0.04, 0.04045, 0.05], [1, 0, 0]]
    np.testing.assert_allclose(rgb_to_lab(torch.as_tensor(rgb)).numpy(),
                               np.asarray(jlab(jnp.asarray(rgb))),
                               rtol=1e-5, atol=1e-4)


def test_normalize_select_matches_jax():
    from obia_tpu.segmentation.segment_boundaries import \
        _normalize_select as jnorm
    from obia_tpu_torch.segmentation.segment_boundaries import \
        _normalize_select

    img = np.random.default_rng(3).uniform(0, 255, (20, 30, 5)).astype(
        np.float32)
    img[..., 2] = 7.0  # constant band -> zeros
    bands = (0, 2, 4)
    np.testing.assert_allclose(
        _normalize_select(torch.as_tensor(img), bands).numpy(),
        np.asarray(jnorm(jnp.asarray(img), bands)), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("h,w,n", [(48, 64, 30), (97, 131, 200),
                                   (4096, 4096, 3000), (10, 300, 7)])
def test_grid_matches_jax(h, w, n):
    assert tslic._grid_shape(h, w, n) == jslic._grid_shape(h, w, n)
    assert tslic._grid_step(h, w, n) == jslic._grid_step(h, w, n)
    assert tslic._grid_half(h, w, n) == jslic._grid_half(h, w, n)


def test_initial_centers_match_jax():
    img = lab_scene(0)
    gh, gw = jslic._grid_shape(48, 64, 30)
    step, half = jslic._grid_step(48, 64, 30), jslic._grid_half(48, 64, 30)
    want = np.asarray(jslic.initial_centers(jnp.asarray(img), gh, gw, step,
                                            half))
    got = tslic.initial_centers(torch.as_tensor(img), gh, gw, step, half)
    np.testing.assert_array_equal(got.numpy(), want)


SLIC_CASES = {
    "default": {},
    "mask": {"mask": "half"},
    "slic_zero": {"slic_zero": True},
    "spacing": {"spacing": (1.0, 2.0)},
    "no_connectivity": {"enforce_connectivity": False},
}


@pytest.mark.parametrize("case", sorted(SLIC_CASES))
def test_slic_dense_partition_matches_jax(case):
    img = lab_scene(1)
    kw = dict(SLIC_CASES[case])
    if kw.get("mask") == "half":
        mask = np.ones(img.shape[:2], np.uint8)
        mask[:, :20] = 0
        kw["mask"] = mask
    jl, jk = jslic.slic_dense(jnp.asarray(img), n_segments=30,
                              compactness=10, **kw)
    tl, tk = tslic.slic_dense(torch.as_tensor(img), n_segments=30,
                              compactness=10, **kw)
    jl = np.asarray(jl)
    tl = tl.numpy()
    assert tk == jk
    np.testing.assert_array_equal(tl < 0, jl < 0)
    assert same_partition(tl, jl)


def _raw_slic(seed):
    img = lab_scene(seed)
    gh, gw = jslic._grid_shape(48, 64, 40)
    raw = jslic._slic_iterate(jnp.asarray(img), jnp.ones((48, 64), bool), gh,
                              gw, 10.0, 10, grid_step=jslic._grid_step(
                                  48, 64, 40),
                              grid_half=jslic._grid_half(48, 64, 40))
    return np.array(raw)  # writable copy for torch


def _snake():
    lab = np.zeros((21, 21), np.int32)
    lab[::4, :] = 1
    lab[1::4, -1] = 1
    lab[3::4, 0] = 1
    return lab


CCL_CASES = {
    "slic_a": lambda: _raw_slic(0),
    "slic_b": lambda: _raw_slic(2),
    "snake": _snake,
    "random_with_holes": lambda: np.where(
        np.random.default_rng(5).random((30, 40)) < 0.1, -1,
        np.random.default_rng(6).integers(0, 3, (30, 40))).astype(np.int32),
}


@pytest.mark.parametrize("case", sorted(CCL_CASES))
def test_ccl_dense_labels_bitwise(case):
    raw = CCL_CASES[case]()
    want, k, conv = jconn.scan_ccl_dense_labels(jnp.asarray(raw))
    if not bool(conv):
        want, k = jconn.fastsv_dense_labels(jnp.asarray(raw))
    got, tk = tconn.ccl_dense_labels(torch.as_tensor(raw))
    assert tk == int(k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", ["slic_a", "slic_b", "random_with_holes"])
@pytest.mark.parametrize("min_size,max_size", [(20, 150), (40, 80),
                                               (3, 10 ** 6)])
def test_merge_small_bitwise(case, min_size, max_size):
    raw = CCL_CASES[case]()
    lab, k, _ = jconn.scan_ccl_dense_labels(jnp.asarray(raw))
    k = int(k)
    want, wk = jconn.merge_small_device(lab, k, min_size, max_size)
    got, gk = tconn.merge_small_device(torch.as_tensor(np.array(lab)), k,
                                       min_size, max_size)
    assert gk == wk
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n_values", [300, 70000])
def test_rle_download_bitwise(monkeypatch, n_values):
    rng = np.random.default_rng(n_values)
    blocks = rng.integers(0, n_values, (20, 17)).astype(np.int32)
    lab = np.repeat(np.repeat(blocks, 6, axis=0), 8, axis=1)[:113, :131]
    lab[0, :7] = -1
    monkeypatch.setattr(jslic, "_RLE_MIN_PIXELS", 1)
    want = jslic.download_labels_rle(jnp.asarray(lab), n_values)
    got = tslic.download_labels_rle(torch.as_tensor(lab))
    assert got[2] == want[2]
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    lazy = tslic.LazyRLERaster(*got)
    np.testing.assert_array_equal(np.asarray(lazy), lab)
    assert lazy[5, 9] == lab[5, 9] and lazy.shape == lab.shape
