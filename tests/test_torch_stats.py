"""obia_tpu_torch spectral moments (ops/stats.py) against the JAX reference
and scipy on the CPU.

Bar: every moment within rtol 1e-4 of JAX ``spectral_moments_packed``, with
the same NaN slots (empty objects; zero-variance skewness and kurtosis). The
float32 sums run in the same pixel order in both, so the only looser bound
is the one the reference's own scipy test states for skewness and kurtosis
(rtol 1e-2, atol 2e-3 / 5e-3: float32 centred third and fourth powers
against scipy's float64).
"""
import numpy as np
import pytest
import torch
from scipy import stats as sps

import jax.numpy as jnp

from obia_tpu.ops.stats import spectral_moments_packed as jax_moments
from obia_tpu_torch.ops.stats import (SPECTRAL_PACK_ORDER, segment_sum,
                                      spectral_moments_packed)


def scene(seed, h=40, w=56, c=3, k=14):
    """Blobby objects with the edge cases: -1 pixels, an empty object id,
    a constant object and a 1-pixel object."""
    rng = np.random.default_rng(seed)
    lab = np.repeat(np.repeat(rng.integers(0, k - 2, (h // 8, w // 8)), 8,
                              0), 8, 1).astype(np.int32)
    lab[:3, :5] = -1
    lab[lab == 2] = 1                   # id 2 empty
    lab[20, 20] = k - 1                 # 1-pixel object
    img = (rng.normal(size=(h, w, c)) * 10 + 50).astype(np.float32)
    img[lab == 4] = 3.0                 # constant object
    return img, lab, k


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_moments_match_jax(seed):
    img, lab, k = scene(seed)
    names, want = jax_moments(jnp.asarray(img), jnp.asarray(lab), k)
    got_names, got = spectral_moments_packed(torch.as_tensor(img),
                                             torch.as_tensor(lab), k)
    assert tuple(got_names) == tuple(names) == SPECTRAL_PACK_ORDER
    assert got.shape == want.shape == (7, k, img.shape[2])
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_moments_match_scipy():
    img, lab, k = scene(3)
    _, got = spectral_moments_packed(torch.as_tensor(img),
                                     torch.as_tensor(lab), k)
    st = dict(zip(SPECTRAL_PACK_ORDER, got))
    for s in range(k):
        m = lab == s
        for b in range(img.shape[2]):
            v = img[..., b][m].astype(np.float64)
            if v.size == 0:
                assert np.isnan(st["mean"][s, b])
                continue
            assert st["count"][s, b] == v.size
            np.testing.assert_allclose(st["mean"][s, b], v.mean(), rtol=1e-5)
            np.testing.assert_allclose(st["variance"][s, b], v.var(),
                                       rtol=1e-4, atol=1e-6)
            assert st["min"][s, b] == v.min() and st["max"][s, b] == v.max()
            if v.var() == 0:
                assert np.isnan(st["skewness"][s, b])
                assert np.isnan(st["kurtosis"][s, b])
                continue
            np.testing.assert_allclose(st["skewness"][s, b], sps.skew(v),
                                       rtol=1e-2, atol=2e-3)
            np.testing.assert_allclose(st["kurtosis"][s, b],
                                       sps.kurtosis(v), rtol=1e-2, atol=5e-3)


def test_valid_mask_excludes_pixels():
    img, lab, k = scene(4)
    valid = np.ones(lab.shape, bool)
    valid[:, :8] = False
    _, got = spectral_moments_packed(torch.as_tensor(img),
                                     torch.as_tensor(lab), k,
                                     valid=torch.as_tensor(valid))
    _, want = spectral_moments_packed(torch.as_tensor(img),
                                      torch.as_tensor(np.where(valid, lab,
                                                               -1)), k)
    np.testing.assert_array_equal(got, want)


def test_segment_sum():
    vals = torch.arange(12, dtype=torch.float32).view(6, 2)
    seg = torch.tensor([0, 2, 0, 1, 2, 2])
    np.testing.assert_array_equal(segment_sum(vals, seg, 4).numpy(),
                                  [[4, 6], [6, 7], [20, 23], [0, 0]])
