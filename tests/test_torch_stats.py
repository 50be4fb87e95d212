"""obia_tpu_torch spectral moments (ops/stats.py) against the JAX reference
and scipy on the CPU.

Bar: every moment within rtol 1e-4 of JAX ``spectral_moments_packed``, with
the same NaN slots (empty objects; zero-variance skewness and kurtosis).
Both packages form the per-pixel terms in float32; the port adds them in
float64 and rounds each sum once, so it is held at that bar to JAX's
moments with only the sums widened the same way (:func:`jax_moments64`),
and to the shipped float32 function at atol 1e-5: its float32 sums miss
the port's by up to 3.1e-6 past rtol 1e-4 in skewness on these scenes.
The only looser bound is the one the reference's own scipy test states for
skewness and kurtosis (rtol 1e-2, atol 2e-3 / 5e-3: float32 centred third
and fourth powers against scipy's float64). The sharded moments on the CPU
2 x 4 mesh are held to the single-device ones at rtol 2e-4 / atol 1e-5.
"""
import numpy as np
import pytest
import torch
from scipy import stats as sps

import jax.numpy as jnp

from obia_tpu.ops import stats as jstats
from obia_tpu.ops.stats import spectral_moments_packed as jax_moments
from obia_tpu_torch.ops.stats import (SPECTRAL_PACK_ORDER, moment_pass1,
                                      moment_pass2, moment_pixels,
                                      segment_spectral_moments, segment_sum,
                                      spectral_moments_packed)
from obia_tpu_torch.parallel import mesh as tmesh
from obia_tpu_torch.parallel.sharded import sharded_spectral_moments


def jax_moments64(img, lab, k):
    """(names, (7, k, C) numpy): JAX's moments with only the sums widened,
    as the port widens them. JAX's own row helpers form the float32
    per-pixel terms of a float32 image; those terms are added in float64
    with x64 on, each sum is rounded to float32 once, and JAX's finalize
    runs in float32."""
    import jax

    image = np.asarray(img, np.float32)
    C = image.shape[2]
    with jax.enable_x64(True):
        chans, labf, ok, lab_safe, okf = jstats._chunk_inputs(
            jnp.asarray(image), jnp.asarray(lab, jnp.int32), None, 0,
            image.shape[0], k)

        def sums(rows):
            return jstats.featurewise_segment_sum(
                [r.astype(jnp.float64) for r in rows], lab_safe,
                k + 1)[:k].astype(jnp.float32)

        s1c = sums(jstats._pass1_rows(chans, okf))
        cnt1, s1 = s1c[:, 0], s1c[:, 1:]
        mean = s1 / jnp.maximum(cnt1[:, None], 1.0)
        p2 = sums(jstats._pass2_rows(chans, mean, jnp.clip(labf, 0, k - 1),
                                     okf))
        xmin, xmax = jstats._moment_minmax(chans, ok, lab_safe, k,
                                           jnp.float32)
        out = jstats._moments_finalize(cnt1, s1, p2, xmin, xmax, C,
                                       jnp.float32)
        packed = np.stack([np.asarray(out[n])
                           for n in jstats.SPECTRAL_PACK_ORDER])
    return jstats.SPECTRAL_PACK_ORDER, packed


def shipped_gap(got, shipped, rtol, what=""):
    """The atol that ``assert_allclose(got, shipped, rtol)`` needs: the
    largest |got - shipped| - rtol * |shipped| over the slots where neither
    is NaN (0 where none is past the rtol). Printed, so that ``pytest -s``
    shows the gap that each bar is set from."""
    got = np.asarray(got, np.float64)
    shipped = np.asarray(shipped, np.float64)
    ok = ~(np.isnan(got) | np.isnan(shipped))
    excess = np.abs(got - shipped) - rtol * np.abs(shipped)
    gap = max(float(excess[ok].max()) if ok.any() else 0.0, 0.0)
    print(f"port vs shipped float32 JAX {what}: {gap:.3g} past rtol {rtol}")
    return gap


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
    names, want = jax_moments64(img, lab, k)
    got_names, got = spectral_moments_packed(torch.as_tensor(img),
                                             torch.as_tensor(lab), k)
    assert tuple(got_names) == tuple(names) == SPECTRAL_PACK_ORDER
    assert got.shape == want.shape == (7, k, img.shape[2])
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    # the shipped float32 function: its float32 sums miss the port's by up
    # to 3.1e-6 past rtol 1e-4 (skewness, seed 2)
    _, shipped = jax_moments(jnp.asarray(img), jnp.asarray(lab), k)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(shipped))
    assert shipped_gap(got, shipped, 1e-4, f"seed {seed}") <= 1e-5


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


def test_moment_passes_sum_in_float64():
    img, lab, k = scene(5)
    pix = moment_pixels(torch.as_tensor(img), torch.as_tensor(lab), k)
    s1c = moment_pass1(pix, k)
    assert s1c.dtype == torch.float64 and s1c.shape == (k, 1 + img.shape[2])
    mean = s1c[:, 1:].float() / torch.clamp(s1c[:, :1].float(), min=1.0)
    p2 = moment_pass2(pix, mean, k)
    assert p2.dtype == torch.float64 and p2.shape == (k, 3 * img.shape[2])
    # the sums of the float32 terms, added in float64
    for s in range(k):
        m = lab == s
        x = img[m].astype(np.float64)
        np.testing.assert_array_equal(s1c[s, 0].item(), m.sum())
        np.testing.assert_allclose(s1c[s, 1:].numpy(), x.sum(0), rtol=1e-12)
    out = segment_spectral_moments(torch.as_tensor(img), torch.as_tensor(lab),
                                   k)
    assert all(v.dtype == torch.float32 for v in out.values())


@pytest.mark.parametrize("seed", [6, 7, 8])
def test_sharded_moments_match_single_device_every_column(seed):
    img, lab, k = scene(seed, h=48, w=64)
    mesh = tmesh.make_mesh(8, ["cpu"])
    want = segment_spectral_moments(torch.as_tensor(img),
                                    torch.as_tensor(lab), k)
    got = sharded_spectral_moments(
        mesh, tmesh.shard_raster(mesh, img)[0],
        tmesh.shard_raster(mesh, lab, fill=-1)[0], k)
    assert set(got) == set(want) == set(SPECTRAL_PACK_ORDER)
    for name in SPECTRAL_PACK_ORDER:
        torch.testing.assert_close(got[name], want[name], rtol=2e-4,
                                   atol=1e-5, equal_nan=True, msg=name)
