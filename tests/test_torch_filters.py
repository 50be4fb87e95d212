"""obia_tpu_torch.ops.filters against the JAX package and scipy on the CPU,
and the ``sigma > 0`` pre-blur of SLIC and quickshift against JAX's.

Bars: the padding, ``maximum_filter`` and ``disk_footprint`` bitwise
(np.pad / JAX / scipy); the float filters within rtol 1e-6 / atol 1e-6 of
JAX's function and of scipy's (float32 sums of the same taps, in another
order), including a radius larger than the image side; SLIC with
``sigma=1`` through ``create_segments`` the same partition as JAX's, and
quickshift with ``sigma=1`` (JAX's tie noise) partitions agreeing on >=
99.5% of the pixels. A ``cuda`` case holds the card's blur to the CPU's.
"""
import numpy as np
import pytest
import torch
from scipy import ndimage as ndi

from obia_tpu_torch.ops import filters as F

MODES = ["reflect", "nearest", "mirror", "constant"]
NP_MODE = {"reflect": "symmetric", "nearest": "edge", "mirror": "reflect",
           "constant": "constant"}
TOL = dict(rtol=1e-6, atol=1e-6)


def _arr(seed=0, shape=(40, 52)):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _jax(name, *args, **kw):
    from obia_tpu.ops import filters as jf
    return np.asarray(getattr(jf, name)(*args, **kw))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape,pad", [((5, 7), (2, 3)), ((3, 4), (7, 9)),
                                       ((1, 2), (4, 5)), ((6, 6), (0, 6))])
def test_padding_is_np_pad(mode, shape, pad):
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape) + 1
    got = F.pad2d(_t(x), (pad[0], pad[1]), (pad[1], pad[0]), mode).numpy()
    want = np.pad(x, ((pad[0], pad[1]), (pad[1], pad[0])),
                  mode=NP_MODE[mode])
    np.testing.assert_array_equal(got, want)


def test_padding_keeps_trailing_dims():
    x = _arr(1, (6, 5, 3))
    got = F.pad2d(_t(x), (4, 2), (1, 7), "reflect").numpy()
    np.testing.assert_array_equal(
        got, np.pad(x, ((4, 2), (1, 7), (0, 0)), mode="symmetric"))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("sigma,shape", [(1.0, (40, 52)), (2.0, (40, 52)),
                                         (3.0, (6, 7))])
def test_gaussian_matches_jax_and_scipy(mode, sigma, shape):
    x = _arr(2, shape)
    got = F.gaussian_filter(_t(x), sigma, mode=mode).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, _jax("gaussian_filter", x, sigma,
                                         mode=mode), **TOL)
    np.testing.assert_allclose(got, ndi.gaussian_filter(x, sigma, mode=mode),
                               **TOL)


def test_gaussian_per_channel_equals_each_channel():
    x = _arr(3, (20, 24, 3))
    got = F.gaussian_filter(_t(x), 1.0).numpy()
    for c in range(3):
        np.testing.assert_array_equal(
            got[..., c], F.gaussian_filter(_t(x[..., c]), 1.0).numpy())


def test_gaussian_sigma_zero_is_float32_identity():
    x = (_arr(4) * 255).astype(np.uint8)
    got = F.gaussian_filter(_t(x), 0.0)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), x.astype(np.float32))
    with pytest.raises(ValueError):
        F.gaussian_filter(_t(x), -1.0)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("size", [3, 4, 5, 9])
def test_maximum_filter_bitwise(mode, size):
    x = _arr(5)
    got = F.maximum_filter(_t(x), size, mode=mode).numpy()
    np.testing.assert_array_equal(got, _jax("maximum_filter", x, size,
                                            mode=mode))
    np.testing.assert_array_equal(got, ndi.maximum_filter(x, size=size,
                                                          mode=mode))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("size", [3, 5])
def test_uniform_filter_matches_jax_and_scipy(mode, size):
    x = _arr(6)
    got = F.uniform_filter(_t(x), size, mode=mode).numpy()
    np.testing.assert_allclose(got, _jax("uniform_filter", x, size,
                                         mode=mode), **TOL)
    np.testing.assert_allclose(got, ndi.uniform_filter(x, size=size,
                                                       mode=mode), **TOL)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("axis", [0, 1])
def test_sobel_matches_jax_and_scipy(mode, axis):
    x = _arr(7)
    got = F.sobel(_t(x), axis=axis, mode=mode).numpy()
    np.testing.assert_allclose(got, _jax("sobel", x, axis=axis, mode=mode),
                               **TOL)
    np.testing.assert_allclose(got, ndi.sobel(x, axis=axis, mode=mode),
                               **TOL)


@pytest.mark.parametrize("mode", MODES)
def test_laplacian_matches_jax_and_scipy(mode):
    """rtol 1e-6 of the summed terms' magnitude: the -8 tap cancels the
    others, so an ulp of the partial sums (~1e3 on 0-255 input) is a large
    share of a result near 0 whatever the order of the float32 sum."""
    x = _arr(8) * 255
    k = np.array([[2, 0, 2], [0, -8, 0], [2, 0, 2]], np.float32)
    got = F.laplacian_3x3(_t(x), mode=mode).numpy()
    scale = ndi.correlate(np.abs(x).astype(np.float64), np.abs(k), mode=mode)
    for want in (_jax("laplacian_3x3", x, mode=mode),
                 ndi.correlate(x.astype(np.float64), k, mode=mode)):
        assert (np.abs(got - want) <= 1e-6 * scale + 1e-6).all()


@pytest.mark.parametrize("radius", [0, 1, 2, 3, 5])
def test_disk_footprint_bitwise(radius):
    from obia_tpu.ops import filters as jf
    np.testing.assert_array_equal(F.disk_footprint(radius),
                                  jf.disk_footprint(radius))


@pytest.mark.parametrize("radius,levels", [(2, 8), (3, 256)])
def test_local_entropy_matches_jax_and_histograms(radius, levels):
    img = np.random.default_rng(9).integers(0, levels, (20, 23)).astype(
        np.uint8)
    fp = F.disk_footprint(radius)
    got = F.local_entropy(_t(img), fp, n_levels=levels).numpy()
    np.testing.assert_allclose(got, _jax("local_entropy", img, fp,
                                         n_levels=levels), **TOL)
    # the histogram of every footprint window, counted in numpy
    pad = np.pad(img, radius, mode="symmetric")
    ys, xs = np.nonzero(fp)
    for r in range(img.shape[0]):
        for c in range(img.shape[1]):
            counts = np.bincount(pad[r + ys, c + xs], minlength=levels)
            p = counts[counts > 0] / counts.sum()
            assert abs(got[r, c] + (p * np.log2(p)).sum()) < 1e-5


def test_local_entropy_constant_and_checker():
    const = np.full((20, 20), 7, np.uint8)
    np.testing.assert_allclose(
        F.local_entropy(_t(const), F.disk_footprint(3)).numpy(), 0.0,
        atol=1e-6)
    checker = (np.indices((20, 20)).sum(0) % 2 * 255).astype(np.uint8)
    e = F.local_entropy(_t(checker), F.disk_footprint(3)).numpy()
    np.testing.assert_allclose(e[5:15, 5:15], 1.0, atol=0.05)


# -- the sigma > 0 pre-blur ---------------------------------------------------

def _slic_image(h=48, w=64):
    """The JAX package's Image, which both packages take."""
    from test_torch_slic import lab_scene
    from obia_tpu.geometry.affine import Affine
    from obia_tpu.handlers.geotif import image_from_array
    return image_from_array((lab_scene(0, h, w) * 255).astype(np.uint8),
                            Affine(1, 0, 0, 0, -1, h), crs="EPSG:32633")


def _jax_labels(image, **kw):
    from obia_tpu.segmentation.segment_boundaries import (LABEL_RASTER_ATTR,
                                                          create_segments,
                                                          unwrap_attr)
    gdf = create_segments(image, **kw)
    return np.asarray(unwrap_attr(gdf.attrs[LABEL_RASTER_ATTR])), len(gdf)


def test_slic_sigma_matches_jax_partition():
    from test_torch_slic import same_partition
    from obia_tpu_torch.segmentation.segment_boundaries import create_segments
    image = _slic_image()
    kw = dict(method="slic", n_segments=24, compactness=10, sigma=1.0)
    layer = create_segments(image, device="cpu", **kw)
    want, n = _jax_labels(image, **kw)
    got = np.asarray(layer.label_raster)
    assert len(layer) == n > 5
    assert same_partition(got, want)
    plain = np.asarray(create_segments(image, device="cpu", **{
        **kw, "sigma": 0.0}).label_raster)
    assert not same_partition(got, plain)  # the blur took effect


def test_slic_sigma_blurs_after_lab():
    """The blur sits after RGB -> Lab: the blurred Lab image JAX's slic
    clusters equals the port's within the filter bars."""
    from obia_tpu.ops.color import rgb_to_lab as jlab
    from obia_tpu.ops.slic import _gaussian_blur
    from obia_tpu_torch.ops.color import rgb_to_lab
    from test_torch_slic import lab_scene
    rgb = lab_scene(1)
    want = np.asarray(_gaussian_blur(jlab(rgb), 1.0))
    got = F.gaussian_filter(rgb_to_lab(_t(rgb)), 1.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_quickshift_sigma_matches_jax_partition(monkeypatch):
    from obia_tpu.ops import quickshift as jqs
    from obia_tpu_torch.ops import quickshift as tqs
    from test_torch_quickshift import partition_agreement
    monkeypatch.setattr(tqs, "_tie_noise", lambda seed, shape, device:
                        torch.tensor(np.asarray(jqs._tie_noise(
                            int(seed), tuple(shape)))).to(device))
    image = _slic_image(40, 48)
    from obia_tpu_torch.segmentation.segment_boundaries import create_segments
    kw = dict(method="quickshift", kernel_size=2, max_dist=6.0, sigma=1.0)
    got = np.asarray(create_segments(image, device="cpu",
                                     **kw).label_raster)
    want, _ = _jax_labels(image, **kw)
    assert partition_agreement(got, want) >= 0.995


@pytest.mark.cuda
def test_card_blur_equals_cpu_blur():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    x = _arr(10, (300, 257, 3)) * 100
    for mode in MODES:
        cpu = F.gaussian_filter(_t(x), 1.0, mode=mode)
        card = F.gaussian_filter(_t(x).cuda(), 1.0, mode=mode).cpu()
        torch.testing.assert_close(card, cpu, rtol=1e-6, atol=0)
