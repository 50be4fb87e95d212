"""obia_tpu_torch quickshift against the JAX package on the CPU.

The port's window scans run as their plain twins here (the tensors are on
the CPU); the JAX side runs its XLA core and its Pallas kernels in interpret
mode. Both get the same image and the JAX package's tie noise, injected in
place of the port's ``_tie_noise``. Bars: densities within rtol 1e-5 (the
bar of tests/test_quickshift_pallas.py; float32 sums in another order, and
the twin's ``exp`` against XLA's); parents and roots agree on >= 99.5% of
the pixels (a density tie can flip with the summation order), with ``dist``
equal to rtol 1e-5 where the parents agree; labels agree as partitions on
>= 99.5% of the pixels. A ``cuda`` case holds each kernel against its twin
on the card.

JAX is imported inside the tests that use it, so that the ``cuda`` cases
also run where only torch is installed (``pytest --noconftest -m cuda``).
"""
import numpy as np
import pytest
import torch

from obia_tpu_torch.ops import quickshift as tqs
from obia_tpu_torch.ops import quickshift_kernel as qk

CASES = [((64, 48, 3), 2.0, 4.0),    # several tiles, radius 6
         ((70, 300, 3), 1.0, 3.0),   # ragged edges, radius 3
         ((96, 80, 1), 2.0, 6.0)]    # one channel


def jax_noise(seed, shape):
    from obia_tpu.ops import quickshift as jqs
    return np.asarray(jqs._tie_noise(int(seed), tuple(shape)))


@pytest.fixture
def jax_tie_noise(monkeypatch):
    """The port draws the JAX package's noise for the same seed."""
    monkeypatch.setattr(tqs, "_tie_noise", lambda seed, shape, device:
                        torch.tensor(jax_noise(seed, shape)).to(device))


def partition_agreement(a: np.ndarray, b: np.ndarray) -> float:
    """Share of pixels whose segment is the same pixel set in both label
    rasters (ids may differ)."""
    a = np.unique(a.ravel(), return_inverse=True)[1]
    b = np.unique(b.ravel(), return_inverse=True)[1]
    pair = a.astype(np.int64) * (b.max() + 1) + b
    _, pinv, pcount = np.unique(pair, return_inverse=True,
                                return_counts=True)
    size_a = np.bincount(a)[a]
    size_b = np.bincount(b)[b]
    both = pcount[pinv]
    return float(((both == size_a) & (both == size_b)).mean())


def run_both(img: np.ndarray, k: float, md: float, seed: int = 42):
    """(JAX XLA core, JAX Pallas interpret core, port core) outputs as
    numpy: root, rho, parent, dist."""
    import jax.numpy as jnp
    from obia_tpu.ops import quickshift as jqs
    from obia_tpu.ops import quickshift_pallas as jqsp
    H, W, _ = img.shape
    noise = jax_noise(seed, (H, W))
    r = max(1, int(np.ceil(3 * k)))
    x = jqs._quickshift_core(jnp.asarray(img), jnp.asarray(noise), k, md,
                             1.0, r, r)
    p = jqsp.quickshift_core_pallas(jnp.asarray(img), jnp.asarray(noise), k,
                                    md, 1.0, r, interpret=True)
    t = tqs.quickshift_core(torch.tensor(img), torch.tensor(noise), k, md,
                            1.0, r)
    return ([np.asarray(v) for v in x], [np.asarray(v) for v in p],
            [v.numpy() for v in t])


def plateau():
    return np.full((64, 64, 3), 0.5, np.float32)


@pytest.mark.parametrize("shape,k,md", CASES)
def test_core_matches_jax(shape, k, md):
    img = np.random.default_rng(7).random(shape).astype(np.float32)
    x, p, t = run_both(img, k, md)
    for ref in (x, p):
        root, rho, parent, dist = ref
        np.testing.assert_allclose(t[1], rho, rtol=1e-5)
        same = t[2] == parent
        assert same.mean() >= 0.995, same.mean()
        assert (t[0] == root).mean() >= 0.995
        assert (np.isfinite(t[3]) == np.isfinite(dist))[same].all()
        both = same & np.isfinite(dist)
        np.testing.assert_allclose(t[3][both], dist[both], rtol=1e-5,
                                   atol=1e-6)


def test_core_matches_jax_on_a_plateau():
    """A constant image: the densities tie before the noise, so only the
    noise decides the parents."""
    x, p, t = run_both(plateau(), 2.0, 5.0, seed=3)
    for ref in (x, p):
        np.testing.assert_allclose(t[1], ref[1], rtol=1e-5)
        assert (t[2] == ref[2]).mean() >= 0.995
        assert (t[0] == ref[0]).mean() >= 0.995


@pytest.mark.parametrize("convert2lab", [True, False])
def test_public_quickshift_matches_jax(jax_tie_noise, convert2lab):
    from obia_tpu.ops import quickshift as jqs
    img = np.random.default_rng(3).random((40, 52, 3)).astype(np.float32)
    kw = dict(kernel_size=2, max_dist=6, rng=0, convert2lab=convert2lab)
    want, w_parent, w_dist = jqs.quickshift(img, return_tree=True, **kw)
    got, parent, dist = tqs.quickshift(img, return_tree=True,
                                       device="cpu", **kw)
    assert got.dtype == torch.int64 and parent.dtype == torch.int64
    got, parent, dist = got.numpy(), parent.numpy(), dist.numpy()
    assert partition_agreement(got, want) >= 0.995
    assert (parent == w_parent).mean() >= 0.995
    same = parent == w_parent
    np.testing.assert_allclose(dist[same], w_dist[same], rtol=1e-5)
    # raster-order (first-occurrence) compaction from 0
    first = {}
    for i, v in enumerate(got.ravel()):
        first.setdefault(int(v), i)
    order = [k for k, _ in sorted(first.items(), key=lambda kv: kv[1])]
    assert order == list(range(len(order)))


def test_integer_image_scales_like_its_float_copy():
    img8 = (np.random.default_rng(0).random((40, 44, 3)) * 255).astype(
        np.uint8)
    a = tqs.quickshift(img8, kernel_size=2, max_dist=6, rng=0, device="cpu")
    b = tqs.quickshift(img8.astype(np.float32) / 255.0, kernel_size=2,
                       max_dist=6, rng=0, device="cpu")
    assert torch.equal(a, b) and len(torch.unique(a)) > 1


def test_matches_naive_oracle(jax_tie_noise):
    """The per-pixel oracle of tests/test_quickshift.py."""
    from test_quickshift import naive_quickshift
    rng = np.random.default_rng(42)
    img = rng.random((18, 22, 2)).astype(np.float32)
    got = tqs.quickshift(img, ratio=1.0, kernel_size=2.0, max_dist=4.0,
                         random_seed=3, device="cpu").numpy()
    want = naive_quickshift(np.asarray(img, np.float64), 1.0, 2.0, 4.0,
                            jax_noise(3, (18, 22)))
    idx = rng.integers(0, got.size, size=(2000, 2))
    g, w = got.ravel(), want.ravel()
    agreement = ((g[idx[:, 0]] == g[idx[:, 1]])
                 == (w[idx[:, 0]] == w[idx[:, 1]])).mean()
    assert agreement > 0.99, agreement


def test_tie_noise_is_seeded_and_device_independent():
    a = tqs._tie_noise(5, (7, 9), "cpu")
    assert torch.equal(a, tqs._tie_noise(5, (7, 9), torch.device("cpu")))
    assert not torch.equal(a, tqs._tie_noise(6, (7, 9), "cpu"))
    assert a.dtype == torch.float32 and float(a.abs().max()) < 1e-4


def test_sigma_not_ported():
    with pytest.raises(NotImplementedError, match="sigma"):
        tqs.quickshift(np.zeros((8, 8, 3), np.float32), sigma=1.0,
                       device="cpu")


def test_cpu_tensor_takes_twin_and_counts_no_launch():
    img = torch.rand((3, 20, 33), generator=torch.Generator().manual_seed(0))
    before = dict(qk.launches)
    rho = qk.quickshift_density(img, 3, 1.0)
    d2, doff = qk.quickshift_parent(img, rho, 3, 3.0)
    assert qk.launches == before
    assert torch.equal(rho, qk.quickshift_density_reference(img, 3, 1.0))
    want_d2, want_off = qk.quickshift_parent_reference(img, rho, 3, 3.0)
    assert torch.equal(d2, want_d2) and torch.equal(doff, want_off)
    assert doff.dtype == torch.int32 and d2.dtype == torch.float32


def test_unsupported_device_raises():
    img = torch.zeros((3, 8, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        qk.quickshift_density(img, 2, 1.0)
    with pytest.raises(ValueError, match="unsupported device"):
        qk.quickshift_parent(img, torch.zeros((8, 8), device="meta"), 2, 1.0)


def test_non_finite_pixels_drop_out():
    """A NaN pixel neither adds to its neighbours' density nor becomes a
    parent; it is a root with density 1 (the JAX isfinite mask)."""
    img = torch.rand((3, 12, 14), generator=torch.Generator().manual_seed(1))
    img[:, 5, 6] = float("nan")
    rho = qk.quickshift_density_reference(img, 3, 1.0)
    assert torch.isfinite(rho).all() and float(rho[5, 6]) == 1.0
    d2, doff = qk.quickshift_parent_reference(img, rho + 1e-5, 3, 10.0)
    assert float(d2[5, 6]) == float("inf") and int(doff[5, 6]) == 0
    parent = torch.arange(12 * 14).view(12, 14) + doff
    assert int((parent == 5 * 14 + 6).sum()) == 1  # only itself


def test_tile_choice_and_radius_limit():
    assert qk.tile_height(3, 15, parent=True) == 16
    assert qk.tile_height(8, 30, parent=True) == 8
    for C in (1, 3, 8):
        r = qk.max_radius(C)
        assert r >= 30
        qk.tile_height(C, r, parent=True)
        with pytest.raises(ValueError, match="largest radius"):
            qk.tile_height(C, r + 1, parent=True)


def edge_scenes():
    """(name, (C, H, W) scaled image) scenes for the card."""
    rng = np.random.default_rng(11)
    return {
        "ragged_70x300_c3": rng.random((3, 70, 300)).astype(np.float32),
        "c1_96x80": rng.random((1, 96, 80)).astype(np.float32),
        "c8_64x64": rng.random((8, 64, 64)).astype(np.float32),
        "plateau_64x64": np.full((3, 64, 64), 0.5, np.float32),
    }


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("scene", sorted(edge_scenes()))
@pytest.mark.parametrize("radius", [3, 15])
def test_cuda_kernels_match_twins(cuda_device, scene, radius):
    img = torch.tensor(edge_scenes()[scene], device=cuda_device)
    H, W = img.shape[1:]
    k = radius / 3.0
    before = dict(qk.launches)
    rho = qk.quickshift_density(img, radius, k)
    want = qk.quickshift_density_reference(img, radius, k)
    torch.testing.assert_close(rho, want, rtol=1e-6, atol=0)
    noise = tqs._tie_noise(0, (H, W), cuda_device)
    rho_n = want + noise
    d2, doff = qk.quickshift_parent(img, rho_n, radius, 2.0 * k)
    w_d2, w_doff = qk.quickshift_parent_reference(img, rho_n, radius,
                                                  2.0 * k)
    torch.cuda.synchronize()
    assert qk.launches["qs_density"] == before["qs_density"] + 1
    assert qk.launches["qs_parent"] == before["qs_parent"] + 1
    assert torch.equal(d2, w_d2) and torch.equal(doff, w_doff)
