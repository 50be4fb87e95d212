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

from obia_tpu_torch import telemetry
from obia_tpu_torch.ops import quickshift as tqs
from obia_tpu_torch.ops import quickshift_kernel as qk


def qs_launches() -> dict:
    """Each quickshift kernel's launches in this process (telemetry
    counters)."""
    n = telemetry.counters()
    return {k: n.get(f"kernel.{k}", 0) for k in ("qs_density", "qs_parent")}


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
    """``sigma > 0`` (once not ported, and raising) pre-blurs the image
    with ``ops.filters.gaussian_filter`` before the density; the JAX
    comparison is in tests/test_torch_filters.py."""
    from obia_tpu_torch.ops.filters import gaussian_filter
    img = np.random.default_rng(4).random((20, 24, 3)).astype(np.float32)
    kw = dict(kernel_size=1.5, max_dist=4.0, convert2lab=False,
              device="cpu")
    got = tqs.quickshift(img, sigma=1.0, **kw)
    want = tqs.quickshift(gaussian_filter(torch.from_numpy(img), 1.0), **kw)
    assert torch.equal(got, want)
    assert not torch.equal(got, tqs.quickshift(img, **kw))


def test_cpu_tensor_takes_twin_and_counts_no_launch():
    img = torch.rand((3, 20, 33), generator=torch.Generator().manual_seed(0))
    before = qs_launches()
    rho = qk.quickshift_density(img, 3, 1.0)
    d2, doff = qk.quickshift_parent(img, rho, 3, 3.0)
    assert qs_launches() == before
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


def test_nan_kernel_size_gives_a_nan_density_on_the_cpu():
    """The twin sums the NaN terms of a NaN kernel_size, so its density is
    NaN everywhere; the card's wrapper raises instead (a ``cuda`` case)."""
    rho = qk.quickshift_density(torch.zeros((3, 8, 8)), 2, float("nan"))
    assert bool(torch.isnan(rho).all())


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
    # config 2: the density's halo is r = 15, the parent's rp = 10
    assert qk.tile_shape(3, 15, parent=False) == (32, 16)
    assert qk.parent_extents(15, 10.0)[0] == 10
    assert qk.tile_shape(3, 10, parent=True) == (32, 16)
    # eight bands: narrower tiles keep 16 rows where 32 lanes would fit 2
    assert qk.tile_shape(8, 15, parent=True) == (16, 16)
    assert qk.tile_shape(8, 30, parent=True) == (4, 16)
    assert qk.tile_shape(3, 42, parent=False) == (16, 16)
    for C in (1, 3, 8):
        for parent in (False, True):
            r = qk.max_radius(C, parent)
            assert r >= 30
            qk.tile_shape(C, r, parent=parent)
            with pytest.raises(ValueError, match="largest radius"):
                qk.tile_shape(C, r + 1, parent=parent)
        assert qk.max_radius(C, True) < qk.max_radius(C, False)
    # the parent's limit binds rp, not r: a window past it with a short
    # max_dist still fits
    r = qk.max_radius(3, parent=True) + 5
    rp, _ = qk.parent_extents(r, 4.5)
    assert rp == 4 and qk.tile_shape(3, rp, parent=True) == (32, 16)


@pytest.mark.parametrize("C", range(1, 10))
def test_every_radius_a_one_pixel_tile_took_still_fits(C):
    """A tile of 32 one-pixel threads a row, with the image and rho halos of
    both scans, took every radius up to the largest whose one-row halo fit;
    both strip kernels take all of them, and their shape stays in bounds."""
    planes = C + 1
    old = 0
    while 4 * planes * (2 * old + 3) * (32 + 2 * old + 2) <= qk.SMEM_LIMIT:
        old += 1
    for parent in (False, True):
        assert qk.max_radius(C, parent) >= old
        for r in (1, old // 2, old):
            lanes, th = qk.tile_shape(C, r, parent)
            assert lanes in qk.LANES and th in qk.TILE_HEIGHTS
            assert qk._fits(planes if parent else C, lanes, th, r)


@pytest.mark.parametrize("radius,max_dist", [
    (15, 10.0), (3, 2.5), (4, 9.0), (6, 0.6), (5, 1.0), (7, 10 ** 0.5),
    (2, 0.0), (3, -2.5), (4, float("inf")), (4, float("nan"))])
def test_parent_extents_are_the_disk(radius, max_dist):
    """rp and the row widths hold exactly the window offsets with
    dy^2 + dx^2 <= max_dist^2 (float32), and only those."""
    rp, widths = qk.parent_extents(radius, max_dist)
    max_d2 = float(np.float32(max_dist * max_dist))
    want = [(dy, dx) for dy, dx in qk.window_offsets(radius).tolist()
            if dy * dy + dx * dx <= max_d2]
    got = [tuple(o) for o in qk.disk_offsets(radius, max_dist).tolist()]
    assert got == want  # the same offsets in the same order
    assert len(widths) == 2 * rp + 1 and 0 <= rp <= radius
    assert all(abs(dy) <= rp and abs(dx) <= widths[dy + rp]
               for dy, dx in got)
    if radius == 15 and max_dist == 10.0:
        assert len(got) == 316  # config 2: 316 of the 960 offsets


def pruning_scene(kind):
    """(C, H, W) image and noised density for a pruning case."""
    rng = np.random.default_rng(21)
    img = rng.random((3, 23, 37)).astype(np.float32)
    if kind == "plateau":
        img[:] = 0.5
    if kind == "quantised":  # many exact colour ties: d2 == off2 happens
        img = np.floor(img * 3) / 3
    if kind == "nan_inf":
        img[:, 11, 17] = np.nan
        img[1, 4, 30] = np.inf
        img[:, 20, 2] = -np.inf
    x = torch.tensor(img.astype(np.float32))
    noise = torch.tensor(rng.normal(0, 1e-5, (23, 37)).astype(np.float32))
    return x, qk.quickshift_density_reference(x, 6, 2.0) + noise


@pytest.mark.parametrize("kind,radius,max_dist", [
    ("random", 6, 4.0), ("plateau", 6, 4.0), ("nan_inf", 6, 4.0),
    ("random", 6, 3.7), ("quantised", 6, 10 ** 0.5), ("random", 4, 9.0),
    ("random", 5, 0.6), ("quantised", 6, 5.0)])
def test_parent_pruned_to_the_disk_is_exact(kind, radius, max_dist):
    """The parent scan over the disk's offsets alone equals the scan over
    the whole window, bitwise: non-integer max_dist, max_dist > r and
    max_dist < 1 (every pixel a root) included."""
    x, rho = pruning_scene(kind)
    d2, doff = qk._parent_scan(x, rho, qk.disk_offsets(radius, max_dist),
                               max_dist)
    w_d2, w_doff = qk.quickshift_parent_reference(x, rho, radius, max_dist)
    assert torch.equal(d2, w_d2) and torch.equal(doff, w_doff)
    if max_dist < 1:
        assert not bool(doff.any()) and bool(torch.isinf(d2).all())
    else:
        assert bool(doff.any())


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
    before = qs_launches()
    rho = qk.quickshift_density(img, radius, k)
    want = qk.quickshift_density_reference(img, radius, k)
    torch.testing.assert_close(rho, want, rtol=1e-6, atol=0)
    noise = tqs._tie_noise(0, (H, W), cuda_device)
    rho_n = want + noise
    d2, doff = qk.quickshift_parent(img, rho_n, radius, 2.0 * k)
    w_d2, w_doff = qk.quickshift_parent_reference(img, rho_n, radius,
                                                  2.0 * k)
    torch.cuda.synchronize()
    assert qs_launches()["qs_density"] == before["qs_density"] + 1
    assert qs_launches()["qs_parent"] == before["qs_parent"] + 1
    assert torch.equal(d2, w_d2) and torch.equal(doff, w_doff)


def strip_cases():
    """(C, H, W, r, max_dist) for the strip kernels: widths that are not a
    multiple of P or of 32, widths under P, r in {1, 3, 15, 30, 42, limit}
    (tiles of 32, 16, 8 and 4 lanes), max_dist below 1, between and above r
    and inf, C in {1, 3, 8, 9} (9: the generic path). "limit" is the
    density's largest r for C, with the parent's rp at its own largest."""
    return {
        "c3_9x37_r1_md0.5": (3, 9, 37, 1, 0.5),
        "c3_20x3_r3_md2.5": (3, 20, 3, 3, 2.5),
        "c2_1x7_r3_md3": (2, 1, 7, 3, 3.0),
        "c1_33x161_r3_md10": (1, 33, 161, 3, 10.0),
        "c3_35x320_r6_md4": (3, 35, 320, 6, 4.0),
        "c4_21x163_r7_mdsqrt10": (4, 21, 163, 7, 10 ** 0.5),
        "c8_17x45_r15_md7.3": (8, 17, 45, 15, 7.3),
        "c3_40x170_r15_md10": (3, 40, 170, 15, 10.0),
        "c9_12x50_r3_md2": (9, 12, 50, 3, 2.0),
        "c9_16x33_r5_md9": (9, 16, 33, 5, 9.0),
        "c3_24x50_r4_mdinf": (3, 24, 50, 4, float("inf")),
        "c1_5x1_r3_md3": (1, 5, 1, 3, 3.0),
        "c8_40x90_r30_md30.5": (8, 40, 90, 30, 30.5),
        "c3_30x100_r42_md42.5": (3, 30, 100, 42, 42.5),
        "c1_20x70_limit": (1, 20, 70, "limit", None),
        "c3_12x165_limit": (3, 12, 165, "limit", None),
        "c8_10x40_limit": (8, 10, 40, "limit", None),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(strip_cases()))
@pytest.mark.parametrize("nan", [False, True])
def test_cuda_strip_kernels_match_twins(cuda_device, case, nan):
    C, H, W, r, md = strip_cases()[case]
    if r == "limit":
        r, md = qk.max_radius(C), qk.max_radius(C, parent=True) + 0.5
    rng = np.random.default_rng(H * W + C)
    img = rng.random((C, H, W)).astype(np.float32)
    if nan:
        img[:, H // 2, W // 2] = np.nan
        img[0, 0, W - 1] = np.inf
    x = torch.tensor(img, device=cuda_device)
    k = r / 3.0
    before = qs_launches()
    rho = qk.quickshift_density(x, r, k)
    want = qk.quickshift_density_reference(x, r, k)
    torch.testing.assert_close(rho, want, rtol=1e-6, atol=0)
    rho_n = want + torch.tensor(rng.normal(0, 1e-5, (H, W)).astype(
        np.float32), device=cuda_device)
    d2, doff = qk.quickshift_parent(x, rho_n, r, md)
    w_d2, w_doff = qk.quickshift_parent_reference(x, rho_n, r, md)
    torch.cuda.synchronize()
    assert qs_launches()["qs_density"] == before["qs_density"] + 1
    assert qs_launches()["qs_parent"] == before["qs_parent"] + 1
    assert torch.equal(d2, w_d2) and torch.equal(doff, w_doff)
    if md < 1:
        assert not bool(doff.any())


@pytest.mark.cuda
def test_cuda_each_kernel_raises_past_its_own_limit(cuda_device):
    for C in (1, 3, 8):
        x = torch.zeros((C, 8, 8), device=cuda_device)
        r_d, r_p = qk.max_radius(C), qk.max_radius(C, parent=True)
        with pytest.raises(ValueError, match="largest radius"):
            qk.quickshift_density(x, r_d + 1, 1.0)
        with pytest.raises(ValueError, match="largest radius"):
            qk.quickshift_parent(x, x[0], r_p + 1, r_p + 1.5)
        # a window past the parent's limit with a short max_dist fits
        qk.quickshift_parent(x, x[0], r_p + 1, 2.0)
    with pytest.raises(ValueError, match="kernel_size is NaN"):
        qk.quickshift_density(x, 2, float("nan"))
    attrs = qk.kernel_attributes(3)
    assert attrs["density"]["strip"] == qk.STRIP == attrs["parent"]["strip"]
