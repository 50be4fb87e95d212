"""obia_tpu_torch GLCM (ops/glcm.py, ops/glcm_kernel.py) against the JAX
reference and a float64 oracle.

Bars: quantised levels and bounding-box/min-max tables bitwise equal to JAX;
the twin's integer sums exactly equal to sums recomputed in numpy from the
JAX levels; props equal to JAX ``segment_glcm_props_packed`` (its CPU path,
the plain reference of the Pallas kernel) at rtol 2e-4, atol 1e-5, as
tests/test_glcm_pallas.py holds the Pallas kernel; props equal to the
float64 oracle at rtol 1e-5 (the port finishes in float64 from exact sums
and rounds once to float32). The CUDA kernel is held against the twin in
the test marked ``cuda``, which runs only on a card.

JAX is imported inside the tests that use it, so that the ``cuda`` test also
runs where only torch is installed (``pytest --noconftest -m cuda``).
"""
import numpy as np
import pytest
import torch

from obia_tpu_torch.ops import glcm as tg
from obia_tpu_torch.ops import glcm_kernel

OFFSETS = tg.angle_offsets(2, tg.DEFAULT_ANGLES)


def edge_case_scene(seed=0, H=40, W=52, C=2):
    """Integer grey values 0..255 (well-conditioned correlation) on a grid
    of objects with every edge case: pixels outside every object (-1), an
    object id with no pixels, a constant object (quantiser inverse 0), a
    1-pixel object (no pairs), and objects on all four borders."""
    rng = np.random.default_rng(seed)
    lab = (np.arange(H)[:, None] // 8 * 7 + np.arange(W)[None, :] // 8)
    lab = lab.astype(np.int32)
    lab[10:16, 20:30] = -1
    lab[lab == 3] = 2                    # id 3: empty
    lab[33, 25] = lab.max() + 1          # 1-pixel object
    img = rng.integers(0, 256, (H, W, C)).astype(np.float32)
    img[lab == 9] = 42.0                 # constant object
    return img, lab, int(lab.max()) + 1


def blob_scene(seed, H=36, W=44, C=2):
    """Random blobby objects with float grey values."""
    rng = np.random.default_rng(seed)
    lab = np.repeat(np.repeat(rng.integers(0, 12, (H // 6 + 1, W // 4 + 1)),
                              6, 0), 4, 1)[:H, :W].astype(np.int32)
    lab[rng.random((H, W)) < 0.05] = -1
    img = rng.normal(100.0, 30.0, (H, W, C)).astype(np.float32)
    return img, lab, 12


SCENES = {"edge_cases": lambda: edge_case_scene(),
          "blobs_a": lambda: blob_scene(1), "blobs_b": lambda: blob_scene(2)}


def _inputs(img, lab, K, band):
    image = torch.as_tensor(img)
    labels = torch.as_tensor(lab)
    mins = tg.bbox_minmax(image, labels, K, (band,))
    mn = mins[:, 4].contiguous()
    inv = tg.quant_inv(-mins[:, 5] - mn, 256).contiguous()
    return (labels, image, band, tg._bboxes_from_mins(mins), mn, inv, 256,
            OFFSETS)


def _numpy_sums(q, lab, K, L=256):
    """Exact int64 (A, K, 7) sums + (A, K) sum 1/(1+d^2) from levels q."""
    H, W = lab.shape
    isums = np.zeros((len(OFFSETS), K, 7), np.int64)
    hsum = np.zeros((len(OFFSETS), K))
    for a, (dr, dc) in enumerate(OFFSETS):
        for r in range(H):
            for c in range(W):
                r2, c2 = r + dr, c + dc
                k = lab[r, c]
                if k < 0 or not (0 <= r2 < H and 0 <= c2 < W) \
                        or lab[r2, c2] != k:
                    continue
                i, j = int(q[r, c]), int(q[r2, c2])
                isums[a, k, :6] += [1, (i - j) ** 2, abs(i - j), i + j,
                                    i * i + j * j, i * j]
                hsum[a, k] += 1.0 / (1.0 + (i - j) ** 2)
        for k in range(K):
            m = np.zeros((L, L), np.int64)
            for r in range(H):
                for c in range(W):
                    r2, c2 = r + dr, c + dc
                    if lab[r, c] == k and 0 <= r2 < H and 0 <= c2 < W \
                            and lab[r2, c2] == k:
                        m[q[r, c], q[r2, c2]] += 1
            sym = m + m.T
            isums[a, k, 6] = (sym * sym).sum()
    return isums, hsum


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_quantised_levels_bitwise_equal_jax(scene):
    import jax.numpy as jnp
    from obia_tpu.ops.glcm import quantize_per_segment

    img, lab, K = SCENES[scene]()
    for band in range(img.shape[2]):
        want = np.asarray(quantize_per_segment(
            jnp.asarray(img[..., band]), jnp.asarray(lab), K, 256))
        args = _inputs(img, lab, K, band)
        got = glcm_kernel.quantise_pixels(args[0], args[1][..., band],
                                          args[4], args[5], 256).numpy()
        m = lab >= 0
        np.testing.assert_array_equal(got[m], want[m])


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_bbox_minmax_equals_jax(scene):
    import jax.numpy as jnp
    from obia_tpu.ops.glcm import _bbox_minmax

    img, lab, K = SCENES[scene]()
    bands = tuple(range(img.shape[2]))
    want = np.asarray(_bbox_minmax(jnp.asarray(img), jnp.asarray(lab), K,
                                   bands))[:K]
    got = tg.bbox_minmax(torch.as_tensor(img), torch.as_tensor(lab), K,
                         bands).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scene", ["edge_cases", "blobs_a"])
def test_twin_sums_exact(scene):
    import jax.numpy as jnp
    from obia_tpu.ops.glcm import quantize_per_segment

    img, lab, K = SCENES[scene]()
    q = np.asarray(quantize_per_segment(jnp.asarray(img[..., 0]),
                                        jnp.asarray(lab), K, 256))
    want_i, want_h = _numpy_sums(q, lab, K)
    got_i, got_h = glcm_kernel.glcm_sums_reference(*_inputs(img, lab, K, 0))
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_allclose(got_h.numpy(), want_h, rtol=1e-12)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_props_match_jax(scene):
    import jax.numpy as jnp
    from obia_tpu.ops.glcm import segment_glcm_props_packed as jax_props

    img, lab, K = SCENES[scene]()
    names, want = jax_props(jnp.asarray(img), jnp.asarray(lab), K)
    got_names, got = tg.segment_glcm_props_packed(
        torch.as_tensor(img), torch.as_tensor(lab), K)
    assert tuple(got_names) == tuple(names)
    assert got.shape == want.shape == (6, K, img.shape[2])
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)


def test_props_match_float64_oracle():
    from test_ops_stats import naive_glcm_props

    img, lab, K = edge_case_scene(C=1)
    _, got = tg.segment_glcm_props_packed(torch.as_tensor(img),
                                          torch.as_tensor(lab), K)
    want = naive_glcm_props(img[..., 0], lab, K)
    for p, name in enumerate(tg.GLCM_PROP_NAMES):
        np.testing.assert_allclose(got[p, :, 0], want[name], rtol=1e-5,
                                   atol=1e-7, err_msg=name)


def test_empty_tiny_and_constant_objects():
    img, lab, K = edge_case_scene()
    _, got = tg.segment_glcm_props_packed(torch.as_tensor(img),
                                          torch.as_tensor(lab), K)
    assert np.isnan(got[:, 3]).all()           # empty object
    assert np.isnan(got[:, K - 1]).all()       # 1-pixel object: no pairs
    const = got[:, 9, 0]                       # one level: C has one bin
    np.testing.assert_allclose(const, [0, 0, 1, 1, 1, 1])


def test_compute_asm_off_gives_nan_asm_energy():
    img, lab, K = edge_case_scene()
    _, got = tg.segment_glcm_props_packed(torch.as_tensor(img),
                                          torch.as_tensor(lab), K,
                                          compute_asm=False)
    assert np.isnan(got[3:5]).all()
    assert not np.isnan(got[0, 0]).any()


def test_cpu_tensors_take_the_twin_and_count_no_launch():
    img, lab, K = edge_case_scene()
    args = _inputs(img, lab, K, 1)
    before = glcm_kernel.launches
    got = glcm_kernel.glcm_sums(*args)
    want = glcm_kernel.glcm_sums_reference(*args)
    assert glcm_kernel.launches == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_other_devices_raise_instead_of_falling_back():
    img, lab, K = edge_case_scene()
    args = list(_inputs(img, lab, K, 0))
    args[0] = args[0].to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        glcm_kernel.glcm_sums(*args)


def test_levels_out_of_range_raise():
    img, lab, K = edge_case_scene()
    with pytest.raises(ValueError, match="levels"):
        tg.segment_glcm_props_packed(torch.as_tensor(img),
                                     torch.as_tensor(lab), K, levels=300)


@pytest.mark.slow
def test_twin_matches_pallas_interpret_kernel():
    """The twin's sums against the Pallas kernel run in interpret mode on
    the scene of tests/test_glcm_pallas.py."""
    import jax.numpy as jnp
    from obia_tpu.ops import glcm
    from obia_tpu.ops import glcm_pallas as gp
    from obia_tpu.ops.stats import pad_num_segments

    rng = np.random.default_rng(0)
    H = W = 128
    img = rng.integers(0, 256, (H, W, 1)).astype(np.float32)
    lab = (np.arange(H)[:, None] // 32 * 4
           + np.arange(W)[None, :] // 32).astype(np.int32)
    lab[:2, :2] = -1
    K = int(lab.max()) + 1
    K_pad = pad_num_segments(K)
    image, labels = jnp.asarray(img), jnp.asarray(lab)
    boxes = gp.segment_bboxes(labels, K_pad)
    meta, rc, J = gp.build_jobs(boxes)
    Hp, Wp = gp.padded_shape(H, W)
    mins = glcm._bbox_minmax(image, labels, K_pad, (0,))
    mn = mins[:K_pad, 4]
    inv = glcm.quant_inv(-mins[:K_pad, 5] - mn, 256)
    sums_A, asm_A = gp.glcm_pallas_band(
        gp.pad_band_f32(image, jnp.int32(0), Hp, Wp),
        gp.pad_labels(labels, Hp, Wp),
        (jnp.asarray(meta[:J]), jnp.asarray(rc[:J])), mn, inv, K_pad, 2,
        glcm.DEFAULT_ANGLES, valid_hw=(H, W), levels=256, interpret=True)
    isums, hsum = glcm_kernel.glcm_sums_reference(*_inputs(img, lab, K, 0))
    got_sums, got_asm = tg.sums_from_kernel(isums, hsum)
    np.testing.assert_allclose(got_sums.numpy(),
                               np.asarray(sums_A)[:, :K], rtol=1e-6)
    np.testing.assert_allclose(got_asm.numpy(), np.asarray(asm_A)[:, :K],
                               rtol=1e-6)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_cuda_kernel_matches_twin(cuda_device, scene):
    img, lab, K = SCENES[scene]()
    for band in range(img.shape[2]):
        args = [a.to(cuda_device) if torch.is_tensor(a) else a
                for a in _inputs(img, lab, K, band)]
        before = glcm_kernel.launches
        isums, hsum = glcm_kernel.glcm_sums(*args)
        torch.cuda.synchronize()
        assert glcm_kernel.launches == before + 1
        want_i, want_h = glcm_kernel.glcm_sums_reference(*args)
        assert torch.equal(isums, want_i)
        torch.testing.assert_close(hsum, want_h, rtol=1e-6, atol=0)
