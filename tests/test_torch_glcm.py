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
import math
import re
from pathlib import Path

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


def small_objects_scene(seed=5):
    """Many small objects: rectangles of 1-60 px with 10% of the pixels
    unlabelled, a constant one, and solid objects whose boxes hold 255 and
    256 px (the kernel's warp-per-object class, up to 224 pairs at an
    angle) and 257 and 272 px (its block-per-item class)."""
    rng = np.random.default_rng(seed)
    H, W = 120, 300
    lab = np.full((H, W), -1, np.int64)
    lab[2:17, 2:19] = 0            # 15 x 17 = 255 px
    lab[20:36, 2:18] = 1           # 16 x 16 = 256 px
    lab[40, 5:262] = 2             # 1 x 257 px
    lab[44:60, 2:19] = 3           # 16 x 17 = 272 px
    nxt, r = 4, 62
    while r < H:                   # rows of random rectangles below them
        h = int(rng.integers(1, 7))
        c = 0
        while c < W:
            w = int(rng.integers(1, 11))
            lab[r:r + h, c:c + w] = nxt
            nxt, c = nxt + 1, c + w
        r += h
    for r0 in range(2, 34, 6):     # and beside them
        for c0 in range(25, W, 9):
            lab[r0:r0 + int(rng.integers(1, 7)),
                c0:c0 + int(rng.integers(1, 10))] = nxt
            nxt += 1
    lab[(rng.random((H, W)) < 0.1) & (lab > 3)] = -1
    ids, inv = np.unique(lab, return_inverse=True)
    lab = (inv.reshape(H, W) - int(ids[0] < 0)).astype(np.int32)
    img = rng.integers(0, 256, (H, W, 1)).astype(np.float32)
    img[lab == lab[70, 5]] = 9.0   # a constant object
    return img, lab, int(lab.max()) + 1


def big_object_scene(seed=6):
    """One object over most of a 300 x 420 raster, values over all 256
    levels, a ring of unlabelled pixels and a few small objects."""
    rng = np.random.default_rng(seed)
    lab = np.zeros((300, 420), np.int32)
    lab[:3] = -1
    lab[:, -2:] = -1
    lab[100:104, 200:210] = 1
    lab[250:251, 20:40] = 2
    img = rng.uniform(0, 1000, (300, 420, 1)).astype(np.float32)
    return img, lab, 3


KERNEL_SCENES = {"small_objects": small_objects_scene,
                 "big_object": big_object_scene}
OFFSETS8 = tg.angle_offsets(2, [i * math.pi / 8 for i in range(8)])


def _scene_inputs(img, lab, K, levels, device="cpu"):
    image = torch.as_tensor(img, device=device)
    labels = torch.as_tensor(lab, device=device)
    mins = tg.bbox_minmax(image, labels, K, (0,))
    mn = mins[:, 4].contiguous()
    inv = tg.quant_inv(-mins[:, 5] - mn, levels).contiguous()
    return (labels, image, 0, tg._bboxes_from_mins(mins), mn, inv, levels,
            OFFSETS8)


def test_kernel_scenes_straddle_the_size_classes():
    img, lab, K = small_objects_scene()
    boxes = _scene_inputs(img, lab, K, 256)[3].long()
    area = (boxes[:, 1] - boxes[:, 0] + 1) * (boxes[:, 3] - boxes[:, 2] + 1)
    small = glcm_kernel.SMALL_MAX_PX
    assert area[:4].tolist() == [small - 1, small, small + 1, 272]
    sizes = np.bincount(lab[lab >= 0])
    assert sizes[4:].min() >= 1 and sizes[4:].max() <= 60 and K > 1000
    isums, _ = glcm_kernel.glcm_sums_reference(*_scene_inputs(img, lab, K,
                                                              256))
    assert int(isums[0, :4, 0].max()) > 32   # > 32 pairs at an angle
    img, lab, K = big_object_scene()
    args = _scene_inputs(img, lab, K, 256)
    q = glcm_kernel.quantise_pixels(args[0], args[1][..., 0], args[4],
                                    args[5], 256)
    assert len(np.unique(q.numpy()[lab == 0])) == 256


def test_small_class_cap_mirrors_the_kernel():
    """SMALL_MAX_PX is the tests' copy of the kernel's GLCM_SMALL_CAP."""
    src = (Path(glcm_kernel.__file__).parent.parent / "csrc" / "glcm.cu")
    m = re.search(r"^#define GLCM_SMALL_CAP (\d+)", src.read_text(), re.M)
    assert m and int(m.group(1)) == glcm_kernel.SMALL_MAX_PX


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [1, 2, 16, 256])
@pytest.mark.parametrize("scene", sorted(KERNEL_SCENES))
def test_cuda_kernel_size_classes_match_twin(cuda_device, scene, levels):
    """Both size classes, 8 offsets: integer sums equal to the twin's,
    sum 1/(1+d^2) within rtol 1e-6, two runs identical, one launch a
    call."""
    args = _scene_inputs(*KERNEL_SCENES[scene](), levels, cuda_device)
    before = glcm_kernel.launches
    isums, hsum = glcm_kernel.glcm_sums(*args)
    again = glcm_kernel.glcm_sums(*args)
    torch.cuda.synchronize()
    assert glcm_kernel.launches == before + 2
    want_i, want_h = glcm_kernel.glcm_sums_reference(*args)
    assert torch.equal(isums, want_i)
    torch.testing.assert_close(hsum, want_h, rtol=1e-6, atol=0)
    assert torch.equal(isums, again[0]) and torch.equal(hsum, again[1])
