"""The seam-spanner histogram (ops/glcm_kernel.glcm_hist and its twin) and
the sharded GLCM (parallel/glcm_sharded.py) against the JAX package on the
8-device CPU mesh of tests/conftest.py.

Bars: the twin's directed tables equal, integer for integer, to JAX's
``_glcm_hist_call`` run in interpret mode on the same halo'd shard windows
(every slot it visits); the sharded props equal to JAX's sharded Pallas
route (interpret mode) at rtol 2e-4 / atol 2e-5, as tests/test_parallel.py
holds that route, and the correlation to a float64 oracle at rtol 1e-5
(JAX forms it from float32 moment differences); the sharded integer sums,
spanners' sum (C + C^T)^2 included, bitwise equal to the port's
single-device sums of the same labels. The CUDA kernel is held against the
twin in the tests marked ``cuda``, which run only on a card (they import no
jax: ``pytest --noconftest -m cuda``).
"""
import numpy as np
import pytest
import torch

from obia_tpu_torch.ops import glcm as tg
from obia_tpu_torch.ops import glcm_kernel
from obia_tpu_torch.parallel import glcm_sharded as tgs
from obia_tpu_torch.parallel import mesh as tmesh

OFFSETS = tg.angle_offsets(2, tg.DEFAULT_ANGLES)
H, W = 32, 48          # 16 x 12 shards on the 2 x 4 mesh


def _dense(lab):
    """Objects renumbered 0..K-1 (-1 kept)."""
    ids, inv = np.unique(lab, return_inverse=True)
    out = inv.reshape(lab.shape).astype(np.int32) - int(ids[0] < 0)
    return out, int(out.max()) + 1


def seam_scene(seed=0):
    """Small grid objects everywhere, plus spanners across the row seam,
    a column seam and a corner of four shards, a constant-band spanner
    (quantiser inverse 0), a spanner with a 1-pixel piece on one shard, an
    object inside one shard and a masked hole."""
    rng = np.random.default_rng(seed)
    lab = (np.arange(H)[:, None] // 5 * 10
           + np.arange(W)[None, :] // 5).astype(np.int32)
    lab[12:20, 8:16] = 100      # corner of shards (0,0) (0,1) (1,0) (1,1)
    lab[2:8, 20:28] = 101       # column seam at 24
    lab[14:19, 30:34] = 102     # row seam at 16
    lab[20:30, 34:40] = 103     # column seam at 36, constant band
    lab[3:16, 44:48] = 104      # shard (0, 3) ...
    lab[16, 45] = 104           # ... and one pixel on shard (1, 3)
    lab[22:28, 2:8] = 105       # inside shard (1, 0)
    lab[24:26, 4:6] = -1        # masked hole
    lab, K = _dense(lab)
    img = rng.integers(0, 256, (H, W, 2)).astype(np.float32)
    img[lab == lab[20, 36]] = 5.0
    return img, lab, K


def random_scene(seed=42):
    rng = np.random.default_rng(seed)
    img = rng.random((H, W, 2)).astype(np.float32)
    lab = rng.integers(0, 5, (H, W)).astype(np.int32)
    return img, lab, 5


def interior_hole_scene(seed=42):
    rng = np.random.default_rng(seed)
    img = rng.random((H, W, 2)).astype(np.float32)
    lab = rng.integers(0, 5, (H, W)).astype(np.int32)
    lab[:6, :6] = 5             # interior: inside shard (0,0)
    lab[2:4, 2:4] = -1          # masked hole
    return img, lab, 6


def no_spanner_scene(seed=42):
    img = np.random.default_rng(seed).random((H, W, 1)).astype(np.float32)
    lab = np.full((H, W), -1, np.int32)
    lab[1:7, 1:7] = 0
    lab[20:30, 14:22] = 1
    lab[4:12, 30:34] = 2
    return img, lab, 3


def hybrid_scene(seed=42):
    img = np.random.default_rng(seed).random((H, W, 1)).astype(np.float32)
    lab = np.zeros((H, W), np.int32)
    lab[:8, :6] = 1             # interior: inside shard (0,0)
    lab[:, 20:28] = 2           # spans a column seam
    lab[10:22, :] = 3           # spans the row seam
    return img, lab, 4


SCENES = {"seams": seam_scene, "random": random_scene,
          "interior_hole": interior_hole_scene,
          "no_spanners": no_spanner_scene, "hybrid": hybrid_scene}


@pytest.fixture(scope="module")
def mesh():
    return tmesh.make_mesh(8, ["cpu"])


def _sharded(mesh, img, lab):
    return (tmesh.shard_raster(mesh, img)[0],
            tmesh.shard_raster(mesh, lab, fill=-1)[0])


def _jax_shard_hists(img, lab, K, L, band, d=2):
    """Per shard: (visited slots, (mcap, 256, A*256) tables) from JAX's
    _glcm_hist_call in interpret mode, with the job tables of
    glcm_sharded.build_shard_jobs and the halo'd windows of its program."""
    import jax.numpy as jnp
    from obia_tpu.ops import glcm as jg
    from obia_tpu.ops import glcm_pallas as gp
    from obia_tpu.parallel import glcm_sharded as jgs
    from obia_tpu.parallel.sharded import make_mesh, shard_raster

    jmesh = make_mesh(8)
    n_multi, multi, mins = jgs._glcm_prepass_factory(jmesh, K)(
        shard_raster(jmesh, lab, fill=-1)[0])
    multi = np.asarray(multi).astype(bool)
    mcap = max(64, -(-int(n_multi) // 64) * 64)
    mrank = np.where(multi, np.cumsum(multi) - 1, mcap).astype(np.int32)
    bboxes = jgs._bboxes_from_mins(np.asarray(mins), K)
    h, w = H // 2, W // 4
    _, _, hmeta, hrc, hslot, hmask, _ = jgs.build_shard_jobs(
        bboxes, multi, mrank, 2, 4, h, w, mcap)
    # the padding jobs are no-ops: keep the longest real job list
    jmax = int(((hmeta % 2) > 0).sum(1).max())
    qm = np.asarray(jg._bbox_minmax(jnp.asarray(img), jnp.asarray(lab), K,
                                    (band,)))[:K]
    mn = jnp.asarray(qm[:, 4])
    inv = jg.quant_inv(jnp.asarray(-qm[:, 5] - qm[:, 4]), L)
    lab_p = np.pad(lab, d, constant_values=-1)
    band_p = np.pad(img[..., band], d)
    Hp, Wp = gp.padded_shape(h, w)
    out = {}
    for s in range(8):
        i, j = divmod(s, 4)
        win = np.s_[i * h + d:i * h + h + 2 * d, j * w:j * w + w + 2 * d]
        lab_pad = np.full((Hp, Wp), -1, np.int32)
        band_pad = np.zeros((Hp, Wp), np.float32)
        dst = np.s_[0:h + d, gp.CHALO - d:gp.CHALO + w + d]
        lab_pad[dst] = lab_p[win]
        band_pad[dst] = band_p[win]
        meta_s = jnp.asarray(hmeta[s, :jmax])
        mnj, invj = gp.job_min_inv(meta_s, mn, inv, K)
        hout = gp._glcm_hist_call(
            meta_s, jnp.asarray(hrc[s, :jmax]), jnp.asarray(hslot[s, :jmax]),
            mnj, invj, jnp.asarray(lab_pad), jnp.asarray(band_pad),
            num_jobs=jmax, n_slots=mcap, n_angles=len(OFFSETS),
            offsets=OFFSETS, valid_hw=(h, w), levels=L, interpret=True)
        out[(i, j)] = (np.flatnonzero(hmask[s]), np.asarray(hout))
    return mrank, out


def _port_shard_inputs(mesh, img, lab, K, L, band, d=2):
    """Per shard, what sharded_glcm_sums hands glcm_hist: the halo'd
    blocks, the spanners present, their boxes in halo coordinates."""
    timg, tlab = _sharded(mesh, img, lab)
    mins, multi, present = tgs.glcm_prepass(mesh, timg, tlab, K, (band,))
    mn = mins[:, 4].contiguous()
    inv = tg.quant_inv(-mins[:, 5] - mn, L).contiguous()
    shards = tgs.shard_inputs(mesh, timg, tlab, tg._bboxes_from_mins(mins),
                              multi, present, d)
    out = {key: (v[0], v[1], v[3], v[4]) for key, v in shards.items()}
    # the halo'd blocks are the neighbours' pixels
    lab_h = out[(1, 2)][0]
    np.testing.assert_array_equal(
        lab_h.cpu().numpy(), np.pad(lab, d, constant_values=-1)[
            16:16 + 16 + 2 * d, 24:24 + 12 + 2 * d])
    return mn.to(lab_h.device), inv.to(lab_h.device), out


@pytest.mark.parametrize("scene,levels", [("seams", 16), ("seams", 256),
                                          ("hybrid", 32)])
def test_hist_twin_matches_jax_interpret(mesh, scene, levels):
    img, lab, K = SCENES[scene]()
    band = img.shape[2] - 1
    mrank, want = _jax_shard_hists(img, lab, K, levels, band)
    mn, inv, shards = _port_shard_inputs(mesh, img, lab, K, levels, band)
    spanners, n_compared = set(), 0
    for key, (lab_h, img_h, objs, boxes) in shards.items():
        got = glcm_kernel.glcm_hist(lab_h, img_h, band, objs, boxes, mn, inv,
                                    levels, OFFSETS).numpy()
        visited, hout = want[key]
        slot_of = {int(mrank[k]): m for m, k in enumerate(objs.tolist())}
        # JAX visits every spanner whose box meets the shard; the port
        # those with a pixel on it (the others' tables are empty)
        assert set(slot_of) <= set(visited.tolist()), key
        for slot in visited.tolist():
            for a in range(len(OFFSETS)):
                jt = hout[slot, :levels, a * 256:a * 256 + levels]
                if slot not in slot_of:
                    assert not jt.any(), (key, slot)
                    continue
                np.testing.assert_array_equal(
                    got[slot_of[slot], :, a * levels:(a + 1) * levels], jt,
                    err_msg=f"shard {key} slot {slot} angle {a}")
            n_compared += slot in slot_of
        spanners |= set(slot_of)
    assert len(spanners) >= 2 and n_compared >= 2 * len(spanners)


def test_clip_local_matches_jax():
    from obia_tpu.parallel.glcm_sharded import _clip_local

    rng = np.random.default_rng(0)
    r = np.sort(rng.integers(0, 32, (40, 2)), axis=1)
    c = np.sort(rng.integers(0, 48, (40, 2)), axis=1)
    boxes = np.stack([r[:, 0], r[:, 1], c[:, 0], c[:, 1]], 1).astype(np.int32)
    boxes[:3] = [1, 0, 1, 0]                    # empty objects
    for r0, c0 in ((0, 0), (16, 12), (16, 36), (0, 24)):
        np.testing.assert_array_equal(
            tgs._clip_local(torch.as_tensor(boxes), r0, c0, 16, 12).numpy(),
            _clip_local(boxes, r0, c0, 16, 12))


@pytest.mark.parametrize("scene", ["random", "interior_hole", "no_spanners",
                                   "hybrid"])
def test_sharded_props_match_jax_sharded_pallas(mesh, scene):
    from obia_tpu.parallel.sharded import (make_mesh, shard_raster,
                                           sharded_glcm_props)

    img, lab, K = SCENES[scene]()
    jmesh = make_mesh(8)
    want = sharded_glcm_props(jmesh, shard_raster(jmesh, img)[0],
                              shard_raster(jmesh, lab, fill=-1)[0], K,
                              levels=16, use_pallas=True, interpret=True)
    got = tgs.sharded_glcm_props(mesh, *_sharded(mesh, img, lab), K,
                                 levels=16)
    assert set(got) == set(want)
    for name in want:
        w = np.asarray(want[name])
        assert got[name].shape == w.shape == (K, img.shape[2])
        np.testing.assert_array_equal(np.isnan(got[name]), np.isnan(w))
        if name == "correlation":
            continue  # float32-limited in JAX; held to the oracle below
        np.testing.assert_allclose(got[name], w, rtol=2e-4, atol=2e-5,
                                   err_msg=name)


@pytest.mark.parametrize("scene", ["seams", "hybrid"])
def test_sharded_props_match_float64_oracle(mesh, scene):
    from test_ops_stats import naive_glcm_props

    img, lab, K = SCENES[scene]()
    got = tgs.sharded_glcm_props(mesh, *_sharded(mesh, img, lab), K,
                                 levels=32, bands=(0,))
    want = naive_glcm_props(img[..., 0], lab, K, levels=32)
    for name in tg.GLCM_PROP_NAMES:
        np.testing.assert_allclose(got[name][:, 0], want[name], rtol=1e-5,
                                   atol=1e-7, err_msg=name)


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("levels", [32, 256])
def test_sharded_sums_equal_single_device(mesh, scene, levels):
    img, lab, K = SCENES[scene]()
    per_band = tgs.sharded_glcm_sums(mesh, *_sharded(mesh, img, lab), K,
                                     levels=levels)
    image, labels = torch.as_tensor(img), torch.as_tensor(lab)
    bands = tuple(range(img.shape[2]))
    mins = tg.bbox_minmax(image, labels, K, bands)
    for b, (isums, hsum) in enumerate(per_band):
        mn = mins[:, 4 + 2 * b].contiguous()
        inv = tg.quant_inv(-mins[:, 5 + 2 * b] - mn, levels).contiguous()
        want_i, want_h = glcm_kernel.glcm_sums(
            labels, image, b, tg._bboxes_from_mins(mins), mn, inv, levels,
            OFFSETS)
        assert torch.equal(isums, want_i), (scene, b)
        torch.testing.assert_close(hsum, want_h, rtol=1e-12, atol=0)
    names, packed = tg.segment_glcm_props_packed(image, labels, K,
                                                 levels=levels)
    _, got = tgs.sharded_glcm_props(mesh, *_sharded(mesh, img, lab), K,
                                    levels=levels, packed=True)
    np.testing.assert_allclose(got, packed, rtol=1e-6, atol=1e-7)


def test_sharded_prepass_equals_whole_raster(mesh):
    img, lab, K = seam_scene()
    mins, multi, _ = tgs.glcm_prepass(mesh, *_sharded(mesh, img, lab), K,
                                      (0, 1))
    want = tg.bbox_minmax(torch.as_tensor(img), torch.as_tensor(lab), K,
                          (0, 1))
    assert torch.equal(mins, want)
    assert int(multi.sum()) >= 5


def test_compute_asm_off_skips_the_histogram(mesh):
    img, lab, K = seam_scene()
    before = glcm_kernel.hist_launches
    got = tgs.sharded_glcm_props(mesh, *_sharded(mesh, img, lab), K,
                                 levels=16, compute_asm=False)
    assert np.isnan(got["ASM"]).all() and np.isnan(got["energy"]).all()
    assert np.isfinite(got["contrast"][:5]).all()
    assert glcm_kernel.hist_launches == before


def test_cpu_tensors_take_the_twin_and_count_no_launch(mesh):
    img, lab, K = seam_scene()
    mn, inv, shards = _port_shard_inputs(mesh, img, lab, K, 16, 0)
    args = shards[(0, 0)]
    before = glcm_kernel.hist_launches
    got = glcm_kernel.glcm_hist(args[0], args[1], 0, args[2], args[3], mn,
                                inv, 16, OFFSETS)
    want = glcm_kernel.glcm_hist_reference(args[0], args[1], 0, args[2],
                                           args[3], mn, inv, 16, OFFSETS)
    assert glcm_kernel.hist_launches == before
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert got.shape == (args[2].numel(), 16, 4 * 16)
    assert int(got.sum()) > 0


def test_hist_other_devices_raise_instead_of_falling_back(mesh):
    img, lab, K = seam_scene()
    mn, inv, shards = _port_shard_inputs(mesh, img, lab, K, 16, 0)
    lab_h, img_h, objs, boxes = shards[(0, 0)]
    with pytest.raises(ValueError, match="unsupported device"):
        glcm_kernel.glcm_hist(lab_h.to("meta"), img_h, 0, objs, boxes, mn,
                              inv, 16, OFFSETS)


def test_hist_counts_every_pair_of_a_whole_raster():
    """Whole-raster boxes: each object's table holds exactly the n pairs
    of the sums at every angle, and its sum (C + C^T)^2 the sums' value."""
    img, lab, K = seam_scene()
    image, labels = torch.as_tensor(img), torch.as_tensor(lab)
    mins = tg.bbox_minmax(image, labels, K, (1,))
    boxes = tg._bboxes_from_mins(mins)
    mn = mins[:, 4].contiguous()
    inv = tg.quant_inv(-mins[:, 5] - mn, 64).contiguous()
    objs = torch.arange(K, dtype=torch.int32)
    tables = glcm_kernel.glcm_hist(labels, image, 1, objs, boxes, mn, inv,
                                   64, OFFSETS)
    isums, _ = glcm_kernel.glcm_sums(labels, image, 1, boxes, mn, inv, 64,
                                     OFFSETS)
    per_angle = tables.view(K, 64, len(OFFSETS), 64).sum(dim=(1, 3))
    assert torch.equal(per_angle.T.long(), isums[:, :, 0])
    assert torch.equal(tgs.symmetric_sumsq(tables, len(OFFSETS), 64),
                       isums[:, :, 6])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [16, 256])
def test_cuda_hist_matches_twin(cuda_device, levels):
    img, lab, K = seam_scene()
    cmesh = tmesh.make_mesh(8, [cuda_device])
    for band in range(img.shape[2]):
        mn, inv, shards = _port_shard_inputs(cmesh, img, lab, K, levels, band)
        for key, (lab_h, img_h, objs, boxes) in shards.items():
            if objs.numel() == 0:
                continue
            before = glcm_kernel.hist_launches
            got = glcm_kernel.glcm_hist(lab_h, img_h, band, objs, boxes, mn,
                                        inv, levels, OFFSETS)
            torch.cuda.synchronize()
            assert glcm_kernel.hist_launches == before + 1
            want = glcm_kernel.glcm_hist_reference(
                lab_h, img_h, band, objs, boxes, mn, inv, levels, OFFSETS)
            assert torch.equal(got, want), (key, band)


@pytest.mark.cuda
def test_cuda_hist_leaves_unknown_ids_empty(cuda_device):
    img, lab, K = seam_scene()
    cmesh = tmesh.make_mesh(8, [cuda_device])
    mn, inv, shards = _port_shard_inputs(cmesh, img, lab, K, 16, 0)
    lab_h, img_h, objs, boxes = shards[(1, 1)]
    bad = objs.clone()
    bad[0] = K                      # no such object
    got = glcm_kernel.glcm_hist(lab_h, img_h, 0, bad, boxes, mn, inv, 16,
                                OFFSETS)
    want = glcm_kernel.glcm_hist(lab_h, img_h, 0, objs, boxes, mn, inv, 16,
                                 OFFSETS)
    assert int(got[0].abs().sum()) == 0 and int(want[0].sum()) > 0
    assert torch.equal(got[1:], want[1:])


@pytest.mark.cuda
def test_cuda_sharded_sums_equal_single_device(cuda_device):
    img, lab, K = seam_scene()
    cmesh = tmesh.make_mesh(8, [cuda_device])
    per_band = tgs.sharded_glcm_sums(cmesh, *_sharded(cmesh, img, lab), K,
                                     levels=256)
    image = torch.as_tensor(img, device=cuda_device)
    labels = torch.as_tensor(lab, device=cuda_device)
    mins = tg.bbox_minmax(image, labels, K, (0, 1))
    for b, (isums, _) in enumerate(per_band):
        mn = mins[:, 4 + 2 * b].contiguous()
        inv = tg.quant_inv(-mins[:, 5 + 2 * b] - mn, 256).contiguous()
        want, _ = glcm_kernel.glcm_sums(labels, image, b,
                                        tg._bboxes_from_mins(mins), mn, inv,
                                        256, OFFSETS)
        assert torch.equal(isums, want)
