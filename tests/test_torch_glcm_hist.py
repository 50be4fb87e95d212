"""The seam-spanner histogram (ops/glcm_kernel.glcm_spanner_hist, its twin,
and the one-shard twin glcm_hist_reference) and the sharded GLCM
(parallel/glcm_sharded.py) against the JAX package on the 8-device CPU mesh
of tests/conftest.py.

Bars: the one-shard twin's directed tables equal, integer for integer, to
JAX's ``_glcm_hist_call`` run in interpret mode on the same halo'd shard
windows (every slot it visits); the all-shards twin's tables and int64 sum
(C + C^T)^2 equal to JAX's tables summed over the shards (each masked by the
shard's visit set), squared in numpy int64; the CSR piece list equal to what
``shard_inputs`` hands each shard; the sharded props equal to JAX's sharded
Pallas route (interpret mode) at rtol 2e-4 / atol 2e-5, as
tests/test_parallel.py holds that route, and the correlation to a float64
oracle at rtol 1e-5 (JAX forms it from float32 moment differences); the
sharded integer sums, spanners' sum (C + C^T)^2 included, bitwise equal to
the port's single-device sums of the same labels. The CUDA kernel is held
against the twin in the tests marked ``cuda``, which run only on a card
(they import no jax: ``pytest --noconftest -m cuda``).
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


def dense_scene(seed=3):
    """A 128 x 192 raster of random levels, one object over nearly all of it
    (every shard) and two small spanners: at an angle the big one's table
    has more nonzero cells than a block of the kernel lists (SPAN_CELLS in
    csrc/glcm.cu) at L = 100 (one block) and in each half at L = 180, 255
    and 256 (two blocks)."""
    rng = np.random.default_rng(seed)
    lab = np.zeros((128, 192), np.int32)
    lab[:8, :8] = 1             # inside shard (0, 0)
    lab[60:70, 40:50] = 2       # across the row seam at 64
    lab[100:110, 140:190] = 3   # across the column seam at 144
    img = rng.integers(0, 256, (128, 192, 2)).astype(np.float32)
    return img, lab, 4


SCENES = {"seams": seam_scene, "random": random_scene,
          "interior_hole": interior_hole_scene,
          "no_spanners": no_spanner_scene, "hybrid": hybrid_scene}


@pytest.fixture(scope="module")
def mesh():
    return tmesh.make_mesh(8, ["cpu"])


@pytest.fixture(scope="module")
def jax_hists():
    """(scene, levels) -> what :func:`_jax_shard_hists` gives for the
    scene's last band, each interpret run made once a module."""
    cache = {}

    def get(scene, levels):
        if (scene, levels) not in cache:
            img, lab, K = SCENES[scene]()
            cache[scene, levels] = _jax_shard_hists(img, lab, K, levels,
                                                    img.shape[2] - 1)
        return cache[scene, levels]

    return get


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
    """Per shard, what sharded_glcm_sums hands the histogram: the halo'd
    blocks, the spanners present, their boxes in halo coordinates; and the
    spanners' CSR piece list over all shards (one device)."""
    timg, tlab = _sharded(mesh, img, lab)
    mins, multi, present = tgs.glcm_prepass(mesh, timg, tlab, K, (band,))
    mn = mins[:, 4].contiguous()
    inv = tg.quant_inv(-mins[:, 5] - mn, L).contiguous()
    shards = tgs.shard_inputs(mesh, timg, tlab, tg._bboxes_from_mins(mins),
                              multi, present, d)
    out = {key: (v[0], v[1], v[3], v[4]) for key, v in shards.items()}
    # the halo'd blocks are the neighbours' pixels
    lab_h = out[(1, 2)][0]
    h, w = lab.shape[0] // 2, lab.shape[1] // 4
    np.testing.assert_array_equal(
        lab_h.cpu().numpy(), np.pad(lab, d, constant_values=-1)[
            h:h + h + 2 * d, 2 * w:2 * w + w + 2 * d])
    spanners = torch.nonzero(multi).reshape(-1)
    (group,) = tgs.spanner_groups(mesh, shards, spanners)
    return mn.to(lab_h.device), inv.to(lab_h.device), out, group


@pytest.mark.parametrize("scene,levels", [("seams", 16), ("seams", 256),
                                          ("hybrid", 32)])
def test_hist_twin_matches_jax_interpret(mesh, jax_hists, scene, levels):
    img, lab, K = SCENES[scene]()
    band = img.shape[2] - 1
    mrank, want = jax_hists(scene, levels)
    mn, inv, shards, _ = _port_shard_inputs(mesh, img, lab, K, levels, band)
    spanners, n_compared = set(), 0
    for key, (lab_h, img_h, objs, boxes) in shards.items():
        got = glcm_kernel.glcm_hist_reference(lab_h, img_h, band, objs,
                                              boxes, mn, inv, levels,
                                              OFFSETS).numpy()
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


# the interpret runs of test_hist_twin_matches_jax_interpret, reused
@pytest.mark.parametrize("scene,levels", [("seams", 16), ("seams", 256),
                                          ("hybrid", 32)])
def test_spanner_twin_matches_jax_summed_over_shards(mesh, jax_hists, scene,
                                                     levels):
    img, lab, K = SCENES[scene]()
    band = img.shape[2] - 1
    A = len(OFFSETS)
    mrank, want = jax_hists(scene, levels)
    mn, inv, shards, (labs, imgs, work) = _port_shard_inputs(
        mesh, img, lab, K, levels, band)
    # JAX: each shard's visited slots, summed over the shards
    total = {}
    for visited, hout in want.values():
        for slot in visited.tolist():
            t = np.concatenate([hout[slot, :levels, a * 256:a * 256 + levels]
                                for a in range(A)], axis=1).astype(np.int64)
            total[slot] = total.get(slot, 0) + t
    tables, sumsq = glcm_kernel.glcm_spanner_hist(labs, imgs, band, work, mn,
                                                  inv, levels, OFFSETS)
    ids = work.ids.tolist()
    assert len(ids) >= 2 and tables.shape == (len(ids), levels, A * levels)
    assert sumsq.dtype == torch.int64 and sumsq.shape == (A, len(ids))
    # every slot JAX counted a pair into is a spanner of the port's
    assert {s for s, t in total.items() if t.any()} <= {int(mrank[k])
                                                       for k in ids}
    for m, k in enumerate(ids):
        want_t = total[int(mrank[k])]
        np.testing.assert_array_equal(tables[m].numpy(), want_t,
                                      err_msg=f"spanner {k}")
        for a in range(A):
            C = want_t[:, a * levels:(a + 1) * levels]
            assert sumsq[a, m].item() == int(((C + C.T) ** 2).sum()), (k, a)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_spanner_pieces_match_shard_inputs(mesh, scene):
    img, lab, K = SCENES[scene]()
    timg, tlab = _sharded(mesh, img, lab)
    mins, multi, present = tgs.glcm_prepass(mesh, timg, tlab, K, (0,))
    shards = tgs.shard_inputs(mesh, timg, tlab, tg._bboxes_from_mins(mins),
                              multi, present, 2)
    spanners = torch.nonzero(multi).reshape(-1)
    (labs, imgs, work), = tgs.spanner_groups(mesh, shards, spanners)
    assert torch.equal(work.ids, spanners.to(torch.int32))
    ptr = work.ptr.long()
    assert ptr[0] == 0 and ptr[-1] == work.pieces.shape[0]
    assert bool((ptr[1:] >= ptr[:-1]).all())
    spanner = torch.repeat_interleave(torch.arange(len(spanners)),
                                      ptr[1:] - ptr[:-1])
    key = spanner * len(shards) + work.pieces[:, 0].long()
    assert bool((key[1:] > key[:-1]).all())     # by (spanner, shard)
    for s, (lab_h, img_h, _, objs, obox) in enumerate(shards.values()):
        assert labs[s] is lab_h and imgs[s] is img_h
        on = work.pieces[:, 0] == s
        assert torch.equal(work.ids[spanner[on]], objs)
        assert torch.equal(work.pieces[on, 1:], obox)
    # every spanner lies on at least two shards
    assert bool((ptr[1:] - ptr[:-1] >= 2).all())


@pytest.mark.parametrize("scene", ["seams", "hybrid"])
def test_shards_on_two_devices_sum_their_tables(scene):
    """Shards placed on two devices ("cpu" and "cpu:0" name two): a launch
    on each, the tables summed and squared on the home device, give the
    one-device sums."""
    img, lab, K = SCENES[scene]()
    one = tmesh.make_mesh(8, ["cpu"])
    two = tmesh.make_mesh(8, ["cpu", "cpu:0"])
    timg, tlab = _sharded(two, img, lab)
    mins, multi, present = tgs.glcm_prepass(two, timg, tlab, K, (0,))
    shards = tgs.shard_inputs(two, timg, tlab, tg._bboxes_from_mins(mins),
                              multi, present, 2)
    groups = tgs.spanner_groups(two, shards,
                                torch.nonzero(multi).reshape(-1))
    assert len(groups) == 2
    want = tgs.sharded_glcm_sums(one, *_sharded(one, img, lab), K, levels=64)
    got = tgs.sharded_glcm_sums(two, timg, tlab, K, levels=64)
    for (gi, gh), (wi, wh) in zip(got, want):
        assert torch.equal(gi, wi)
        assert torch.equal(gh, wh)


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
    mn, inv, _, (labs, imgs, work) = _port_shard_inputs(mesh, img, lab, K,
                                                        16, 0)
    M, A = work.ids.numel(), len(OFFSETS)
    before = glcm_kernel.hist_launches
    got, got_sq = glcm_kernel.glcm_spanner_hist(labs, imgs, 0, work, mn, inv,
                                                16, OFFSETS)
    none, sums_only = glcm_kernel.glcm_spanner_hist(
        labs, imgs, 0, work, mn, inv, 16, OFFSETS, tables=False)
    want, want_sq = glcm_kernel.glcm_spanner_hist_reference(
        labs, imgs, 0, work, mn, inv, 16, OFFSETS)
    assert glcm_kernel.hist_launches == before
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert got_sq.dtype == torch.int64 and torch.equal(got_sq, want_sq)
    assert got.shape == (M, 16, A * 16) and got_sq.shape == (A, M)
    assert int(got.sum()) > 0
    assert none is None and torch.equal(sums_only, want_sq)


def test_hist_other_devices_raise_instead_of_falling_back(mesh):
    img, lab, K = seam_scene()
    mn, inv, _, (labs, imgs, work) = _port_shard_inputs(mesh, img, lab, K,
                                                        16, 0)
    with pytest.raises(ValueError, match="unsupported device"):
        glcm_kernel.glcm_spanner_hist([t.to("meta") for t in labs], imgs, 0,
                                      work, mn, inv, 16, OFFSETS)


def test_hist_counts_every_pair_of_a_whole_raster():
    """One shard, the whole raster, every object a spanner with its own box:
    each object's table holds exactly the n pairs of the sums at every
    angle, and its sum (C + C^T)^2 the sums' value."""
    img, lab, K = seam_scene()
    image, labels = torch.as_tensor(img), torch.as_tensor(lab)
    mins = tg.bbox_minmax(image, labels, K, (1,))
    boxes = tg._bboxes_from_mins(mins)
    mn = mins[:, 4].contiguous()
    inv = tg.quant_inv(-mins[:, 5] - mn, 64).contiguous()
    work = glcm_kernel.spanner_pieces(torch.arange(K, dtype=torch.int32),
                                      [torch.arange(K, dtype=torch.int32)],
                                      [boxes])
    tables, sumsq = glcm_kernel.glcm_spanner_hist([labels], [image], 1, work,
                                                  mn, inv, 64, OFFSETS)
    isums, _ = glcm_kernel.glcm_sums(labels, image, 1, boxes, mn, inv, 64,
                                     OFFSETS)
    per_angle = tables.view(K, 64, len(OFFSETS), 64).sum(dim=(1, 3))
    assert torch.equal(per_angle.T.long(), isums[:, :, 0])
    assert torch.equal(sumsq, isums[:, :, 6])
    assert torch.equal(glcm_kernel.symmetric_sumsq(tables, len(OFFSETS), 64),
                       isums[:, :, 6])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [1, 2, 16, 180, 255, 256])
def test_cuda_hist_matches_twin(cuda_device, levels):
    img, lab, K = seam_scene()
    cmesh = tmesh.make_mesh(8, [cuda_device])
    A = len(OFFSETS)
    for band in range(img.shape[2]):
        mn, inv, _, (labs, imgs, work) = _port_shard_inputs(
            cmesh, img, lab, K, levels, band)
        n_pieces = (work.ptr[1:] - work.ptr[:-1]).cpu()
        box = work.pieces[:, 1:].cpu()
        assert int(n_pieces.max()) == 4            # the corner spanner
        assert bool(((box[:, 0] == box[:, 1])       # a 1-pixel piece
                     & (box[:, 2] == box[:, 3])).any())
        before = glcm_kernel.hist_launches
        got, got_sq = glcm_kernel.glcm_spanner_hist(
            labs, imgs, band, work, mn, inv, levels, OFFSETS)
        again, again_sq = glcm_kernel.glcm_spanner_hist(
            labs, imgs, band, work, mn, inv, levels, OFFSETS)
        none, sums_only = glcm_kernel.glcm_spanner_hist(
            labs, imgs, band, work, mn, inv, levels, OFFSETS, tables=False)
        torch.cuda.synchronize()
        assert glcm_kernel.hist_launches == before + 3
        want, want_sq = glcm_kernel.glcm_spanner_hist_reference(
            labs, imgs, band, work, mn, inv, levels, OFFSETS)
        assert torch.equal(got, want), (levels, band)
        assert torch.equal(got_sq, want_sq), (levels, band)
        assert torch.equal(got, again) and torch.equal(got_sq, again_sq)
        assert none is None and torch.equal(sums_only, want_sq)


def span_define(name):
    """A #define of the spanner kernel in csrc/glcm.cu: SPAN_CELLS, the
    nonzero cells a block lists, or SPAN_TABLE_BYTES, the most table rows
    a block holds."""
    import re
    from pathlib import Path

    src = Path(glcm_kernel.__file__).parents[1] / "csrc" / "glcm.cu"
    return int(re.search(rf"#define {name} (\d+)", src.read_text())[1])


def span_rows(levels):
    """The rows of the table a block holds, as the kernel's launcher splits
    it: all of them where the table fits SPAN_TABLE_BYTES, else half."""
    whole = levels * (levels | 1) * 4 <= span_define("SPAN_TABLE_BYTES")
    return levels if whole else (levels + 1) // 2


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [100, 180, 255, 256])
def test_cuda_hist_overflowing_the_cell_list(cuda_device, levels):
    """Tables with more nonzero cells than a block lists take the whole-row
    scan: the sums, with and without the tables, equal the twin's."""
    img, lab, K = dense_scene()
    cmesh = tmesh.make_mesh(8, [cuda_device])
    mn, inv, _, (labs, imgs, work) = _port_shard_inputs(cmesh, img, lab, K,
                                                        levels, 0)
    A, M = len(OFFSETS), work.ids.numel()
    want, want_sq = glcm_kernel.glcm_spanner_hist_reference(
        labs, imgs, 0, work, mn, inv, levels, OFFSETS)
    rows = span_rows(levels)
    cells = (want.view(M, levels, A, levels) > 0).cpu()
    most = max(int(cells[:, r:r + rows].sum(dim=(1, 3)).max())
               for r in range(0, levels, rows))
    assert most > span_define("SPAN_CELLS")
    got, got_sq = glcm_kernel.glcm_spanner_hist(labs, imgs, 0, work, mn, inv,
                                                levels, OFFSETS)
    _, sums_only = glcm_kernel.glcm_spanner_hist(
        labs, imgs, 0, work, mn, inv, levels, OFFSETS, tables=False)
    assert torch.equal(got, want) and torch.equal(got_sq, want_sq)
    assert torch.equal(sums_only, want_sq)


@pytest.mark.cuda
def test_cuda_hist_leaves_unknown_ids_empty(cuda_device):
    img, lab, K = seam_scene()
    cmesh = tmesh.make_mesh(8, [cuda_device])
    mn, inv, _, (labs, imgs, work) = _port_shard_inputs(cmesh, img, lab, K,
                                                        16, 0)
    ids = work.ids.clone()
    ids[0] = K                      # no such object
    bad = glcm_kernel.SpannerPieces(ids, work.ptr, work.pieces)
    got, got_sq = glcm_kernel.glcm_spanner_hist(labs, imgs, 0, bad, mn, inv,
                                                16, OFFSETS)
    _, sums_only = glcm_kernel.glcm_spanner_hist(labs, imgs, 0, bad, mn, inv,
                                                 16, OFFSETS, tables=False)
    want, want_sq = glcm_kernel.glcm_spanner_hist(labs, imgs, 0, work, mn,
                                                  inv, 16, OFFSETS)
    assert int(got[0].abs().sum()) == 0 and int(want[0].sum()) > 0
    assert int(got_sq[:, 0].abs().sum()) == 0
    assert torch.equal(got[1:], want[1:])
    assert torch.equal(got_sq[:, 1:], want_sq[:, 1:])
    assert torch.equal(sums_only, got_sq)


@pytest.mark.cuda
def test_cuda_sharded_sums_equal_single_device(cuda_device):
    img, lab, K = seam_scene()
    cmesh = tmesh.make_mesh(8, [cuda_device])
    before = glcm_kernel.hist_launches
    per_band = tgs.sharded_glcm_sums(cmesh, *_sharded(cmesh, img, lab), K,
                                     levels=256)
    assert glcm_kernel.hist_launches == before + len(per_band) == before + 2
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
