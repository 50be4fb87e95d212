"""obia_tpu_torch/parallel (mesh, halo, sharded SLIC, CCL, merge, moments)
against the JAX package's sharded programs on the 8-device CPU mesh of
tests/conftest.py, and against the port's own single-device path.

Bars: mesh shapes, sharded rasters, halos, SLIC cluster ids, CCL labels
and merge labels bitwise equal (integer computations, or float32 k-means on
the same seeds whose sums round once); spectral moments at rtol 1e-4,
atol 1e-5 (per-shard float32 partial sums in another order).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from obia_tpu.parallel import sharded as jsh
from obia_tpu_torch.ops import connectivity as tconn
from obia_tpu_torch.ops import slic as tslic
from obia_tpu_torch.parallel import halo as thalo
from obia_tpu_torch.parallel import mesh as tmesh
from obia_tpu_torch.parallel import sharded as tsh


@pytest.fixture(scope="module")
def jmesh():
    return jsh.make_mesh(8)


@pytest.fixture(scope="module")
def mesh():
    return tmesh.make_mesh(8, ["cpu"])


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
def test_mesh_shape_matches_jax(n):
    assert (tmesh.make_mesh(n, ["cpu"]).shape
            == jsh.make_mesh(n).devices.shape)


def test_mesh_keeps_shards_on_the_devices_given():
    m = tmesh.make_mesh(8, ["cuda:0"])
    assert m.shape == (2, 4)
    assert {m.device_of(i, j) for i, j in m.shards()} == {
        torch.device("cuda:0")}
    two = tmesh.make_mesh(8, ["cpu", "meta"])
    assert [two.device_of(i, j).type for i, j in two.shards()] == [
        "cpu", "meta"] * 4


@pytest.mark.parametrize("shape,fill", [((32, 48, 2), 0), ((90, 123), -1),
                                        ((17, 9, 3), 0)])
def test_shard_raster_matches_jax(jmesh, mesh, shape, fill):
    arr = np.random.default_rng(0).integers(0, 99, shape).astype(np.int32)
    want, jhw = jsh.shard_raster(jmesh, arr, fill=fill)
    got, hw = tmesh.shard_raster(mesh, arr, fill=fill)
    assert hw == jhw == shape[:2]
    np.testing.assert_array_equal(got.gather().numpy(), np.asarray(want))
    shard_shape = want.addressable_shards[0].data.shape
    assert got.block(1, 3).shape == shard_shape
    assert got.padded_hw == want.shape[:2]


def _jax_halo(jmesh, arr, d, fill):
    @functools.partial(jax.shard_map, mesh=jmesh, in_specs=(P("ty", "tx"),),
                       out_specs=P("ty", "tx"))
    def run(x):
        return jsh._halo2d(x, d, jnp.asarray(fill, x.dtype))
    return np.asarray(run(jnp.asarray(arr)))


@pytest.mark.parametrize("d,fill", [(1, -1), (2, -1), (2, 0), (3, 7)])
def test_halo2d_matches_jax(jmesh, mesh, d, fill):
    arr = np.arange(32 * 48, dtype=np.int32).reshape(32, 48)
    want = _jax_halo(jmesh, arr, d, fill)
    sh, _ = tmesh.shard_raster(mesh, arr)
    got = thalo.halo2d(sh, d, fill)
    hh, ww = 16 + 2 * d, 12 + 2 * d
    for i, j in mesh.shards():
        np.testing.assert_array_equal(
            got.block(i, j).numpy(),
            want[i * hh:(i + 1) * hh, j * ww:(j + 1) * ww], err_msg=(i, j))


def test_halo_block_of_an_image_keeps_its_channels(jmesh, mesh):
    img = np.random.default_rng(1).random((32, 48, 3)).astype(np.float32)
    got = thalo.halo2d(tmesh.shard_raster(mesh, img)[0], 2, 0.0)
    hh, ww = 16 + 4, 12 + 4
    for c in range(3):
        want = _jax_halo(jmesh, img[..., c], 2, 0.0)
        for i, j in mesh.shards():
            np.testing.assert_array_equal(
                got.block(i, j)[..., c].numpy(),
                want[i * hh:(i + 1) * hh, j * ww:(j + 1) * ww])


def _jax_exchange(jmesh, arr, fn, axis):
    @functools.partial(jax.shard_map, mesh=jmesh, in_specs=(P("ty", "tx"),),
                       out_specs=(P("ty", "tx"), P("ty", "tx")))
    def run(x):
        prev, nxt = fn(x, axis)
        return jnp.broadcast_to(prev, x.shape), jnp.broadcast_to(nxt, x.shape)
    return [np.asarray(a) for a in run(jnp.asarray(arr))]


@pytest.mark.parametrize("axis", ["ty", "tx"])
def test_exchange_halo_matches_jax(jmesh, mesh, axis):
    from obia_tpu.parallel.halo import exchange_halo_cols, exchange_halo_rows

    H, W = 16, 16
    arr = np.arange(H * W, dtype=np.int32).reshape(H, W)
    jfn = exchange_halo_rows if axis == "ty" else exchange_halo_cols
    tfn = (thalo.exchange_halo_rows if axis == "ty"
           else thalo.exchange_halo_cols)
    want_prev, want_next = _jax_exchange(jmesh, arr, jfn, axis)
    sh, _ = tmesh.shard_raster(mesh, arr)
    prev, nxt = tfn(sh)
    h, w = sh.block_hw
    for i, j in mesh.shards():
        sl = np.s_[i * h:(i + 1) * h, j * w:(j + 1) * w]
        blk = sh.block(i, j).shape
        np.testing.assert_array_equal(
            prev.block(i, j).expand(blk).numpy(), want_prev[sl])
        np.testing.assert_array_equal(
            nxt.block(i, j).expand(blk).numpy(), want_next[sl])
    # test_halo.py's expectations, and the mesh edges filled on request
    if axis == "ty":
        np.testing.assert_array_equal(prev.block(1, 0)[0].numpy(),
                                      arr[h - 1, :w])
        np.testing.assert_array_equal(nxt.block(0, 0)[0].numpy(), arr[h, :w])
    prev_f, nxt_f = tfn(sh, fill=-1)
    assert (prev_f.block(0, 0) == -1).all()
    assert (nxt_f.block(mesh.ty - 1, mesh.tx - 1) == -1).all()
    np.testing.assert_array_equal(prev_f.block(1, 1).numpy(),
                                  prev.block(1, 1).numpy())


def test_halo_deeper_than_a_block_raises(mesh):
    sh, _ = tmesh.shard_raster(mesh, np.zeros((8, 8), np.int32))
    with pytest.raises(ValueError, match="halo depth"):
        thalo.halo2d(sh, 3, -1)


@pytest.mark.parametrize("seed,n_segments", [(0, 24), (1, 40)])
def test_sharded_slic_assign_matches_jax_and_single_device(jmesh, mesh,
                                                           seed, n_segments):
    from obia_tpu.ops.slic import _grid_shape

    H, W, C = 64, 96, 3
    img = np.random.default_rng(seed).random((H, W, C)).astype(np.float32)
    want, _ = jsh.sharded_slic_assign(jmesh, jnp.asarray(img), n_segments,
                                      compactness=10.0, max_num_iter=5)
    sh, _ = tmesh.shard_raster(mesh, img)
    got, centers = tsh.sharded_slic_assign(mesh, sh, n_segments,
                                           compactness=10.0, max_num_iter=5)
    gh, gw = _grid_shape(H, W, n_segments)
    single = tslic._slic_iterate(torch.as_tensor(img),
                                 torch.ones((H, W), dtype=torch.bool), gh,
                                 gw, 10.0, 5,
                                 grid_step=tslic._grid_step(H, W, n_segments),
                                 grid_half=tslic._grid_half(H, W, n_segments))
    np.testing.assert_array_equal(got.gather().numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.gather().numpy(), single.numpy())
    assert centers.shape == (gh, gw, C + 2)


def _ccl_raster(seed, H=64, W=96):
    lab = np.random.default_rng(seed).integers(0, 6, (H, W)).astype(np.int32)
    lab[10:14, 20:24] = -1
    return lab


@pytest.mark.parametrize("k_max", [4096, 8])
def test_sharded_ccl_merge_matches_jax(jmesh, mesh, k_max):
    H, W = 64, 96
    lab = _ccl_raster(0)
    jlab, _ = jsh.shard_raster(jmesh, lab, fill=-1)
    want, k_want = jsh.sharded_ccl_merge(jmesh, jlab, (H, W), k_max=4096)
    sh, _ = tmesh.shard_raster(mesh, lab, fill=-1)
    got, k = tsh.sharded_ccl_merge(mesh, sh, (H, W), k_max=k_max)
    assert k == k_want
    np.testing.assert_array_equal(got.gather().numpy(), np.asarray(want))
    single, k_single = tconn.ccl_dense_labels(torch.as_tensor(lab))
    assert k_single == k
    np.testing.assert_array_equal(got.gather().numpy()[:H, :W],
                                  single.numpy())


def test_sharded_ccl_merge_crops_pads(jmesh, mesh):
    """A 61 x 90 crop of a 64 x 96 padded raster: pads become -1, and the
    raster-order numbering uses the crop's width."""
    lab = _ccl_raster(1)
    jlab, _ = jsh.shard_raster(jmesh, lab, fill=0)
    want, k_want = jsh.sharded_ccl_merge(jmesh, jlab, (61, 90),
                                         n_segments=30)
    sh, _ = tmesh.shard_raster(mesh, lab, fill=0)
    got, k = tsh.sharded_ccl_merge(mesh, sh, (61, 90), n_segments=30)
    assert k == k_want
    np.testing.assert_array_equal(got.gather().numpy(), np.asarray(want))


@pytest.mark.parametrize("H,W,mn,mx", [(64, 96, 6, 400), (128, 256, 4, 60)])
def test_sharded_merge_small_matches_single_device(mesh, H, W, mn, mx):
    """A 2% masked noise raster, as tests/test_mosaic.py's dust test."""
    rng = np.random.default_rng(3)
    noisy = rng.integers(0, 6, (H, W)).astype(np.int32)
    noisy[rng.random((H, W)) < 0.02] = -1
    lab, k = tconn.ccl_dense_labels(torch.as_tensor(noisy))
    want, k_want = tconn.merge_small_device(lab, k, mn, mx)
    sh, _ = tmesh.shard_raster(mesh, lab, fill=-1)
    got, k_got = tsh.sharded_merge_small(mesh, sh, k, mn, mx)
    assert k_got == k_want
    np.testing.assert_array_equal(got.gather().numpy(), want.numpy())


def test_sharded_merge_small_matches_jax(jmesh, mesh):
    from obia_tpu.ops.connectivity import scan_ccl_dense_labels

    H, W = 64, 96
    raw = np.random.default_rng(42).integers(0, 12, (H, W)).astype(np.int32)
    lab, k, _ = scan_ccl_dense_labels(jnp.asarray(raw))
    k = int(k)
    jlab, _ = jsh.shard_raster(jmesh, np.asarray(lab), fill=-1)
    want, k_want = jsh.sharded_merge_small(jmesh, jlab, k, 20, 600)
    sh, _ = tmesh.shard_raster(mesh, np.asarray(lab), fill=-1)
    got, k_got = tsh.sharded_merge_small(mesh, sh, k, 20, 600)
    assert k_got == k_want
    np.testing.assert_array_equal(got.gather().numpy(), np.asarray(want))


@pytest.mark.parametrize("shape,K", [((32, 48, 2), 10), ((90, 123, 3), 25)])
def test_sharded_moments_match_jax(jmesh, mesh, shape, K):
    rng = np.random.default_rng(7)
    img = rng.random(shape).astype(np.float32)
    lab = rng.integers(-1, K, shape[:2]).astype(np.int32)
    jimg, _ = jsh.shard_raster(jmesh, img)
    jlab, _ = jsh.shard_raster(jmesh, lab, fill=-1)
    want = jsh.sharded_spectral_moments(jmesh, jimg, jlab, K)
    timg, _ = tmesh.shard_raster(mesh, img)
    tlab, _ = tmesh.shard_raster(mesh, lab, fill=-1)
    got = tsh.sharded_spectral_moments(mesh, timg, tlab, K)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    names, packed = tsh.sharded_spectral_moments(mesh, timg, tlab, K,
                                                 packed=True)
    assert packed.shape == (7, K, shape[2])
    for n, arr in zip(names, packed):
        np.testing.assert_array_equal(arr, got[n].numpy())


def test_sharded_moments_match_single_device(mesh):
    from obia_tpu_torch.ops.stats import segment_spectral_moments

    rng = np.random.default_rng(8)
    img = rng.normal(50, 10, (40, 56, 2)).astype(np.float32)
    lab = rng.integers(-1, 12, (40, 56)).astype(np.int32)
    want = segment_spectral_moments(torch.as_tensor(img),
                                    torch.as_tensor(lab), 12)
    got = tsh.sharded_spectral_moments(
        mesh, tmesh.shard_raster(mesh, img)[0],
        tmesh.shard_raster(mesh, lab, fill=-1)[0], 12)
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=1e-4,
                                   atol=1e-5, equal_nan=True, msg=name)


def test_count_shard_spanning_matches_jax(jmesh, mesh):
    lab = np.full((32, 48), -1, np.int32)
    lab[1:7, 1:7] = 0           # shard (0, 0)
    lab[20:30, 14:22] = 1       # shard (1, 1)
    lab[:, 20:28] = 2           # a column seam and the row seam
    lab[10:22, 2:6] = 3         # the row seam
    jlab, _ = jsh.shard_raster(jmesh, lab, fill=-1)
    n_want, want = jsh.count_shard_spanning(jmesh, jlab, 5)
    n, got = tsh.count_shard_spanning(
        mesh, tmesh.shard_raster(mesh, lab, fill=-1)[0], 5)
    assert n == n_want == 2
    np.testing.assert_array_equal(got, want)


def test_reductions_land_on_the_home_device(mesh):
    parts = [torch.full((3,), float(v)) for v in (4, -1, 2)]
    assert tmesh.psum(mesh, parts).tolist() == [5.0] * 3
    assert tmesh.pmin(mesh, parts).tolist() == [-1.0] * 3
    assert tmesh.pmax(mesh, parts).tolist() == [4.0] * 3
    assert parts[0].tolist() == [4.0] * 3   # inputs untouched
