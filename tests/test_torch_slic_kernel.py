"""SLIC's k-means pass kernel (``ops/slic_kernel.slic_pass``,
``csrc/slic.cu``) against its plain twin (``ops/slic.slic_assign_reference``
and ``slic_update_sums64``).

On the CPU: a CPU tensor takes the twin and counts no ``kernel.slic_pass``;
``slic_assign_and_sum`` is the twin's labels and ``slic_update_sums64``'s
sums, at any ``origin``; the k-means loop, which reads each update's sums
from one pass, gives the labels of assign-then-``slic_update_sums64``; the
tile plan's window caps
bound the window of every run of a tile's rows and columns, and the
kernel's constants are the wrapper's.

``cuda`` cases (on the card: ``python -m pytest --noconftest
tests/test_torch_slic_kernel.py -m cuda``), given the same centres: the
kernel's labels bitwise the twin's, on ragged and square shapes, C in
{1, 3, 5, 9, 32}, with a mask, non-finite pixels, ``spacing``, SLICO's
colour scale and a block at a non-zero ``origin``; its sums rounded to
float32 equal to the twin's; ``slic_dense`` labels equal to the CPU's on
every pixel; ``max_num_iter + 1`` launches a ``slic_dense`` call; the
sharded k-means loop (config 5's mosaic) and the fused model's forward on
the card equal to the CPU's labels, one launch a block a pass.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from obia_tpu_torch import telemetry
from obia_tpu_torch.ops import slic as tslic
from obia_tpu_torch.ops import slic_kernel as sk

CSRC = Path(tslic.__file__).resolve().parent.parent / "csrc" / "slic.cu"


def scene(h, w, C, seed=0):
    """A smooth (h, w, C) float32 scene in [0, 100] with a little noise: a
    few regions a grid cell, as SLIC meets them."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    planes = []
    for c in range(C):
        fy, fx = rng.uniform(5, 40, 2)
        planes.append(np.sin(yy / fy + c) + np.cos(xx / fx - c)
                      + ((yy // (9 + c) + xx // (13 + c)) % 3) / 2.0)
    img = np.stack(planes, -1) + rng.normal(0, 0.05, (h, w, C))
    img = 100.0 * (img - img.min()) / (img.max() - img.min())
    return img.astype(np.float32)


def launches():
    return telemetry.counters().get("kernel.slic_pass", 0)


def twin_loop(img, valid, gh, gw, compactness, n_iter, step, half,
              spacing=None):
    """The k-means loop written out: the twin's assignment, then
    ``slic_update_sums64`` and ``update_centers`` on its labels."""
    K = gh * gw
    C = img.shape[2]
    ratio = (compactness / step) ** 2
    centers = tslic.initial_centers(img, gh, gw, step, half)
    for _ in range(n_iter):
        lab = tslic.slic_assign_reference(img, valid, centers, gh, gw, ratio,
                                          step=float(step), spacing=spacing)
        out = tslic.slic_update_sums64(img, lab, K).float()
        centers = tslic.update_centers(out[:, :C + 2], out[:, C + 2],
                                       centers)
    return tslic.slic_assign_reference(img, valid, centers, gh, gw, ratio,
                                       step=float(step), spacing=spacing)


# -- on the CPU -------------------------------------------------------------

@pytest.mark.parametrize("slic_zero", [False, True])
def test_cpu_tensor_takes_the_twin_and_counts_no_launch(slic_zero):
    img = torch.as_tensor(scene(40, 56, 3))
    before = launches()
    lab, k = tslic.slic_dense(img, n_segments=20, compactness=10,
                              convert2lab=False, slic_zero=slic_zero)
    assert k > 0 and lab.shape == (40, 56)
    assert launches() == before
    valid = torch.ones((40, 56), dtype=torch.bool)
    centers = tslic.initial_centers(img, 4, 5)
    got = tslic.slic_assign_block(img, valid, centers, 4, 5, 0.3)
    want = tslic.slic_assign_reference(img, valid, centers, 4, 5, 0.3)
    assert torch.equal(got, want)
    assert launches() == before


@pytest.mark.parametrize("case", ["plain", "mask", "spacing"])
def test_iterate_is_assign_then_sums_on_the_cpu(case):
    h, w, n = 48, 64, 30
    img = torch.as_tensor(scene(h, w, 3, seed=1))
    valid = torch.ones((h, w), dtype=torch.bool)
    if case == "mask":
        valid[:, :20] = False
        valid[30:, 40:] = False
    spacing = (1.0, 2.0) if case == "spacing" else None
    gh, gw = tslic._grid_shape(h, w, n)
    step, half = tslic._grid_step(h, w, n), tslic._grid_half(h, w, n)
    got = tslic._slic_iterate(img, valid, gh, gw, 10.0, 10, grid_step=step,
                              grid_half=half, spacing=spacing)
    want = twin_loop(img, valid, gh, gw, 10.0, 10, step, half, spacing)
    assert torch.equal(got, want)
    assert (got[~valid] == -1).all() and (got[valid] >= 0).all()


@pytest.mark.parametrize("origin", [None, (7, 11)])
def test_assign_and_sum_is_the_twin_on_the_cpu(origin):
    H, W, gh, gw = 48, 64, 5, 6
    x = torch.as_tensor(scene(H, W, 3, seed=2))
    valid = torch.ones((H, W), dtype=torch.bool)
    valid[3:9, 10:30] = False
    centers = tslic.initial_centers(x, gh, gw)
    kw, img, vld = {}, x, valid
    if origin is not None:
        oy, ox = origin
        img, vld = x[oy:oy + 20, ox:ox + 30], valid[oy:oy + 20, ox:ox + 30]
        kw = dict(origin=origin, full_hw=(H, W))
    before = launches()
    lab, sums = tslic.slic_assign_and_sum(img, vld, centers, gh, gw, 0.3,
                                          **kw)
    want = tslic.slic_assign_reference(img, vld, centers, gh, gw, 0.3, **kw)
    assert torch.equal(lab, want)
    assert torch.equal(sums, tslic.slic_update_sums64(
        img, want, gh * gw, kw.get("origin", (0, 0))))
    assert sums.dtype == torch.float64 and launches() == before


def test_slic_pass_refuses_a_cpu_tensor():
    img = torch.zeros((4, 4, 3))
    with pytest.raises(ValueError, match="unsupported device"):
        sk.slic_pass(img, torch.ones((4, 4), dtype=torch.bool),
                     torch.zeros((1, 1, 5)), 1, 1, 1.0)


def _spans(t, n, N):
    """The window of every run of t consecutive coordinates of N over n
    cells, clipped to the image as a tile or a block at the edge is."""
    cells = np.minimum(np.arange(N, dtype=np.int64) * n // N, n - 1)
    first = cells
    last = cells[np.minimum(np.arange(N) + t - 1, N - 1)]
    return (np.minimum(last + 1, n - 1) - np.maximum(first - 1, 0) + 1).max()


@pytest.mark.parametrize("H,W,n_segments,C", [
    (1024, 1024, 3000, 3), (10000, 10000, 3000, 3), (70, 300, 100, 1),
    (70, 300, 100, 5), (40, 50, 2000, 32), (7, 5, 35, 3), (1, 300, 40, 3),
    (513, 97, 900, 9)])
@pytest.mark.parametrize("sums", [False, True])
def test_tile_plan_caps_bound_every_window(H, W, n_segments, C, sums):
    gh, gw = tslic._grid_shape(H, W, n_segments)
    for slico in (False, True):
        th, tw, nr, nc = sk.tile_plan(H, W, gh, gw, C, sums, slico)
        assert (th, tw) in sk.TILES
        if nr == 0:  # the window in global memory: no tile's fits
            assert nc == 0
            th_s, tw_s = sk.TILES[-1]
            assert sk.window_bytes(sk.window_cap(th_s, gh, H)
                                   * sk.window_cap(tw_s, gw, W), C, sums,
                                   slico) > sk.SMEM_BUDGET
            continue
        assert _spans(th, gh, H) <= nr and _spans(tw, gw, W) <= nc
        assert sk.window_bytes(nr * nc, C, sums, slico) <= sk.SMEM_BUDGET


def test_tile_plan_shrinks_the_tile_then_leaves_shared_memory():
    # the cells of the two benchmark cells: the tallest tile
    assert sk.tile_plan(10000, 10000, 55, 55, 3, True, False)[:2] == (32, 128)
    assert sk.tile_plan(1024, 1024, 54, 54, 3, True, False)[:2] == (32, 128)
    # one-pixel cells: a shorter tile, then the global window
    th, tw, nr, nc = sk.tile_plan(64, 64, 64, 64, 8, True, False)
    assert th < 32 and nr > 0
    assert sk.tile_plan(40, 50, 40, 50, 32, True, False)[2:] == (0, 0)


def test_kernel_constants_are_the_wrappers():
    src = CSRC.read_text()

    def define(name):
        return int(re.search(rf"#define {name} (\d+)", src).group(1))
    assert define("SLIC_WARPS") == sk.WARPS
    assert define("SLIC_SMEM_LIMIT") == sk.SMEM_BUDGET
    assert define("SLIC_MAX_TH") == max(t[0] for t in sk.TILES)
    assert define("SLIC_MAX_TW") == max(t[1] for t in sk.TILES)
    assert all(tw % 32 == 0 for _, tw in sk.TILES)


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _centres(img, valid, gh, gw, ratio, step, half):
    """Centres two twin updates from the seeds: where pixels really sit."""
    K = gh * gw
    C = img.shape[2]
    centers = tslic.initial_centers(img, gh, gw, step, half)
    for _ in range(2):
        lab = tslic.slic_assign_reference(img, valid, centers, gh, gw, ratio)
        out = tslic.slic_update_sums64(img, lab, K).float()
        centers = tslic.update_centers(out[:, :C + 2], out[:, C + 2],
                                       centers)
    return centers


PASS_CASES = [(shape, C, variant)
              for shape in ((70, 300), (1024, 1024))
              for C in (1, 3, 5)
              for variant in ("plain", "mask", "nonfinite", "spacing",
                              "slico", "origin")]
PASS_CASES += [((96, 130), 9, "plain"), ((40, 50), 32, "fine_grid")]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,C,variant", PASS_CASES)
def test_cuda_pass_matches_the_twin(cuda_device, shape, C, variant):
    H, W = shape
    n = 2000 if variant == "fine_grid" else max(20, H * W // 350)
    x = torch.as_tensor(scene(H, W, C, seed=C), device=cuda_device)
    valid = torch.ones((H, W), dtype=torch.bool, device=cuda_device)
    if variant in ("mask", "nonfinite"):
        valid[:, : W // 5] = False
        valid[H // 2:, W // 2: W // 2 + 7] = False
    gh, gw = tslic._grid_shape(H, W, n)
    step, half = tslic._grid_step(H, W, n), tslic._grid_half(H, W, n)
    ratio = (10.0 / step) ** 2
    centers = _centres(x, valid, gh, gw, ratio, step, half)
    if variant == "nonfinite":  # after the centres: a NaN centre is legal too
        x[0, 0, 0] = float("nan")              # masked out
        x[H - 1, W - 1, C - 1] = float("inf")  # valid
        x[H // 2, W // 2, 0] = float("-inf")   # masked out
    kw = {}
    if variant == "spacing":
        kw["spacing"] = (1.0, 2.5)
    if variant == "slico":
        kw["inv_max_dc"] = torch.as_tensor(np.random.default_rng(3).uniform(
            1e-3, 1e-1, (gh, gw)).astype(np.float32), device=cuda_device)
        kw["step"] = float(step)
    img, vld = x, valid
    if variant == "origin":  # a block of the image, placed by origin
        oy, ox = H // 3, W // 4
        img = x[oy:, ox: ox + W // 2].contiguous()
        vld = valid[oy:, ox: ox + W // 2].contiguous()
        kw.update(origin=(oy, ox), full_hw=(H, W))
    K = gh * gw
    want = tslic.slic_assign_reference(img, vld, centers, gh, gw, ratio,
                                       **kw)
    want_sums = tslic.slic_update_sums64(img, want, K, kw.get("origin",
                                                              (0, 0)))
    before = launches()
    got = tslic.slic_assign_block(img, vld, centers, gh, gw, ratio, **kw)
    both_lab, both_sums = sk.slic_pass(img, vld, centers, gh, gw, ratio,
                                       labels=True, sums=True, **kw)
    none, sums = tslic.slic_assign_and_sum(img, vld, centers, gh, gw, ratio,
                                           **kw)
    torch.cuda.synchronize()
    assert launches() - before == 3
    assert torch.equal(got, want) and torch.equal(both_lab, want)
    assert none is None  # the card writes no labels it was not asked for
    if variant != "fine_grid":
        assert (want >= 0).any()
    for s in (both_sums, sums):
        np.testing.assert_array_equal(s.float().cpu().numpy(),
                                      want_sums.float().cpu().numpy())


def _dense_scene(size, device):
    return torch.as_tensor(scene(size, size, 3, seed=size), device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("size", [512, 2048])
def test_cuda_slic_dense_equals_the_cpu(cuda_device, size):
    img = _dense_scene(size, cuda_device)
    kw = dict(n_segments=3000, compactness=10, convert2lab=False)
    got, k = tslic.slic_dense(img, **kw)
    want, k_cpu = tslic.slic_dense(img.cpu(), **kw)
    assert k == k_cpu
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("n_iter,slic_zero", [(10, False), (10, True),
                                              (3, False)])
def test_cuda_launches_per_slic_dense(cuda_device, n_iter, slic_zero):
    img = _dense_scene(512, cuda_device)
    before = launches()
    tslic.slic_dense(img, n_segments=3000, compactness=10, convert2lab=False,
                     max_num_iter=n_iter, slic_zero=slic_zero)
    assert launches() - before == n_iter + 1


@pytest.mark.cuda
def test_cuda_kernel_raises_on_a_wrong_input(cuda_device):
    img = torch.zeros((8, 8, 3), device=cuda_device)
    valid = torch.ones((8, 8), dtype=torch.bool, device=cuda_device)
    centers = torch.zeros((2, 2, 5), device=cuda_device)
    with pytest.raises(ValueError, match="shape"):
        sk.slic_pass(img, valid, centers[:, :, :4].contiguous(), 2, 2, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        sk.slic_pass(img.transpose(0, 1), valid, centers, 2, 2, 1.0)
    with pytest.raises(TypeError, match="dtype"):
        sk.slic_pass(img.double(), valid, centers, 2, 2, 1.0)


@pytest.mark.cuda
def test_cuda_sharded_slic_assign_equals_the_cpu(cuda_device):
    from obia_tpu_torch.parallel import mesh as tmesh
    from obia_tpu_torch.parallel import sharded as tsh
    H, W, n, n_iter = 256, 512, 300, 5
    img = scene(H, W, 3, seed=11)
    got = {}
    for dev in ("cpu", "cuda"):
        mesh = tmesh.make_mesh(8, [dev])
        sh, _ = tmesh.shard_raster(mesh, img)
        before = launches()
        lab, centers = tsh.sharded_slic_assign(mesh, sh, n, 10.0, n_iter)
        got[dev] = (lab.gather().cpu().numpy(), centers.cpu().numpy())
        if dev == "cuda":  # one pass a block: n_iter sums, then labels
            torch.cuda.synchronize()
            assert launches() - before == 8 * (n_iter + 1)
    np.testing.assert_array_equal(got["cuda"][0], got["cpu"][0])
    np.testing.assert_array_equal(got["cuda"][1], got["cpu"][1])


@pytest.mark.cuda
def test_cuda_obia_forward_equals_the_cpu(cuda_device):
    from obia_tpu_torch.models import pipeline as tp
    fn, (image, model) = tp.make_flagship(256, 256, 4, 128, device="cpu")
    _, want = fn(image, model)
    fn, (image, model) = tp.make_flagship(256, 256, 4, 128,
                                          device=cuda_device)
    before = launches()
    _, got = fn(image, model)
    torch.cuda.synchronize()
    assert launches() - before == 5 + 1  # obia_forward's n_iter, then labels
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
