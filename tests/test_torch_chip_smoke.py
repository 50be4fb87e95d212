"""chip_smoke.py carries its own copy of bench.py's synthetic scene, so it
needs nothing of the repo's JAX side on the card's machine: the copy must
give bench.py's arrays."""
import numpy as np
import pytest

import bench
import chip_smoke


@pytest.mark.parametrize("h,w,c,seed", [(16, 16, 3, 0), (33, 20, 4, 0),
                                        (24, 40, 1, 7)])
def test_build_scene_is_bench_scene(h, w, c, seed):
    got = chip_smoke.build_scene(h=h, w=w, c=c, seed=seed)
    want = bench.build_scene(h=h, w=w, c=c, seed=seed)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_config4_scene_is_bench_config4():
    """bench.bench_config4's 8 bands: build_scene's 4, then 4 rolled."""
    size = 48
    scene = chip_smoke.config4_scene(size)
    base = bench.build_scene(h=size, w=size, c=4)
    assert scene.shape == (size, size, 8) and scene.dtype == np.uint8
    assert np.array_equal(scene[..., :4], base)
    for i in range(4):
        want = np.roll(base[..., i % 4].astype(np.float32), 17 * (i + 1),
                       axis=i % 2).astype(np.uint8)
        assert np.array_equal(scene[..., 4 + i], want)


def test_detection_tiles_load_as_a_dataset(tmp_path):
    """Phase 20's crown tiles: uint16 GeoTIFFs whose annotations.json the
    port's TreeDetectionDataset reads, every box inside its tile; and
    check_boxes refuses a box outside the raster."""
    from obia_tpu_torch.detection.dataset import TreeDetectionDataset

    ann = chip_smoke.write_detection_tiles(str(tmp_path), 2, 96, seed=3)
    ds = TreeDetectionDataset(str(tmp_path), ann)
    assert len(ds) == 2
    for i in range(2):
        img, tgt = ds[i]
        assert img.shape == (chip_smoke.DET_BANDS, 96, 96)
        b = tgt["boxes"]
        assert len(b) == 9 and (b >= 0).all() and (b <= 96).all()
        assert (b[:, 2] > b[:, 0]).all() and (b[:, 3] > b[:, 1]).all()
    ok = {"boxes": np.array([[0.0, 1.0, 96.0, 50.0]], np.float32),
          "scores": np.array([0.9], np.float32), "labels": np.array([1])}
    chip_smoke.check_boxes(ok, 96)
    with pytest.raises(AssertionError, match="leaves the raster"):
        chip_smoke.check_boxes(dict(ok, boxes=ok["boxes"] + 1), 96)
