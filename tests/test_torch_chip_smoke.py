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
