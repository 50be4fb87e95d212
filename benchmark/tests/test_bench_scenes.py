"""The scene generator repeats for a seed and differs across seeds."""
import numpy as np
import pytest
import torch

from benchmark.scenes import make_pool, make_scene, scene_seeds, tile_origins


@pytest.mark.parametrize("bands", [3, 8])
def test_one_seed_repeats(bands):
    a = make_scene(96, bands, 12345, "cpu")
    b = make_scene(96, bands, 12345, "cpu")
    assert a.dtype == torch.uint8 and tuple(a.shape) == (96, 96, bands)
    assert torch.equal(a, b)
    assert int(a.min()) == 0 and int(a[..., :3].max()) == 255


@pytest.mark.parametrize("bands", [3, 8])
def test_seeds_differ(bands):
    a = make_scene(96, bands, 1, "cpu")
    b = make_scene(96, bands, 2, "cpu")
    assert not torch.equal(a, b)


def test_large_seeds():
    s = scene_seeds(2 ** 31 + 17, 4)
    assert s == scene_seeds(2 ** 31 + 17, 4)
    assert s != scene_seeds(2 ** 31 + 18, 4)
    assert all(0 <= v < 2 ** 62 for v in s)
    assert scene_seeds(5, 3, stream=1) != scene_seeds(5, 3)


def test_rolled_bands_follow_the_recipe():
    s = make_scene(64, 8, 9, "cpu")
    for i in range(4):
        want = torch.roll(s[..., i % 4], 17 * (i + 1), dims=i % 2)
        assert torch.equal(s[..., 4 + i], want)


def test_tiles_are_distinct_cells_of_the_mosaic():
    o = tile_origins(3, 32, 1024, 32768)
    assert len(set(o)) == 32
    assert all(r % 1024 == 0 and c % 1024 == 0 and 0 <= r < 32768
               and 0 <= c < 32768 for r, c in o)
    assert o == tile_origins(3, 32, 1024, 32768)
    assert o != tile_origins(4, 32, 1024, 32768)


def test_pool():
    traffic = {"scene": {"side": 64, "pool": 3, "mosaic": 1024}}
    pool = make_pool(traffic, 8, 11, "cpu")
    assert len(pool) == 4
    assert all(p.shape == (64, 64, 8) and p.dtype == np.uint8 for p in pool)
    assert len({p.tobytes() for p in pool}) == 4
    again = make_pool(traffic, 8, 11, "cpu")
    assert all(np.array_equal(a, b) for a, b in zip(pool, again))
