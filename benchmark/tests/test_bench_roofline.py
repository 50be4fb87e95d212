"""The rooflines' counts against numbers worked out by hand."""
import numpy as np
import pytest

from benchmark.roofline import (FP32_OPS_PER_MS, HBM_BYTES_PER_MS,
                                SFU_OPS_PER_MS, glcm_sums, quickshift)


def test_glcm_sums_small_shape():
    # 4 x 5 labels and band: 20 * 4 + 20 * 4 = 160; 3 objects: 3 * 24 = 72;
    # 2 angles x 3 objects x (7 * 8 + 8) = 384
    assert glcm_sums.call_bytes(4, 5, 3, 2) == 160 + 72 + 384
    scene = {"H": 4, "W": 5, "K": 3, "angles": 2, "texture_bands": 8}
    assert glcm_sums.bound_ms(scene) == pytest.approx(
        8 * 616 / HBM_BYTES_PER_MS)


def test_glcm_sums_north_star_band():
    # one band of the 100 MP scene: 8e8 bytes over 3.35 TB/s ~ 0.239 ms
    b = glcm_sums.call_bytes(10000, 10000, 2613, 4) / HBM_BYTES_PER_MS
    assert b == pytest.approx(0.2390, abs=5e-4)


def test_window_and_disk_offsets():
    w = quickshift.window_offsets(1)
    assert len(w) == 8 and (0, 0) not in map(tuple, w)
    assert len(quickshift.window_offsets(15)) == 31 * 31 - 1
    d = quickshift.disk_offsets(2, 1.5)
    # |dy|, |dx| <= 1 and dy^2 + dx^2 <= 2.25: the 8 neighbours
    assert sorted(map(tuple, d)) == sorted(map(tuple, w))
    assert len(quickshift.disk_offsets(15, 10.0)) == 316


def test_pairs_by_hand():
    # a 3 x 3 image, offsets (0, 1) and (1, 1): 3 * 2 + 2 * 2 pairs
    assert quickshift.pairs(np.array([[0, 1], [1, 1]]), 3, 3) == 10
    assert quickshift.pairs(np.array([[0, -1], [-1, 1]]), 3, 3) == 10
    assert quickshift.pairs(np.array([[5, 0]]), 3, 3) == 0


def test_quickshift_bounds_at_1024():
    # PERF.md's kernel table: 991,453,440 and 328,582,224 pairs at 1024^2
    r = quickshift.radius(5)
    assert r == 15
    n_d = quickshift.pairs(quickshift.window_offsets(r), 1024, 1024)
    n_p = quickshift.pairs(quickshift.disk_offsets(r, 10.0), 1024, 1024)
    assert (n_d, n_p) == (991453440, 328582224)
    assert quickshift.density_bound_ms(3, 1024, 1024, r) == pytest.approx(
        n_d / SFU_OPS_PER_MS)
    assert quickshift.density_bound_ms(3, 1024, 1024, r) == pytest.approx(
        0.2371, abs=1e-4)
    assert quickshift.parent_bound_ms(3, 1024, 1024, r, 10.0) == \
        pytest.approx(n_p * 13 / FP32_OPS_PER_MS)
