"""The port's canopy workflow (``utils/seeds``, ``utils/cost``) against the
JAX package on the same inputs, on the CPU: peak sets equal (plateaus and
nodata included), the distance matrix within rtol 1e-6 / atol 1e-6 (bitwise
at the canonical path's 12 samples), DBSCAN labels equal to sklearn's, seed
and canonical-seed GeoPackages row for row equal, each cost term and the
cost raster within atol 1e-6 with equal nodata, the same errors; and the
CLI commands write what the Python calls write."""
import os
import sqlite3
import warnings

import numpy as np
import pandas as pd
import pytest
import torch

import chip_smoke
from obia_tpu.io.tiff import TiffReader as JaxTiffReader
from obia_tpu.utils import cost as jcost
from obia_tpu.utils import seeds as jseeds
from obia_tpu_torch.geometry.affine import Affine
from obia_tpu_torch.io.gpkg import write_features
from obia_tpu_torch.io.tiff import TiffReader, write_tiff
from obia_tpu_torch.utils import cost as tcost
from obia_tpu_torch.utils import seeds as tseeds

SIZE = 96
T = Affine(1.0, 0.0, 500000.0, 0.0, -1.0, 5100000.0)
CPU = {"device": "cpu"}


def gpkg_rows(path, layer):
    """Schema, rows (geometry blobs included), SRS and geometry type of a
    GeoPackage layer, read with sqlite3."""
    con = sqlite3.connect(path)
    try:
        schema = con.execute(f'PRAGMA table_info("{layer}")').fetchall()
        rows = con.execute(f'SELECT * FROM "{layer}" ORDER BY fid').fetchall()
        meta = con.execute(
            "SELECT srs_id, geometry_type_name FROM gpkg_geometry_columns "
            "WHERE table_name = ?", (layer,)).fetchall()
    finally:
        con.close()
    return schema, rows, meta


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """chip_smoke's canopy inputs at 96^2 (CHM and density with nodata, an
    8-band stack with nodata, a SLIC GPKG in EPSG:4326), a tie-heavy CHM
    (heights in steps of 0.5 m) and a cost raster of uniform noise."""
    root = str(tmp_path_factory.mktemp("canopy"))
    paths = chip_smoke.write_canopy_inputs(root, SIZE, 0, "cpu",
                                           n_segments=20)
    chm = TiffReader(paths["chm"]).read()[:, :, 0]
    tied = np.where(chm == -9999.0, chm, np.round(chm * 2) / 2)
    paths["tied"] = os.path.join(root, "tied.tif")
    write_tiff(paths["tied"], tied.astype(np.float32), transform=T,
               crs="EPSG:32633", nodata=-9999.0)
    rng = np.random.default_rng(7)
    paths["noise_cost"] = os.path.join(root, "noise_cost.tif")
    write_tiff(paths["noise_cost"], rng.random((SIZE, SIZE)).astype(
        np.float32), transform=T, crs="EPSG:32633")
    paths["root"] = root
    return paths


def _nan_band(path):
    return jseeds._read_band_nan(path)[0]


@pytest.mark.parametrize("raster", ["chm", "density", "tied"])
@pytest.mark.parametrize("sigma", [0, 1, 2])
def test_detect_peaks_equal(scene, raster, sigma):
    arr = _nan_band(scene[raster])
    if raster == "tied":
        arr[40:48, 40:48] = 9.0   # a plateau: every pixel of it is a peak
    want = jseeds._detect_peaks(arr, 2.5, 3, sigma)
    got = tseeds._detect_peaks(arr, 2.5, 3, sigma, **CPU)
    assert len(want) > 0 and got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def test_peaks_survive_near_nodata_border():
    arr = np.full((40, 40), 1.0, np.float32)
    arr[:, :6] = np.nan
    arr[20, 9] = 20.0
    got = tseeds._detect_peaks(arr, v_min=2.0, min_dist_px=3, sigma=1.0,
                               **CPU)
    np.testing.assert_array_equal(
        got, jseeds._detect_peaks(arr, v_min=2.0, min_dist_px=3, sigma=1.0))
    assert [tuple(p) for p in got] == [(20, 9)]


DM_CASES = {
    # n, samples, transform, weight, xy_thresh, on pixel centres
    "12 samples": (300, 12, T, 0.5, 0.8, False),
    "pixel centres": (200, 12, T, 0.5, 0.8, True),
    "rotated grid": (150, 12, Affine(0.5, 0.1, 500000.0, 0.05, -0.5,
                                     5100000.0), 0.3, 2.0, False),
    "8 samples": (120, 8, T, 1.0, 0.8, False),
    "weight 0": (90, 5, T, 0.0, 0.8, False),
}


@pytest.mark.parametrize("case", sorted(DM_CASES))
def test_distance_matrix_matches_jax(case, monkeypatch):
    n, samples, tfm, weight, thresh, centres = DM_CASES[case]
    rng = np.random.default_rng(n)
    if centres:
        xs = 500000.0 + rng.integers(0, SIZE, n) + 0.5
        ys = 5100000.0 - rng.integers(0, SIZE, n) - 0.5
    else:
        xs = 500000.0 + rng.random(n) * SIZE
        ys = 5100000.0 - rng.random(n) * SIZE
    cost = rng.random((SIZE, SIZE)).astype(np.float32)
    want = jseeds.build_distance_matrix(xs, ys, cost, tfm, weight, thresh,
                                        samples)
    # small blocks: many row blocks, each cut at the diagonal
    monkeypatch.setattr(tseeds, "_BLOCK_BYTES", 37 * n * tseeds._PAIR_BYTES)
    got = tseeds.build_distance_matrix(xs, ys, cost, tfm, weight, thresh,
                                       samples, **CPU)
    assert got.dtype == np.float32 and got.shape == (n, n)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.array_equal(got, got.T) and not np.diag(got).any()
    if samples == 12:
        # XLA's CPU arithmetic (fused multiply-adds, its hypot, sum times
        # 1/S) reproduced: bitwise
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [0, 1])
def test_distance_matrix_degenerate(n):
    xs = np.arange(n, dtype=float)
    cost = np.zeros((4, 4), np.float32)
    got = tseeds.build_distance_matrix(xs, xs, cost, T, 0.5, 0.8, **CPU)
    want = jseeds.build_distance_matrix(xs, xs, cost, T, 0.5, 0.8)
    assert got.shape == want.shape == (n, n) and not got.any()


@pytest.mark.parametrize("eps", [0.5, 1.5, 4.0, "tie"])
def test_dbscan_labels_equal_sklearn(eps):
    from sklearn.cluster import DBSCAN
    rng = np.random.default_rng(3)
    n = 250
    xs = 500000.0 + np.round(rng.random(n) * 40, 1)
    ys = 5100000.0 - np.round(rng.random(n) * 40, 1)
    cost = rng.random((SIZE, SIZE)).astype(np.float32)
    D = jseeds.build_distance_matrix(xs, ys, cost, T, 0.5, 0.8, 12)
    if eps == "tie":   # eps equal to a pair's distance: the pair joins
        eps = float(np.sort(D[np.triu_indices(n, 1)])[n])
    want = DBSCAN(eps=eps, min_samples=1, metric="precomputed").fit(D).labels_
    got = tseeds.dbscan_labels(torch.as_tensor(D), eps)
    assert want.max() > 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_descending_order_is_pandas(dtype):
    rng = np.random.default_rng(11)
    h = rng.integers(0, 12, 3000).astype(dtype) / 2   # ties everywhere
    h[::97] = np.nan
    want = pd.DataFrame({"height": h}).sort_values(
        "height", ascending=False).index.to_numpy()
    np.testing.assert_array_equal(tseeds._nargsort_desc(h), want)


@pytest.mark.parametrize("n", [1, 2, 5])
def test_head_mask_is_groupby_head(n):
    rng = np.random.default_rng(n)
    keys = rng.integers(-1, 40, 500)
    want = pd.DataFrame({"k": keys}).groupby("k").head(n).index.to_numpy()
    np.testing.assert_array_equal(np.flatnonzero(tseeds._head_mask(keys, n)),
                                  want)


@pytest.fixture(scope="module")
def seed_sets(scene):
    """Both packages' seed GPKGs: the defaults of the CLI on the canopy
    CHM and density, the tie-heavy CHM with no blur for both sets, and the
    density peaks without a value column (heights sampled from the CHM)."""
    out = {}
    for pkg, mod, kw in (("jax", jseeds, {}), ("port", tseeds, CPU)):
        d = os.path.join(scene["root"], pkg)
        os.makedirs(d, exist_ok=True)
        p = {k: os.path.join(d, f"{k}.gpkg") for k in
             ("chm_seeds", "den_seeds", "tied_chm", "tied_den")}
        mod.make_chm_seeds(scene["chm"], p["chm_seeds"], **kw)
        mod.make_density_seeds(scene["density"], p["den_seeds"], d_min=4.5,
                               min_dist_px=4, gauss_sigma=2, **kw)
        mod.make_chm_seeds(scene["tied"], p["tied_chm"], min_dist_px=2,
                           gauss_sigma=0, **kw)
        mod.make_density_seeds(scene["tied"], p["tied_den"], d_min=2.5,
                               min_dist_px=2, gauss_sigma=0, **kw)
        out[pkg] = p
    # points without a height column: make_canonical_seeds samples the CHM
    rows = gpkg_rows(out["port"]["den_seeds"], "den_seeds")[1]
    from obia_tpu_torch.vector.features import read_features
    pts = read_features(out["port"]["den_seeds"])
    out["bare"] = os.path.join(scene["root"], "bare.gpkg")
    write_features(out["bare"], [("id", list(range(len(rows))))],
                   pts.geometry, "bare", pts.crs)
    return out


@pytest.mark.parametrize("name", ["chm_seeds", "den_seeds", "tied_chm",
                                  "tied_den"])
def test_seed_gpkgs_equal_jax(seed_sets, name):
    want = gpkg_rows(seed_sets["jax"][name], name)
    got = gpkg_rows(seed_sets["port"][name], name)
    assert len(want[1]) > 3
    assert got == want


CANONICAL = {
    "defaults": ("chm_seeds", "den_seeds", "chm", {}),
    "cost surface": ("chm_seeds", "den_seeds", "chm", {"cost": "canopy"}),
    "dz_merge": ("chm_seeds", "den_seeds", "chm",
                 dict(dz_merge=2.0, merge_radius=6.0)),
    "max_per_cluster + nms": ("chm_seeds", "den_seeds", "chm",
                              dict(max_per_cluster=2, merge_radius=8.0,
                                   nms_base=1.5, nms_scale=0.1)),
    "stage-1 top": ("chm_seeds", "den_seeds", "chm",
                    dict(keep_all_stage1=False, stage1_top=2,
                         merge_radius=3.0, min_eps=3, z_thresh=4.0)),
    "tied heights": ("tied_chm", "tied_den", "tied",
                     dict(merge_radius=5.0, dz_merge=1.0,
                          max_per_cluster=3, nms_base=2.0)),
    "tied, stage-1 top": ("tied_chm", "tied_den", "tied",
                          dict(keep_all_stage1=False, merge_radius=4.0)),
    "sampled heights": ("chm_seeds", "bare", "chm",
                        dict(merge_radius=3.0, nms_scale=0.2)),
}


@pytest.mark.parametrize("case", list(CANONICAL))
def test_canonical_seeds_equal_jax(scene, seed_sets, case, tmp_path,
                                   capsys):
    chm_name, den_name, chm_raster, kw = CANONICAL[case]
    kw = dict(kw)
    cost = (scene["noise_cost"] if kw.pop("cost", None) is None
            else str(tmp_path / "cost.tif"))
    if cost != scene["noise_cost"]:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jcost.make_cost_surface(scene["wv3"], scene["chm"], cost)
    outs = {}
    for pkg, mod, extra in (("jax", jseeds, {}), ("port", tseeds, CPU)):
        sets = seed_sets[pkg]
        den = seed_sets["bare"] if den_name == "bare" else sets[den_name]
        outs[pkg] = str(tmp_path / f"{pkg}.gpkg")
        mod.make_canonical_seeds(sets[chm_name], den, scene[chm_raster],
                                 cost, outs[pkg], **kw, **extra)
    printed = capsys.readouterr().out.splitlines()
    d_eff = [line for line in printed if line.startswith("d_eff")]
    assert len(d_eff) == 2 and d_eff[0] == d_eff[1]
    want = gpkg_rows(outs["jax"], "canonical_seeds")
    got = gpkg_rows(outs["port"], "canonical_seeds")
    clusters = {r[3] for r in want[1]}
    assert len(want[1]) > 10 and 1 < len(clusters)
    if not {"nms_base", "nms_scale"} & set(kw):   # NMS keeps one a crown
        assert len(clusters) < len(want[1])        # DBSCAN merged seeds
    assert got == want


def test_canonical_seeds_returns_its_table(scene, seed_sets, tmp_path):
    sets = seed_sets["port"]
    out = tseeds.make_canonical_seeds(
        sets["chm_seeds"], sets["den_seeds"], scene["chm"],
        scene["noise_cost"], str(tmp_path / "c.gpkg"), debug_dist=False,
        **CPU)
    rows = gpkg_rows(str(tmp_path / "c.gpkg"), "canonical_seeds")[1]
    assert len(out) == len(rows) and out["id"] == list(range(len(rows)))
    assert out["cluster"] == [r[3] for r in rows]
    assert out.crs.to_epsg() == 32633


def _profile(path, reader=TiffReader):
    r = reader(path)
    return {"height": r.height, "width": r.width, "crs": r.crs,
            "transform": r.transform}


def test_cost_terms_equal_jax(scene):
    chm = jcost.read_band(scene["chm"])[0]
    stack = JaxTiffReader(scene["wv3"]).read().astype(np.float32)
    stack = np.where(stack == 0, np.nan, stack)
    got, want = tcost.chm_gradient(chm, **CPU), jcost.chm_gradient(chm)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    got = tcost.texture_entropy(stack[:, :, 0], **CPU)
    np.testing.assert_allclose(got, jcost.texture_entropy(stack[:, :, 0]),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tcost.ndvi(stack[:, :, 4], stack[:, :, 6]),
                                  jcost.ndvi(stack[:, :, 4], stack[:, :, 6]))
    np.testing.assert_array_equal(tcost.normalise(chm), jcost.normalise(chm))
    lab = jcost.rasterise_slic_gpkg(scene["slic"],
                                    _profile(scene["wv3"], JaxTiffReader))
    np.testing.assert_array_equal(tcost.slic_edge(lab), jcost.slic_edge(
        lab))
    nan_lab = np.where(lab % 3 == 0, np.nan, lab)
    np.testing.assert_array_equal(tcost.slic_edge(nan_lab),
                                  jcost.slic_edge(nan_lab))


def test_rasterise_slic_gpkg_reprojects_like_jax(scene):
    """The SLIC layer is in EPSG:4326 and the grid in EPSG:32633: both
    packages reproject it with ``to_raster_crs`` and burn the same ids."""
    got = tcost.rasterise_slic_gpkg(scene["slic"], _profile(scene["wv3"]))
    want = jcost.rasterise_slic_gpkg(scene["slic"],
                                     _profile(scene["wv3"], JaxTiffReader))
    assert got.dtype == np.uint32 and len(np.unique(got)) > 5
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("slic", [True, False])
def test_cost_surface_equal_jax(scene, slic, tmp_path):
    kw = ({"slic": scene["slic"], "weights": (0.4, 0.2, 0.2, 0.2)} if slic
          else {})
    outs = {}
    for pkg, mod, extra in (("jax", jcost, {}), ("port", tcost, CPU)):
        outs[pkg] = str(tmp_path / f"{pkg}.tif")
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            mod.make_cost_surface(scene["wv3"], scene["chm"], outs[pkg], **kw,
                                  **extra)
        assert any("renormalising" in str(x.message) for x in w) != slic
    got_r, want_r = TiffReader(outs["port"]), JaxTiffReader(outs["jax"])
    got, want = got_r.read()[:, :, 0], want_r.read()[:, :, 0]
    assert got_r.nodata == want_r.nodata == tcost.NODATA
    np.testing.assert_array_equal(got == tcost.NODATA, want == tcost.NODATA)
    assert 0 < (got == tcost.NODATA).sum() < got.size
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _four_bands(scene, tmp_path):
    path = str(tmp_path / "four.tif")
    write_tiff(path, TiffReader(scene["wv3"]).read()[:, :, :4], transform=T,
               crs="EPSG:32633")
    return path


COST_ERRORS = {
    "three weights": (SystemExit, {"weights": (0.5, 0.25, 0.25)}),
    "weights not total 1": (SystemExit, {"weights": (1, 1, 1, 1)}),
    "four bands": (SystemExit, {"wv3": "four"}),
    "SLIC-only weights without slic": (ValueError,
                                       {"weights": (0, 0, 0, 1)}),
}


@pytest.mark.parametrize("case", sorted(COST_ERRORS))
def test_cost_surface_errors_match_jax(scene, case, tmp_path):
    exc, kw = COST_ERRORS[case]
    kw = dict(kw)
    wv3 = (_four_bands(scene, tmp_path) if kw.pop("wv3", None)
           else scene["wv3"])
    for mod, extra in ((jcost, {}), (tcost, CPU)):
        with pytest.raises(exc) as info:
            mod.make_cost_surface(wv3, scene["chm"], str(tmp_path / "c.tif"),
                                  **kw, **extra)
        if exc is ValueError:
            assert "SLIC" in str(info.value)


@pytest.mark.parametrize("fn", ["make_chm_seeds", "make_density_seeds"])
def test_missing_raster_exits(fn, tmp_path):
    for mod, extra in ((jseeds, {}), (tseeds, CPU)):
        with pytest.raises(SystemExit):
            getattr(mod, fn)(str(tmp_path / "nope.tif"),
                             str(tmp_path / "o.gpkg"), **extra)


def _invoke(args):
    from click.testing import CliRunner

    from obia_tpu_torch.cli import build_cli
    res = CliRunner().invoke(build_cli(), args + ["--device", "cpu"])
    assert res.exit_code == 0, res.output
    return res.output


@pytest.mark.parametrize("command", ["chm-seeds", "density-seeds",
                                     "cost-surface", "canonical-seeds"])
def test_cli_writes_what_the_calls_write(scene, seed_sets, command,
                                         tmp_path):
    cli, call = str(tmp_path / "cli"), str(tmp_path / "call")
    if command in ("chm-seeds", "density-seeds"):
        raster = scene["chm" if command == "chm-seeds" else "density"]
        fn = (tseeds.make_chm_seeds if command == "chm-seeds"
              else tseeds.make_density_seeds)
        _invoke([command, raster, cli + ".gpkg"])
        fn(raster, call + ".gpkg", **CPU)
        assert gpkg_rows(cli + ".gpkg", "cli")[1:] == \
            gpkg_rows(call + ".gpkg", "call")[1:]
        return
    if command == "cost-surface":
        out = _invoke([command, scene["wv3"], scene["chm"], cli + ".tif",
                       "--slic", scene["slic"], "--weights",
                       "0.4,0.2,0.2,0.2"])
        tcost.make_cost_surface(scene["wv3"], scene["chm"], call + ".tif",
                                slic=scene["slic"],
                                weights=(0.4, 0.2, 0.2, 0.2), **CPU)
        assert "cost surface written" in out
        with open(cli + ".tif", "rb") as a, open(call + ".tif", "rb") as b:
            assert a.read() == b.read()
        return
    sets = seed_sets["port"]
    args = [sets["chm_seeds"], sets["den_seeds"], scene["chm"],
            scene["noise_cost"]]
    out = _invoke([command, *args, cli + ".gpkg", "--merge-radius", "3.0",
                   "--cost-weight", "0.25"])
    tseeds.make_canonical_seeds(*args, call + ".gpkg", merge_radius=3.0,
                                cost_weight=0.25, **CPU)
    assert "canonical seeds:" in out
    assert gpkg_rows(cli + ".gpkg", "canonical_seeds") == \
        gpkg_rows(call + ".gpkg", "canonical_seeds")
