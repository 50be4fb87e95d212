"""The public functions of the JAX package that obia_tpu_torch carries
beside its main path, against the JAX package on the same seeded inputs on
the CPU: ``sjoin`` on ``within`` and ``contains``, the vector package's
exports, ``Point.centroid``/``area``, ``buffer0``, ``difference_bbox``,
``TiffReader.info``, ``normalize_band``, ``spectral_stats_table``,
``segment_glcm_props``/``glcm_table``, ``polygonize_labels(_rle)`` and
``mlp_apply``.

Bars: joins, geometries, metadata, normalised bands and polygons equal to
JAX's; spectral statistics within rtol 1e-4 / atol 1e-5 of JAX's float32
function with the same NaN slots (``test_torch_stats.py``'s bar against the
shipped function) and GLCM props within rtol 2e-4 / atol 1e-5
(``test_torch_glcm.py``'s); each table bitwise the packed function it
wraps; ``mlp_apply`` within float32 rounding (rtol 1e-6, atol 1e-6) of
JAX's.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from obia_tpu.geometry import geom as jgeom
from obia_tpu.vector import geodataframe as jgdf
from obia_tpu_torch.geometry import geom as tgeom
from obia_tpu_torch.vector import geodataframe as tgdf

# -- sjoin on within and contains ----------------------------------------------

SQUARES = [("box", (0, 0, 4, 4)), ("box", (3, 3, 8, 8)),
           ("box", (10, 10, 12, 12))]
POINTS = [("point", (1, 1)), ("point", (4, 2)), ("point", (3.5, 3.5)),
          ("point", (9, 9)), ("point", (0, 0)), ("point", (11, 12))]
HOLED = [("holed", ((0, 0, 10, 10), (3, 3, 7, 7))), ("box", (4, 4, 6, 6)),
         ("box", (1, 1, 2, 2)), ("box", (2, 2, 8, 8)),
         ("box", (-1, -1, 11, 11))]
MIXED = [("box", (0, 0, 5, 5)), ("point", (2, 2)),
         ("line", ((1, 1), (3, 4), (4, 1))), None, ("point", (20, 20)),
         ("line", ((1, 1), (9, 1)))]
CASES = {
    # points in squares, on their edges and corners, and outside
    "squares_points": (SQUARES, POINTS),
    # squares in squares: inside, sharing an edge, overlapping
    "squares_squares": ([("box", (1, 1, 2, 2)), ("box", (0, 0, 4, 2)),
                         ("box", (3, 3, 5, 5)), ("box", (4, 4, 8, 8))],
                        SQUARES),
    # a polygon with a hole against polygons in the hole, in the ring,
    # across the hole and around everything
    "holed": (HOLED, HOLED + [("point", (5, 5)), ("point", (1, 5))]),
    # a mixed left side: a polygon, points, lines and a missing geometry
    "mixed_left": (MIXED, SQUARES + [("box", (-1, -1, 6, 6))]),
}

# the cases that join something
JOINING = {("squares_points", "contains", False),
           ("squares_points", "within", True),
           ("squares_squares", "within", False),
           ("squares_squares", "contains", True),
           ("holed", "within", False), ("holed", "contains", False),
           ("mixed_left", "within", False),
           ("mixed_left", "contains", True)}


def _geometry(mod, spec):
    if spec is None:
        return None
    kind, arg = spec
    if kind == "point":
        return mod.Point(*arg)
    if kind == "line":
        return mod.LineString(arg)
    if kind == "box":
        return mod.box(*arg)
    outer, hole = arg
    ring = mod.box(*hole).exterior.coords_array[::-1]
    return mod.Polygon(mod.box(*outer).exterior.coords_array, [ring])


def _frame(gmod, vmod, specs, first_index):
    n = len(specs)
    return vmod.GeoDataFrame(
        {"name": [f"g{i}" for i in range(n)], "v": np.arange(n) * 10},
        geometry=[_geometry(gmod, s) for s in specs],
        index=np.arange(first_index, first_index + n))


def _rows(frame):
    """A join's rows as plain values: geometries by type and bounds."""
    out = []
    for idx, row in frame.iterrows():
        vals = []
        for c in frame.columns:
            v = row[c]
            if c == "geometry":
                v = None if v is None else (v.geom_type, tuple(v.bounds))
            vals.append(v)
        out.append((idx, *vals))
    return out


@pytest.mark.parametrize("swap", [False, True])
@pytest.mark.parametrize("predicate", ["within", "contains"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_sjoin_within_contains_match_jax(case, predicate, swap):
    lspec, rspec = CASES[case]
    if swap:
        lspec, rspec = rspec, lspec
    want = jgdf.sjoin(_frame(jgeom, jgdf, lspec, 100),
                      _frame(jgeom, jgdf, rspec, 7), predicate=predicate)
    got = tgdf.sjoin(_frame(tgeom, tgdf, lspec, 100),
                     _frame(tgeom, tgdf, rspec, 7), predicate=predicate)
    assert list(got.columns) == list(want.columns)
    assert _rows(got) == _rows(want)
    if (case, predicate, swap) in JOINING:
        assert len(want) > 0


def test_contains_is_within_swapped():
    """The points fast path of ``contains`` gives the pairs of the general
    path of ``within`` with the sides swapped, boundary points included."""
    from obia_tpu_torch.vector.features import join_pairs
    polys = [_geometry(tgeom, s) for s in SQUARES]
    pts = [_geometry(tgeom, s) for s in POINTS]
    got = join_pairs(polys, pts, "contains")
    assert sorted(got) == sorted((p, q) for q, p in join_pairs(pts, polys,
                                                                "within"))
    assert (0, 4) in got  # the corner point (0, 0)
    with pytest.raises(NotImplementedError, match="touches"):
        join_pairs(polys, pts, "touches")


def test_vector_package_exports():
    from obia_tpu_torch.vector import GeoDataFrame, read_file, sjoin
    assert (GeoDataFrame, read_file, sjoin) == (
        tgdf.GeoDataFrame, tgdf.read_file, tgdf.sjoin)
    import obia_tpu_torch.vector as tv
    assert tv.__all__ == ["GeoDataFrame", "read_file", "sjoin"]
    with pytest.raises(AttributeError):
        tv.not_a_name


# -- geometry ------------------------------------------------------------------

def test_point_centroid_area_buffer0_difference_bbox():
    for mod in (jgeom, tgeom):
        p = mod.Point(1.5, -2.0)
        assert p.centroid is p and p.area == 0.0
        poly = _geometry(mod, HOLED[0])
        assert poly.buffer0() is poly and p.buffer0() is p
        assert poly.difference_bbox((0, 0, 1, 1)) is poly
        line = mod.LineString([(0, 0), (1, 1)])
        assert line.buffer0() is line
    tp, jp = tgeom.Point(1.5, -2.0), jgeom.Point(1.5, -2.0)
    assert (tp.centroid.x, tp.centroid.y) == (jp.centroid.x, jp.centroid.y)


# -- io ------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(compression="deflate", tiled=True, tile_size=16, nodata=-9999.0,
         crs="EPSG:32633"),
    dict(compression="none", crs="EPSG:4326"),
    dict(compression="lzw")], ids=["tiled_deflate", "striped", "no_crs"])
def test_tiff_info_matches_jax(tmp_path, kw):
    from obia_tpu.geometry.affine import Affine
    from obia_tpu.io.tiff import TiffInfo as JInfo
    from obia_tpu.io.tiff import TiffReader as JReader
    from obia_tpu.io.tiff import write_tiff
    from obia_tpu_torch.io.tiff import TiffInfo, TiffReader

    arr = np.random.default_rng(3).integers(0, 999, (40, 24, 3)).astype(
        np.uint16)
    path = str(tmp_path / "x.tif")
    write_tiff(path, arr, transform=Affine(2.0, 0, 500.0, 0, -2.0, 900.0),
               **kw)
    got, want = TiffReader(path).info, JReader(path).info
    assert isinstance(got, TiffInfo)
    assert ([f.name for f in dataclasses.fields(TiffInfo)]
            == [f.name for f in dataclasses.fields(JInfo)])
    for f in dataclasses.fields(JInfo):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if f.name == "transform":
            g, w = tuple(g), tuple(w)
        elif f.name == "crs":
            g, w = (None if g is None else g.to_epsg(),
                    None if w is None else w.to_epsg())
        assert g == w, f.name


# -- segmentation and features -------------------------------------------------

@pytest.mark.parametrize("band", [
    np.random.default_rng(0).normal(3.0, 2.0, (9, 7)).astype(np.float32),
    np.random.default_rng(1).integers(0, 4000, (6, 5)).astype(np.uint16),
    np.full((4, 4), 7.5, np.float32)], ids=["float", "uint16", "constant"])
def test_normalize_band_matches_jax(band):
    from obia_tpu.segmentation.segment_boundaries import normalize_band as jn
    from obia_tpu_torch.segmentation.segment_boundaries import normalize_band
    got, want = normalize_band(band), jn(band)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _feature_scene(seed=0, h=40, w=56, c=3, k=14):
    """test_torch_stats.py's scene: blobby objects, -1 pixels, an empty id,
    a constant object and a 1-pixel object."""
    rng = np.random.default_rng(seed)
    lab = np.repeat(np.repeat(rng.integers(0, k - 2, (h // 8, w // 8)), 8,
                              0), 8, 1).astype(np.int32)
    lab[:3, :5] = -1
    lab[lab == 2] = 1
    lab[20, 20] = k - 1
    img = (rng.normal(size=(h, w, c)) * 10 + 50).astype(np.float32)
    img[lab == 4] = 3.0
    return img, lab, k


@pytest.mark.parametrize("valid", [False, True])
def test_spectral_stats_table_matches_jax(valid):
    from obia_tpu.ops.stats import SPECTRAL_STAT_NAMES as JNAMES
    from obia_tpu.ops.stats import spectral_stats_table as jtable
    from obia_tpu_torch.ops import stats as tstats

    img, lab, k = _feature_scene()
    mask = np.random.default_rng(9).random(lab.shape) > 0.2 if valid else None
    want = jtable(img, lab, k, mask)
    got = tstats.spectral_stats_table(img, lab, k, mask, device="cpu")
    assert tstats.SPECTRAL_STAT_NAMES == JNAMES
    assert set(got) == set(want)  # JAX's jitted dict comes back sorted
    for name in want:
        assert got[name].dtype == np.float32
        np.testing.assert_array_equal(np.isnan(got[name]),
                                      np.isnan(want[name]), err_msg=name)
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    # the table is the packed path's columns (tensor inputs stay put)
    names, packed = tstats.spectral_moments_packed(
        torch.as_tensor(img), torch.as_tensor(lab), k,
        None if mask is None else torch.as_tensor(mask))
    again = tstats.spectral_stats_table(torch.as_tensor(img), lab, k, mask)
    for i, name in enumerate(names):
        np.testing.assert_array_equal(got[name], packed[i])
        np.testing.assert_array_equal(again[name], packed[i])


GLCM_KW = {"default": {},
           "levels32_band1_noasm": dict(levels=32, bands=(1,),
                                        compute_asm=False),
           "distance1_two_angles": dict(distance=1,
                                        angles=(0.0, np.pi / 2))}


@pytest.mark.parametrize("kw", sorted(GLCM_KW))
def test_glcm_table_matches_jax(kw):
    from obia_tpu.ops.glcm import glcm_table as jtable
    from obia_tpu.ops.glcm import segment_glcm_props as jprops
    from obia_tpu_torch import telemetry
    from obia_tpu_torch.ops import glcm as tg

    img, lab, k = _feature_scene(1)
    opts = GLCM_KW[kw]
    want = jtable(img, lab, k, **opts)
    before = telemetry.counters().get("kernel.glcm_sums", 0)
    got = tg.glcm_table(img, lab, k, device="cpu", **opts)
    # the CPU takes the twin
    assert telemetry.counters().get("kernel.glcm_sums", 0) == before
    props = tg.segment_glcm_props(torch.as_tensor(img), torch.as_tensor(lab),
                                  k, **opts)
    want_props = jprops(jnp.asarray(img), jnp.asarray(lab), k, **opts)
    names, packed = tg.segment_glcm_props_packed(
        torch.as_tensor(img), torch.as_tensor(lab), k, **opts)
    assert list(got) == list(want) == list(props) == list(names)
    for i, name in enumerate(names):
        np.testing.assert_array_equal(got[name], packed[i])
        np.testing.assert_array_equal(props[name], packed[i])
        for w in (want[name], np.asarray(want_props[name])):
            assert got[name].shape == w.shape
            np.testing.assert_array_equal(np.isnan(got[name]), np.isnan(w),
                                          err_msg=name)
            np.testing.assert_allclose(got[name], w, rtol=2e-4, atol=1e-5,
                                       err_msg=name)


def test_array_inputs_default_to_the_card(monkeypatch):
    from obia_tpu_torch.ops import glcm as tg
    from obia_tpu_torch.ops import stats as tstats
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img, lab, k = _feature_scene()
    for fn in (tstats.spectral_stats_table, tg.glcm_table):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(img, lab, k)


# -- polygons ------------------------------------------------------------------

def _label_rasters():
    rng = np.random.default_rng(4)
    split = np.zeros((12, 14), np.int32)       # label 1 in two regions
    split[2:5, 1:4] = 1
    split[7:11, 8:13] = 1
    split[6, :] = 2
    pinched = np.zeros((8, 8), np.int32)        # label 1 meets at a corner
    pinched[1:4, 1:4] = 1
    pinched[4:7, 4:7] = 1
    holes = np.full((16, 18), 3, np.int32)      # a ring with two holes
    holes[3:6, 3:7] = 5
    holes[9:13, 10:15] = -1
    holes[10:12, 11:13] = 3                     # an island in a hole
    blocks = np.repeat(np.repeat(rng.integers(-1, 6, (6, 8)), 5, 0), 4,
                       1).astype(np.int32)
    return {"split": split, "pinched": pinched, "holes": holes,
            "blocks": blocks}


def _same_polygons(got, want):
    assert sorted(got) == sorted(want)
    for label, polys in want.items():
        assert len(got[label]) == len(polys), label
        for g, w in zip(got[label], polys):
            np.testing.assert_array_equal(g.exterior.coords_array,
                                          w.exterior.coords_array)
            assert len(g.interiors) == len(w.interiors)
            for gh, wh in zip(g.interiors, w.interiors):
                np.testing.assert_array_equal(gh.coords_array,
                                              wh.coords_array)
            assert g.area == w.area


@pytest.mark.parametrize("simplify", [True, False])
@pytest.mark.parametrize("raster", sorted(_label_rasters()))
def test_polygonize_labels_match_jax(raster, simplify):
    from obia_tpu.geometry import polygonize as jpoly
    from obia_tpu_torch.geometry import polygonize as tpoly
    from obia_tpu_torch.ops.slic import download_labels_rle

    lab = _label_rasters()[raster]
    got = tpoly.polygonize_labels(lab, simplify=simplify)
    _same_polygons(got, jpoly.polygonize_labels(lab, simplify=simplify))
    rle = download_labels_rle(torch.as_tensor(lab))
    got_rle = tpoly.polygonize_labels_rle(*rle, simplify=simplify)
    _same_polygons(got_rle, jpoly.polygonize_labels_rle(*rle,
                                                        simplify=simplify))
    _same_polygons(got_rle, got)
    H, W = lab.shape
    total = sum(p.area for polys in got.values() for p in polys)
    assert total == (lab >= 0).sum() and H * W >= total
    if raster in ("split", "pinched"):
        assert len(got[1]) == 2


# -- the fused model's head ----------------------------------------------------

def test_mlp_apply_matches_jax():
    import jax

    from obia_tpu.models.pipeline import init_mlp_params
    from obia_tpu.models.pipeline import mlp_apply as jmlp
    from obia_tpu_torch.models.pipeline import mlp_apply, params_from_jax

    params = init_mlp_params(jax.random.PRNGKey(0), 7, 4)
    x = np.random.default_rng(5).normal(size=(33, 7)).astype(np.float32)
    want = np.asarray(jmlp(params, jnp.asarray(x)))
    tparams = {k: torch.as_tensor(np.array(v)) for k, v in params.items()}
    got = mlp_apply(tparams, torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    head = params_from_jax(params, device="cpu")
    with torch.no_grad():
        assert torch.equal(head(torch.as_tensor(x)), got)
