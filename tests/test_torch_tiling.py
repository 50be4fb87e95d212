"""obia_tpu_torch's tiled checkerboard segmentation (config 3) and the host
tools it runs on (rasterisation, the within/overlaps predicates, the
GeoPackage reader) against the JAX package on the CPU.

The scene is ``tests/test_tiling.py``'s ``big_scene`` (160 x 240 RGB, tile
80, buffer 16, n_segments 20), run by both packages with and without an
input mask; each JAX run is made once per module. Bars: the same number of
segments, the rasterised label maps equal as partitions (and every polygon
equal), ``segment_id`` 1..N, the reference test's coverage bars (area >
93% of the raster, pixels covered at most once > 99.5%); rasters bitwise
JAX's; predicates equal to JAX's on every pair; GeoPackages read back with
equal columns and geometries.
"""
import json
import os

import numpy as np
import pytest

from obia_tpu_torch.geometry import geom as tgeom
from obia_tpu_torch.geometry.rasterize import rasterize
from obia_tpu_torch.io import gpkg as tgpkg
from obia_tpu_torch.io.tiff import TiffReader
from obia_tpu_torch.utils import tiling

H, W = 160, 240
KW = dict(method="slic", tile_size=80, buffer=16, n_segments=20,
          compactness=10)
TRANSFORM = (2.0, 0, 1000.0, 0, -2.0, 5000.0)


def _write_scene(path):
    from obia_tpu_torch.geometry.affine import Affine
    from obia_tpu_torch.io.tiff import write_tiff
    rng = np.random.default_rng(42)
    base = np.zeros((H, W, 3), np.float32)
    for k in range(6):
        base[:, k * 40:(k + 1) * 40, k % 3] = 0.5 + 0.08 * k
    arr = np.clip(base + rng.normal(0, 0.02, (H, W, 3)), 0, 1)
    write_tiff(path, (arr * 255).astype(np.uint8),
               transform=Affine(*TRANSFORM), crs="EPSG:32633")


def _write_mask(path):
    """A valid-data mask: a disk cut out near the centre and a strip down
    the right edge."""
    from obia_tpu_torch.geometry.affine import Affine
    from obia_tpu_torch.io.tiff import write_tiff
    yy, xx = np.mgrid[0:H, 0:W]
    m = ~(((yy - 70) ** 2 + (xx - 110) ** 2) < 30 ** 2) & (xx < 220)
    write_tiff(path, m.astype(np.uint8)[:, :, None],
               transform=Affine(*TRANSFORM), crs="EPSG:32633")
    return m


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiling")
    raster, mask = str(d / "scene.tif"), str(d / "mask.tif")
    _write_scene(raster)
    valid = _write_mask(mask)
    return d, raster, mask, valid


@pytest.fixture(scope="module")
def runs(scene):
    """{masked: (JAX frame, port layer, port output dir)}."""
    from obia_tpu.utils.tiling import create_tiled_segments as jax_tiled
    d, raster, mask, _ = scene
    out = {}
    for masked in (False, True):
        m = mask if masked else None
        jax = jax_tiled(raster, str(d / f"jax_{masked}"), input_mask=m, **KW)
        port_dir = str(d / f"port_{masked}")
        port = tiling.create_tiled_segments(raster, port_dir, input_mask=m,
                                            device="cpu", **KW)
        out[masked] = (jax, port, port_dir)
    return out


def _label_map(geoms, jax=False):
    """The label map of ``geoms`` (-1 where none), rasterised by the
    package that built them."""
    if jax:
        from obia_tpu.geometry.affine import Affine
        from obia_tpu.geometry.rasterize import rasterize as raster_fn
    else:
        from obia_tpu_torch.geometry.affine import Affine
        raster_fn = rasterize
    return raster_fn([(g, i) for i, g in enumerate(geoms)], (H, W),
                     transform=Affine(*TRANSFORM), fill=-1, dtype=np.int32)


def _coords(g):
    polys = g.geoms if hasattr(g, "geoms") else [g]
    return [np.concatenate([p.exterior.coords_array]
                           + [h.coords_array for h in p.interiors])
            for p in polys]


@pytest.mark.parametrize("masked", [False, True])
def test_tiled_segments_match_jax(runs, masked):
    from test_torch_slic import same_partition
    jax, port, _ = runs[masked]
    assert len(port) == len(jax) > 10
    assert list(port.segment_id) == list(range(1, len(port) + 1))
    assert same_partition(_label_map(port.geometry),
                          _label_map(list(jax.geometry), jax=True))
    for a, b in zip(port.geometry, jax.geometry):
        assert all(np.array_equal(x, y)
                   for x, y in zip(_coords(a), _coords(b)))


@pytest.mark.parametrize("masked", [False, True])
def test_tiled_coverage(runs, scene, masked):
    _, port, _ = runs[masked]
    valid = scene[3] if masked else np.ones((H, W), bool)
    total = sum(g.area for g in port.geometry)
    target = valid.sum() * 4.0  # 2 x 2 m pixels
    assert 0.93 * target < total <= H * W * 4.0 + 1e-6
    from obia_tpu_torch.geometry.affine import Affine
    counts = np.zeros((H, W), np.int32)
    for g in port.geometry:
        counts += rasterize([(g, 1)], (H, W), transform=Affine(*TRANSFORM),
                            dtype=np.int32)
    assert (counts <= 1).mean() > 0.995
    if masked:
        assert (counts[~valid] == 0).mean() > 0.99


@pytest.mark.parametrize("masked", [False, True])
def test_outputs_read_back(runs, masked):
    from obia_tpu.vector import read_file as jax_read
    jax, port, port_dir = runs[masked]
    path = os.path.join(port_dir, "segments.gpkg")
    cols, geoms, crs = tgpkg.read_gpkg(path)
    assert list(cols) == ["segment_id"] and crs.to_epsg() == 32633
    assert cols["segment_id"] == list(range(1, len(port) + 1))
    back = jax_read(path)
    assert len(back) == len(jax)
    assert list(back["segment_id"]) == list(jax["segment_id"])
    manifest = json.load(open(os.path.join(port_dir, "manifest.json")))
    assert manifest and all(v["status"] == "done"
                            for v in manifest.values())
    frame = port.to_geodataframe()
    assert list(frame["segment_id"]) == cols["segment_id"]
    assert frame.crs == port.crs and len(frame.geometry) == len(port)


def test_resume_segments_no_tile(runs, scene, monkeypatch):
    _, port, port_dir = runs[False]
    calls = []
    real = tiling.create_segments
    monkeypatch.setattr(tiling, "create_segments",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    again = tiling.create_tiled_segments(scene[1], port_dir, resume=True,
                                         device="cpu", **KW)
    assert calls == []
    assert len(again) == len(port)
    for a, b in zip(again.geometry, port.geometry):
        assert all(np.array_equal(x, y)
                   for x, y in zip(_coords(a), _coords(b)))


def test_failed_tile_is_marked(scene, tmp_path, monkeypatch, capsys):
    real = tiling.create_segments
    seen = []

    def flaky(*a, **k):
        seen.append(1)
        if len(seen) == 2:
            raise RuntimeError("simulated launch failure")
        return real(*a, **k)

    monkeypatch.setattr(tiling, "create_segments", flaky)
    out = tiling.create_tiled_segments(scene[1], str(tmp_path / "o"),
                                       device="cpu", **KW)
    from obia_tpu_torch.checkpoint import TileManifest
    m = TileManifest(str(tmp_path / "o" / "manifest.json"))
    assert m.failed() == ["black_0_160"]
    assert "simulated launch failure" in m.state["black_0_160"]["error"]
    assert "tile FAILED" in capsys.readouterr().out
    assert len(out) > 10


def test_get_raster_bbox_and_other_methods(scene, tmp_path):
    from obia_tpu.io.tiff import TiffReader as JaxReader
    from obia_tpu.utils.tiling import get_raster_bbox as jax_bbox
    raster = scene[1]
    assert tiling.get_raster_bbox(TiffReader(raster)) == jax_bbox(
        JaxReader(raster))
    with pytest.raises(ValueError):
        tiling.create_tiled_segments(raster, str(tmp_path / "o"),
                                     method="quickshift", device="cpu")


def test_tiles_stream_windows(scene, tmp_path, monkeypatch):
    windows = []
    orig = TiffReader.read

    def spy(self, window=None):
        assert window is not None, "full-raster read on the tiled path"
        windows.append(window)
        return orig(self, window=window)

    monkeypatch.setattr(TiffReader, "read", spy)
    out = tiling.create_tiled_segments(scene[1], str(tmp_path / "o"),
                                       device="cpu", **KW)
    assert len(out) > 10 and len(windows) == 6


# -- the host tools ------------------------------------------------------------

def _shapes(mod):
    """Polygons with holes, a MultiPolygon and a concave ring, built by
    ``mod`` (this package's geom module or the JAX package's)."""
    P, M = mod.Polygon, mod.MultiPolygon
    return [
        P([(2, 2), (30, 3), (28, 25), (3, 27)],
          [[(8, 8), (15, 8), (15, 15), (8, 15)]]),
        M([P([(35.3, 1.5), (60, 1.5), (60, 14.5), (35.3, 14.5)]),
           P([(40, 18), (58, 18), (58, 30), (40, 30)],
             [[(44, 21), (50, 21), (47, 27)]])]),
        P([(5, 31), (25, 31), (25, 39.5), (15, 33), (5, 39.5)]),
        P([(0, 0), (1e-3, 0), (1e-3, 1e-3)]),
    ]


@pytest.mark.parametrize("transform", [None, (0.5, 0, 10.0, 0, -0.5, 30.0)])
def test_rasterize_bitwise_jax(transform):
    from obia_tpu.geometry import geom as jgeom
    from obia_tpu.geometry.affine import Affine as JAffine
    from obia_tpu.geometry.rasterize import geometry_mask as jmask
    from obia_tpu.geometry.rasterize import rasterize as jrasterize
    from obia_tpu_torch.geometry.affine import Affine
    from obia_tpu_torch.geometry.rasterize import geometry_mask
    tt = Affine(*transform) if transform else None
    jt = JAffine(*transform) if transform else None
    mine, theirs = _shapes(tgeom), _shapes(jgeom)
    got = rasterize([(g, i + 1) for i, g in enumerate(mine)], (42, 64),
                    transform=tt, dtype=np.int32)
    want = jrasterize([(g, i + 1) for i, g in enumerate(theirs)], (42, 64),
                      transform=jt, dtype=np.int32)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 2
    np.testing.assert_array_equal(
        geometry_mask(mine, (42, 64), transform=tt, invert=True),
        jmask(theirs, (42, 64), transform=jt, invert=True))


def _pairs(mod):
    """(a, b) pairs: abutting, nested, corner-touching, crossing, a hole, a
    MultiPolygon, disjoint, equal."""
    P, M, box = mod.Polygon, mod.MultiPolygon, mod.box
    ring = P([(0, 0), (10, 0), (10, 10), (0, 10)],
             [[(3, 3), (7, 3), (7, 7), (3, 7)]])
    return {
        "abutting": (box(0, 0, 2, 2), box(2, 0, 4, 2)),
        "nested": (box(1, 1, 2, 2), box(0, 0, 4, 4)),
        "nested touching": (box(0, 0, 2, 2), box(0, 0, 4, 4)),
        "corner": (box(0, 0, 2, 2), box(2, 2, 4, 4)),
        "crossing": (box(0, 0, 3, 3), box(2, 2, 5, 5)),
        "plus": (box(0, 2, 6, 4), box(2, 0, 4, 6)),
        "in the hole": (box(4, 4, 6, 6), ring),
        "across the hole": (box(2, 4, 8, 6), ring),
        "multipolygon": (M([box(0, 0, 1, 1), box(5, 5, 6, 6)]),
                         box(0.5, 0.5, 5.5, 5.5)),
        "disjoint": (box(0, 0, 1, 1), box(3, 3, 4, 4)),
        "equal": (box(0, 0, 1, 1), box(0, 0, 1, 1)),
        "concave": (box(1, 1, 2, 4),
                    P([(0, 0), (3, 0), (3, 5), (2.5, 5), (2.5, 2),
                       (0.5, 2), (0.5, 5), (0, 5)])),
    }


@pytest.mark.parametrize("name", sorted(_pairs(tgeom)))
def test_predicates_equal_jax(name):
    from obia_tpu.geometry import geom as jgeom
    a, b = _pairs(tgeom)[name]
    ja, jb = _pairs(jgeom)[name]
    for pred in ("within", "contains", "overlaps", "intersects"):
        for (x, y), (jx, jy) in (((a, b), (ja, jb)), ((b, a), (jb, ja))):
            assert getattr(x, pred)(y) == getattr(jx, pred)(jy), (pred, name)


def test_geodataframe_predicates_and_read_file(tmp_path):
    from obia_tpu_torch.vector.geodataframe import GeoDataFrame, read_file
    pairs = _pairs(tgeom)
    gdf = GeoDataFrame({"k": list(range(len(pairs)))},
                       geometry=[a for a, _ in pairs.values()],
                       crs="EPSG:32633")
    tile = tgeom.box(0, 0, 4, 4)
    assert list(gdf.within(tile)) == [g.within(tile) for g in gdf.geometry]
    assert list(gdf.overlaps(tile)) == [g.overlaps(tile)
                                        for g in gdf.geometry]
    path = str(tmp_path / "p.gpkg")
    gdf.to_file(path, layer="pairs")
    back = read_file(path)
    assert list(back["k"]) == list(gdf["k"]) and back.crs == gdf.crs
    # GeoJSON too, as the reference reads and writes it
    gdf.to_file(str(tmp_path / "p.geojson"))
    back = read_file(str(tmp_path / "p.geojson"))
    assert list(back["k"]) == list(gdf["k"]) and back.crs == gdf.crs


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_read_gpkg_of_either_writer(tmp_path, writer):
    from obia_tpu.geometry import geom as jgeom
    from obia_tpu.io import gpkg as jgpkg
    path = str(tmp_path / "x.gpkg")
    mod, io = (jgeom, jgpkg) if writer == "jax" else (tgeom, tgpkg)
    shapes = _shapes(mod) + [mod.Point(3.5, -2.25)]
    cols = [("segment_id", list(range(1, len(shapes) + 1))),
            ("name", [f"s{i}" for i in range(len(shapes))]),
            ("score", [0.5 * i for i in range(len(shapes))])]
    io.write_gpkg(path, cols, shapes, layer="things", crs="EPSG:32610")
    assert tgpkg.list_layers(path) == jgpkg.list_layers(path) == ["things"]
    got_cols, got, crs = tgpkg.read_gpkg(path)
    want_cols, want, jcrs = jgpkg.read_gpkg(path)
    assert got_cols == want_cols == {k: list(v) for k, v in cols}
    assert crs.to_epsg() == jcrs.to_epsg() == 32610
    for g, w in zip(got, want):
        assert g.geom_type == w.geom_type
        if g.geom_type == "Point":
            assert (g.x, g.y) == (w.x, w.y)
        else:
            assert all(np.array_equal(x, y)
                       for x, y in zip(_coords(g), _coords(w)))
    bbox = (0, 0, 31, 28)
    assert len(tgpkg.read_gpkg(path, bbox=bbox)[1]) == len(
        jgpkg.read_gpkg(path, bbox=bbox)[1])
