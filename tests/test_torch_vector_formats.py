"""The port's vector formats and reprojection against the JAX package:
``transform_crs`` bitwise, GeoJSON and shapefile files byte for byte equal
for the same table and read back by either package, ``GeoDataFrame``
``to_file``/``read_file``/``to_crs``/``bounds`` equal, the pandas-free
``Features`` reader equal to ``read_file``, and a table with a None
geometry refused by both packages in every format."""
import os

import numpy as np
import pytest

from obia_tpu.geometry import geom as jgeom
from obia_tpu.geometry import transform_crs as jtc
from obia_tpu.geometry import wkb as jwkb
from obia_tpu.io import geojson as jgeojson
from obia_tpu.io import shapefile as jshp
from obia_tpu.vector import geodataframe as jgdf
from obia_tpu_torch.geometry import geom as tgeom
from obia_tpu_torch.geometry import transform_crs as ttc
from obia_tpu_torch.geometry import wkb as twkb
from obia_tpu_torch.geometry.crs import CRS
from obia_tpu_torch.io import geojson as tgeojson
from obia_tpu_torch.io import shapefile as tshp
from obia_tpu_torch.vector import features as tfeatures
from obia_tpu_torch.vector import geodataframe as tgdf

X0, Y0 = 500000.0, 5100000.0


def _shapes(g, kind: str, k: int):
    """One geometry of ``kind`` built with the geometry module ``g``."""
    x, y = X0 + 13.5 * k, Y0 - 7.25 * k
    ring = [(x, y), (x + 10, y), (x + 10, y + 8), (x, y + 8), (x, y)]
    hole = [(x + 2, y + 2), (x + 4, y + 2), (x + 4, y + 4), (x + 2, y + 4),
            (x + 2, y + 2)]
    if kind == "Point":
        return g.Point(x + 0.5, y + 0.25)
    if kind == "LineString":
        return g.LineString([(x, y), (x + 3.5, y + 1), (x + 7, y - 2)])
    if kind == "Polygon":
        return g.Polygon(ring, [hole] if k % 2 else [])
    return g.MultiPolygon([g.Polygon(ring), g.Polygon(
        [(px + 20, py) for px, py in ring], [[(px + 20, py)
                                              for px, py in hole]])])


def _table(g, kind: str, n: int = 6):
    cols = [("id", list(range(n))),
            ("name", [f"tree {i}" if i % 3 else None for i in range(n)]),
            ("height", [1.5 * i if i != 2 else float("nan")
                        for i in range(n)]),
            ("alive", [bool(i % 2) for i in range(n)]),
            ("count", [np.int64(7 * i) for i in range(n)])]
    return cols, [_shapes(g, kind, k) for k in range(n)]


KINDS = ["Point", "LineString", "Polygon", "MultiPolygon"]


def test_utm_and_webmercator_bitwise():
    rng = np.random.default_rng(0)
    lon = rng.uniform(12.0, 18.0, 500)
    lat = rng.uniform(-60.0, 70.0, 500)
    for zone, north in ((33, True), (33, False), (1, True), (60, False)):
        want = jtc.utm_forward(lon, lat, zone, north)
        got = ttc.utm_forward(lon, lat, zone, north)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(ttc.utm_inverse(*got, zone, north),
                                      jtc.utm_inverse(*want, zone, north))
    np.testing.assert_array_equal(ttc.webmercator_forward(lon, lat),
                                  jtc.webmercator_forward(lon, lat))
    wm = jtc.webmercator_forward(lon, lat)
    np.testing.assert_array_equal(ttc.webmercator_inverse(*wm),
                                  jtc.webmercator_inverse(*wm))


@pytest.mark.parametrize("src,dst", [(4326, 32633), (32633, 4326),
                                     (32633, 32634), (32733, 3857),
                                     (3857, 4326), (32633, 32633)])
def test_transformer_and_geometries_bitwise(src, dst):
    rng = np.random.default_rng(src + dst)
    if src == 4326:
        x, y = rng.uniform(13, 17, 50), rng.uniform(40, 50, 50)
    elif src == 3857:
        x, y = rng.uniform(1.4e6, 1.9e6, 50), rng.uniform(5e6, 6e6, 50)
    else:
        x, y = rng.uniform(4e5, 6e5, 50), rng.uniform(4.9e6, 5.2e6, 50)
    jt = jtc.Transformer.from_crs(src, dst, always_xy=True)
    tt = ttc.Transformer.from_crs(src, dst, always_xy=True)
    np.testing.assert_array_equal(tt.transform(x, y), jt.transform(x, y))
    assert tt.transform(float(x[0]), float(y[0])) == jt.transform(
        float(x[0]), float(y[0]))
    if src != 4326:
        for kind in KINDS:
            got = ttc.transform_geom(_shapes(tgeom, kind, 1), tt)
            want = jtc.transform_geom(_shapes(jgeom, kind, 1), jt)
            assert twkb.dumps(got) == jwkb.dumps(want)


def test_unsupported_crs_raises_in_both():
    for mod in (jtc, ttc):
        with pytest.raises(mod.CRSTransformError):
            mod.Transformer.from_crs(4326, 2056, always_xy=True)
        with pytest.raises(mod.CRSTransformError):
            mod.Transformer.from_crs(4326, 32633, always_xy=False)


@pytest.mark.parametrize("kind", KINDS)
def test_wkb_bytes_equal(kind):
    got = twkb.dumps(_shapes(tgeom, kind, 3))
    assert got == jwkb.dumps(_shapes(jgeom, kind, 3))
    assert twkb.dumps(twkb.loads(got)) == got


@pytest.mark.parametrize("kind", KINDS)
def test_geojson_bytes_equal_and_cross_read(kind, tmp_path):
    mine = str(tmp_path / "port.geojson")
    theirs = str(tmp_path / "jax.geojson")
    cols, geoms = _table(tgeom, kind)
    tgeojson.write_geojson(mine, cols, geoms, crs=CRS.from_epsg(32633))
    jcols, jgeoms = _table(jgeom, kind)
    from obia_tpu.geometry.crs import CRS as JCRS
    jgeojson.write_geojson(theirs, jcols, jgeoms, crs=JCRS.from_epsg(32633))
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    c1, g1, crs1 = tgeojson.read_geojson(theirs)
    c2, g2, crs2 = jgeojson.read_geojson(mine)
    assert c1 == c2 and crs1.to_epsg() == crs2.to_epsg() == 32633
    assert [twkb.dumps(g) for g in g1] == [jwkb.dumps(g) for g in g2]


@pytest.mark.parametrize("kind", KINDS)
def test_shapefile_bytes_equal_and_cross_read(kind, tmp_path):
    from obia_tpu.geometry.crs import CRS as JCRS
    cols, geoms = _table(tgeom, kind)
    tshp.write_shapefile(str(tmp_path / "port.shp"), cols, geoms,
                         crs=CRS.from_epsg(32633))
    jcols, jgeoms = _table(jgeom, kind)
    jshp.write_shapefile(str(tmp_path / "jax.shp"), jcols, jgeoms,
                         crs=JCRS.from_epsg(32633))
    for ext in (".shp", ".shx", ".dbf", ".prj"):
        with open(tmp_path / f"port{ext}", "rb") as a, \
                open(tmp_path / f"jax{ext}", "rb") as b:
            assert a.read() == b.read(), ext
    c1, g1, crs1 = tshp.read_shapefile(str(tmp_path / "jax.shp"))
    c2, g2, crs2 = jshp.read_shapefile(str(tmp_path / "port.shp"))
    assert c1 == c2 and crs1.to_epsg() == crs2.to_epsg() == 32633
    assert [twkb.dumps(g) for g in g1] == [jwkb.dumps(g) for g in g2]


def test_shapefile_errors_match(tmp_path):
    for g, mod in ((tgeom, tshp), (jgeom, jshp)):
        mixed = [_shapes(g, "Point", 0), _shapes(g, "Polygon", 1)]
        with pytest.raises(ValueError, match="ONE shape type"):
            mod.write_shapefile(str(tmp_path / "m.shp"), [("a", [1, 2])],
                                mixed)
    (tmp_path / "bad.shp").write_bytes(b"\0" * 120)
    for mod in (tshp, jshp):
        with pytest.raises(ValueError, match="not a shapefile"):
            mod.read_shapefile(str(tmp_path / "bad.shp"))


def _frames(kind):
    cols, geoms = _table(tgeom, kind)
    jcols, jgeoms = _table(jgeom, kind)
    return (tgdf.GeoDataFrame(dict(cols), geometry=geoms, crs="EPSG:32633"),
            jgdf.GeoDataFrame(dict(jcols), geometry=jgeoms, crs="EPSG:32633"))


def _same_frames(a, b):
    assert list(a.columns) == list(b.columns) and len(a) == len(b)
    for c in a.columns:
        if c == "geometry":
            assert [twkb.dumps(g) if g is not None else None
                    for g in a.geometry] == [jwkb.dumps(g) if g is not None
                                             else None for g in b.geometry]
        else:
            assert a[c].tolist() == b[c].tolist() or np.array_equal(
                a[c].to_numpy(), b[c].to_numpy(), equal_nan=True)


@pytest.mark.parametrize("ext", [".gpkg", ".geojson", ".json", ".shp"])
def test_geodataframe_files_equal_jax(ext, tmp_path):
    mine, theirs = _frames("Polygon")
    p_mine, p_theirs = str(tmp_path / f"t{ext}"), str(tmp_path / f"j{ext}")
    mine.to_file(p_mine)
    theirs.to_file(p_theirs)
    if ext != ".gpkg":   # a GeoPackage stamps its write time
        with open(p_mine, "rb") as a, open(p_theirs, "rb") as b:
            assert a.read() == b.read()
    # each package reads the other's file; the port's table reader agrees
    _same_frames(tgdf.read_file(p_theirs), jgdf.read_file(p_mine))
    table = tfeatures.read_features(p_theirs)
    back = tgdf.read_file(p_theirs)
    assert list(table.columns) == [c for c in back.columns
                                   if c != "geometry"]
    assert table.crs == back.crs and len(table) == len(back)


@pytest.mark.parametrize("ext", [".geojson", ".shp"])
def test_read_file_bbox_keeps_none_geometries(ext, tmp_path):
    cols = [("id", [0, 1, 2])]
    geoms = [tgeom.Point(X0, Y0), None, tgeom.Point(X0 + 100, Y0)]
    path = str(tmp_path / f"n{ext}")
    (tgeojson.write_geojson if ext == ".geojson"
     else tshp.write_shapefile)(path, cols, geoms, crs=CRS.from_epsg(32633))
    bbox = (X0 - 1, Y0 - 1, X0 + 1, Y0 + 1)
    got, want = tgdf.read_file(path, bbox=bbox), jgdf.read_file(path,
                                                                bbox=bbox)
    assert got["id"].tolist() == want["id"].tolist() == [0, 1]
    assert got.geometry.iloc[1] is None


@pytest.mark.parametrize("driver", ["GPKG", "GeoJSON", "ESRI Shapefile"])
def test_none_geometry_refused_by_both(driver, tmp_path):
    ext = {"GPKG": "gpkg", "GeoJSON": "geojson", "ESRI Shapefile": "shp"}
    for mod, g in ((tgdf, tgeom), (jgdf, jgeom)):
        gdf = mod.GeoDataFrame({"a": [1, 2]}, geometry=[g.Point(0, 0), None],
                               crs="EPSG:32633")
        path = str(tmp_path / f"{mod.__name__.split('.')[0]}.{ext[driver]}")
        with pytest.raises(ValueError, match="None geometries"):
            gdf.to_file(path, driver=driver)
        assert not os.path.exists(path)
    with pytest.raises(ValueError, match="None geometries"):
        tfeatures.write_features(str(tmp_path / "f.gpkg"), [("a", [1])],
                                 [None])


def test_unknown_driver_refused_by_both(tmp_path):
    for mod in (tgdf, jgdf):
        gdf = _frames("Point")[0 if mod is tgdf else 1]
        with pytest.raises(ValueError, match="supported"):
            gdf.to_file(str(tmp_path / "x.kml"), driver="KML")


def test_to_crs_and_bounds_equal_jax():
    mine, theirs = _frames("MultiPolygon")
    for dst in (4326, "EPSG:32634", 3857, 32633):
        _same_frames(mine.to_crs(dst), theirs.to_crs(dst))
        assert (mine.to_crs(dst).crs.to_epsg()
                == theirs.to_crs(dst).crs.to_epsg())
    np.testing.assert_array_equal(mine.total_bounds, theirs.total_bounds)
    assert mine.bounds.equals(theirs.bounds)
    table = tfeatures.Features({"id": list(range(len(mine)))},
                               list(mine.geometry), "EPSG:32633")
    np.testing.assert_array_equal(table.total_bounds, mine.total_bounds)
    back = table.to_crs(4326)
    assert [twkb.dumps(g) for g in back.geometry] == [
        jwkb.dumps(g) for g in theirs.to_crs(4326).geometry]
    for mod, gdf in ((tgdf, mine), (jgdf, theirs)):
        bare = mod.GeoDataFrame({"a": [1]}, geometry=[gdf.geometry.iloc[0]])
        with pytest.raises(ValueError, match="no source CRS"):
            bare.to_crs(4326)


def test_to_raster_crs_takes_frames_and_tables():
    mine, theirs = _frames("Polygon")
    table = tfeatures.Features({"id": list(range(len(mine)))},
                               list(mine.geometry), "EPSG:32633")
    want = jtc.to_raster_crs(theirs.to_crs(4326), 32633)
    for obj in (mine.to_crs(4326), table.to_crs(4326)):
        got = ttc.to_raster_crs(obj, 32633)
        assert [twkb.dumps(g) for g in got.geometry] == [
            jwkb.dumps(g) for g in want.geometry]
    assert ttc.to_raster_crs(table, "EPSG:32633") is table
    assert ttc.to_raster_crs(table, None) is table
