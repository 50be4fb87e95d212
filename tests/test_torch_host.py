"""The port's own host layer (obia_tpu_torch.geometry/io/vector/native)
against the JAX package's, on the same inputs.

Bars: the native polygoniser's packed rings (labels, point counts, signed
areas, coordinates) and the union-find roots bitwise equal; the ring
grouping gives the same polygons; GeoTIFFs written by the reference's
``write_tiff`` read back to the same arrays, transform, CRS and nodata;
Affine and CRS round-trips equal; a GeoPackage written by the port reads
back through the reference's reader.
"""
import math

import numpy as np
import pytest
import torch

from obia_tpu import native as jnative
from obia_tpu.geometry import polygonize as jpoly
from obia_tpu.geometry.affine import Affine as JAffine
from obia_tpu.geometry.crs import CRS as JCRS
from obia_tpu.io.tiff import TiffReader as JTiffReader
from obia_tpu.io.tiff import write_tiff
from obia_tpu_torch import native
from obia_tpu_torch.geometry import polygonize as tpoly
from obia_tpu_torch.geometry.affine import Affine
from obia_tpu_torch.geometry.crs import CRS
from obia_tpu_torch.io.tiff import TiffReader
from obia_tpu_torch.ops.slic import download_labels_rle


def holes_pinch_borders():
    """Objects on every border, a ring with a hole holding an island, a
    region pinched at a corner, an unlabelled hole, 1-pixel objects."""
    lab = np.zeros((24, 30), np.int32)
    lab[:, 10:20] = 1
    lab[:, 20:] = 2
    lab[16:, :] = 3
    lab[4:12, 22:29] = 4                   # a ring around ...
    lab[6:10, 24:27] = 5                   # ... an island
    lab[7:9, 25] = -1                      # with an unlabelled hole
    lab[2, 2] = lab[3, 3] = 6              # pinched at a corner
    lab[5, 5] = 7
    lab[0, 15] = lab[23, 0] = 8            # one label, two pieces
    return lab


def random_labels(seed, shape=(40, 56), k=9):
    rng = np.random.default_rng(seed)
    blocks = rng.integers(0, k, (-(-shape[0] // 4), -(-shape[1] // 4)))
    lab = np.repeat(np.repeat(blocks, 4, 0), 4, 1)[:shape[0], :shape[1]]
    lab = lab.astype(np.int32)
    lab[rng.random(shape) < 0.08] = -1
    noise = rng.random(shape) < 0.05
    lab[noise] = rng.integers(0, k, int(noise.sum()))
    return lab


RASTERS = {"holes_pinch_borders": holes_pinch_borders,
           "random_a": lambda: random_labels(1),
           "random_b": lambda: random_labels(2, (33, 47), 20)}


def _rle(lab):
    return download_labels_rle(torch.as_tensor(lab))


@pytest.mark.parametrize("simplify", [True, False])
@pytest.mark.parametrize("raster", sorted(RASTERS))
def test_packed_rle_rings_bitwise_equal_reference(raster, simplify):
    values, lengths, shape = _rle(RASTERS[raster]())
    want = jnative.polygonize_rings_rle_packed(values, lengths, shape,
                                               simplify=simplify)
    got = native.polygonize_rings_rle_packed(values, lengths, shape,
                                             simplify=simplify)
    assert want is not None and len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("raster", sorted(RASTERS))
def test_grouped_polygons_equal_reference(raster):
    rlabels, n_pts, areas, coords = native.polygonize_rings_rle_packed(
        *_rle(RASTERS[raster]()))
    offsets = np.concatenate([[0], np.cumsum(n_pts)])
    want = jpoly.group_rings_packed(rlabels, areas, offsets, coords)
    got = tpoly.group_rings_packed(rlabels, areas, offsets, coords)
    assert sorted(got) == sorted(want)
    for label, polys in want.items():
        assert len(got[label]) == len(polys)
        for g, w in zip(got[label], polys):
            np.testing.assert_array_equal(g.exterior.coords_array,
                                          w.exterior.coords_array)
            assert len(g.interiors) == len(w.interiors)
            assert g.area == w.area and g.bounds == w.bounds


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_resolve_components_equal_reference(seed):
    rng = np.random.default_rng(seed)
    comp = rng.integers(-1, 500, (7, 60)).astype(np.int64)
    a = rng.integers(-1, 500, 300)
    b = rng.integers(-1, 500, 300)
    got = native.resolve_components(comp, a, b)
    np.testing.assert_array_equal(got, jnative.resolve_components(comp, a, b))
    assert got.shape == comp.shape and (got[comp < 0] == -1).all()


def test_native_library_is_built_into_build_native():
    path = native.build()
    assert path.parent.name == "native" and path.parent.parent.name == "build"
    assert path.name.startswith("libobia_native_") and path.exists()
    assert native.load() is native.load()


def _compiled_sources():
    from obia_tpu_torch import _build
    return [native.SRC, *_build._sources()]


@pytest.mark.parametrize("source", _compiled_sources(),
                         ids=lambda p: p.name)
def test_every_compiled_source_ships_in_the_wheel(source):
    """A wheel carries a package's files only where
    ``[tool.setuptools.package-data]`` lists them, and the port compiles
    these from beside its modules at first use."""
    import fnmatch
    import tomllib
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    data = tomllib.loads((repo / "pyproject.toml").read_text())
    globs = data["tool"]["setuptools"]["package-data"]
    rel = source.relative_to(repo)
    assert any(
        fnmatch.fnmatch(rel.relative_to(Path(*pkg.split("."))).as_posix(),
                        pattern)
        for pkg, patterns in globs.items()
        if rel.is_relative_to(Path(*pkg.split(".")))
        for pattern in patterns), f"{rel} is in no package-data glob"


TIFFS = {
    "deflate_tiled_u16": dict(dtype=np.uint16, compression="deflate",
                              tiled=True, crs="EPSG:32610"),
    "deflate_striped_f32": dict(dtype=np.float32, compression="deflate",
                                tiled=False, crs="EPSG:4326", nodata=-9999.0),
    "lzw_i16": dict(dtype=np.int16, compression="lzw", tiled=False,
                    crs=3857),
    "packbits_u8_tiled": dict(dtype=np.uint8, compression="packbits",
                              tiled=True, crs=None),
    "none_u8_rgb": dict(dtype=np.uint8, compression="none", tiled=False,
                        crs="EPSG:32633", bands=3),
}


@pytest.mark.parametrize("name", sorted(TIFFS))
def test_tiff_reader_equals_reference(name, tmp_path):
    spec = dict(TIFFS[name])
    dtype, bands = spec.pop("dtype"), spec.pop("bands", 4)
    rng = np.random.default_rng(len(name))
    arr = (rng.random((70, 83, bands)) * 200 - (50 if dtype == np.int16
                                                else 0)).astype(dtype)
    path = str(tmp_path / f"{name}.tif")
    write_tiff(path, arr, transform=JAffine(2, 0, 600000, 0, -2, 5100000),
               tile_size=32, **spec)
    got, want = TiffReader(path), JTiffReader(path)
    np.testing.assert_array_equal(got.read(), want.read())
    np.testing.assert_array_equal(got.read(), arr)
    assert got.read().dtype == want.read().dtype
    assert tuple(got.transform) == tuple(want.transform)
    assert got.nodata == want.nodata == spec.get("nodata")
    if want.crs is None:
        assert got.crs is None
    else:
        assert got.crs.to_epsg() == want.crs.to_epsg()
        assert got.crs.to_wkt() == want.crs.to_wkt()
    np.testing.assert_array_equal(got.read((5, 7, 20, 30)),
                                  want.read((5, 7, 20, 30)))


@pytest.mark.parametrize("dtype,source", [(np.uint8, "path"),
                                          (np.uint16, "path"),
                                          (np.uint8, "bytes")])
def test_uncompressed_strips_are_read_in_place(dtype, source, tmp_path):
    """Uncompressed strips stored back to back (several, at over 1 MB) come
    back as a writable view of the reader's buffer, equal to what was
    written and to the reference's read; a window is still a copy."""
    arr = np.random.default_rng(7).integers(
        0, 1000, (400, 700, 4)).astype(dtype)
    path = str(tmp_path / "flat.tif")
    write_tiff(path, arr, transform=JAffine(1, 0, 0, 0, -1, 400),
               compression="none", tiled=False)
    src = open(path, "rb").read() if source == "bytes" else path
    r = TiffReader(src)
    assert len(r.chunk_offsets) > 1
    got = r.read()
    np.testing.assert_array_equal(got, arr)
    np.testing.assert_array_equal(got, JTiffReader(path).read())
    assert got.flags.writeable
    assert np.shares_memory(got, np.frombuffer(r._buf, np.uint8))
    window = r.read((10, 20, 30, 40))
    np.testing.assert_array_equal(window, arr[10:40, 20:60])
    assert not np.shares_memory(window, got)


AFFINES = [(2, 0, 600000, 0, -2, 5100000), (0.5, 0.1, -3, 0.2, -0.25, 7),
           (1, 0, 0, 0, 1, 0)]


@pytest.mark.parametrize("coeffs", AFFINES)
def test_affine_round_trips_equal_reference(coeffs):
    t, j = Affine(*coeffs), JAffine(*coeffs)
    assert tuple(t) == tuple(j)
    assert tuple(~t) == tuple(~j)
    assert tuple(t * ~t) == tuple(j * ~j)
    assert t * (3.5, -2.0) == j * (3.5, -2.0)
    assert Affine.from_gdal(*t.to_gdal()) == t
    assert t.to_gdal() == j.to_gdal()
    assert t.shapely_order() == j.shapely_order()
    r = Affine.rotation(30.0) * Affine.translation(1, 2) * Affine.scale(2, 3)
    assert tuple(r) == tuple(JAffine.rotation(30.0) * JAffine.translation(
        1, 2) * JAffine.scale(2, 3))
    assert math.isclose((r * ~r).a, 1.0)


@pytest.mark.parametrize("value", ["EPSG:4326", 32633, "32701", "EPSG:3857",
                                   4087, "EPSG:3824", 2154])
def test_crs_round_trips_equal_reference(value):
    t, j = CRS.from_user_input(value), JCRS.from_user_input(value)
    assert t.to_epsg() == j.to_epsg()
    assert t.to_wkt() == j.to_wkt()
    assert t.is_geographic == j.is_geographic
    assert str(t) == str(j) and repr(t) == repr(j)
    back = CRS.from_wkt(t.to_wkt())
    assert back == t and back.to_epsg() == t.to_epsg()
    assert CRS.from_user_input(t) is t and hash(back) == hash(t)


def test_geopackage_written_by_the_port_reads_back_in_the_reference(
        tmp_path):
    from obia_tpu.vector import read_file
    from obia_tpu_torch.geometry.geom import MultiPolygon, Polygon
    from obia_tpu_torch.vector.geodataframe import GeoDataFrame

    sq = Polygon([(0, 0), (2, 0), (2, 2), (0, 2)],
                 [[(0.5, 0.5), (1, 0.5), (1, 1), (0.5, 1)]])
    multi = MultiPolygon([Polygon([(3, 3), (4, 3), (4, 4), (3, 4)]),
                          Polygon([(4, 4), (5, 4), (5, 5), (4, 5)])])
    gdf = GeoDataFrame({"segment_id": [1, 2], "b0_mean": [0.25, np.nan]},
                       geometry=[sq, multi], crs="EPSG:32633")
    path = str(tmp_path / "objects.gpkg")
    gdf.to_file(path)
    back = read_file(path)
    assert list(back["segment_id"]) == [1, 2]
    assert back["b0_mean"][0] == 0.25 and back["b0_mean"].isna()[1]
    assert back.crs.to_epsg() == 32633
    assert [g.area for g in back.geometry] == [sq.area, multi.area]
    assert back.geometry[1].geom_type == "MultiPolygon"
    # the other formats the reference writes, read back by it
    for name, driver in (("objects.geojson", "GeoJSON"),
                         ("objects.shp", "ESRI Shapefile")):
        gdf.to_file(str(tmp_path / name), driver=driver)
        other = read_file(str(tmp_path / name))
        assert list(other["segment_id"]) == [1, 2]
        assert [g.area for g in other.geometry] == [sq.area, multi.area]
    with pytest.raises(ValueError, match="GPKG"):
        gdf.to_file(str(tmp_path / "objects.kml"), driver="KML")
