"""obia_tpu_torch's LAS codec (``io/las.py``), point-cloud statistics
(``ops/pointcloud.py``) and the point-cloud families of ``create_objects``
against the JAX package on the CPU.

Bars: the LAS bytes that ``write_las`` writes equal JAX's, and every array
and the CRS that ``read_las`` returns equal JAX's; point-to-segment
assignment, counts, CH and the NaN positions bitwise; PAI, FHD and the
intensity moments within rtol 1e-12 (float64 sums in another order, and
torch's ``log``).
"""
import struct

import numpy as np
import pytest
import torch

from obia_tpu.geometry.affine import Affine as JAffine
from obia_tpu.io import las as jlas
from obia_tpu.ops import pointcloud as jpc
from obia_tpu.segmentation import segment_statistics as jss
from obia_tpu_torch.geometry.affine import Affine
from obia_tpu_torch.io import las as tlas
from obia_tpu_torch.ops import pointcloud as tpc
from obia_tpu_torch.segmentation import segment_statistics as tss

_t = torch.as_tensor
PC_COLUMNS = ("pai", "fhd", "ch", "mean_intensity", "variance_intensity")


def _cloud(rng, n=500):
    return {
        "X": 500000.0 + rng.uniform(0, 100, n),
        "Y": 4000000.0 - rng.uniform(0, 100, n),
        "Z": rng.uniform(0, 40, n),
        "Intensity": rng.integers(0, 4096, n).astype(np.uint16),
        "classification": rng.integers(0, 10, n).astype(np.uint8),
        "gps_time": rng.uniform(3.0e8, 3.1e8, n),
        "red": rng.integers(0, 65536, n).astype(np.uint16),
        "green": rng.integers(0, 65536, n).astype(np.uint16),
        "blue": rng.integers(0, 65536, n).astype(np.uint16),
        "nir": rng.integers(0, 65536, n).astype(np.uint16),
        "return_number": rng.integers(1, 4, n).astype(np.uint8),
        "number_of_returns": np.full(n, 3, np.uint8),
        "scan_angle": rng.integers(-20, 20, n).astype(np.int8),
        "point_source_id": rng.integers(0, 100, n).astype(np.uint16),
    }


def assert_same_las(got, want):
    assert type(got).__name__ == "LasData" and got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (got.point_format, got.version, got.scales, got.offsets) == (
        want.point_format, want.version, want.scales, want.offsets)
    if want.crs is None:
        assert got.crs is None
    else:
        assert got.crs.to_epsg() == want.crs.to_epsg()
        assert got.crs.to_wkt() == want.crs.to_wkt()


# -- the LAS codec ------------------------------------------------------------

@pytest.mark.parametrize("crs", ["EPSG:32610", "EPSG:4326", None])
@pytest.mark.parametrize("fmt", [0, 1, 2, 3, 6, 7, 8])
def test_las_bytes_and_arrays_match_jax(tmp_path, fmt, crs):
    pc = _cloud(np.random.default_rng(fmt))
    port, jax = tmp_path / "port.las", tmp_path / "jax.las"
    tlas.write_las(port, pc, point_format=fmt, crs=crs)
    jlas.write_las(jax, pc, point_format=fmt, crs=crs)
    assert port.read_bytes() == jax.read_bytes()
    back = tlas.read_las(port)
    assert_same_las(back, jlas.read_las(jax))
    for ax in "XYZ":
        np.testing.assert_allclose(back[ax], pc[ax], atol=5.1e-4)


def _edit(path, edit):
    buf = bytearray(path.read_bytes())
    edit(buf)
    path.write_bytes(bytes(buf))


def _extra_bytes(path):
    buf = bytearray(path.read_bytes())
    point_offset, = struct.unpack_from("<I", buf, 96)
    rec_len, = struct.unpack_from("<H", buf, 105)
    body = bytes(buf[point_offset:])
    padded = b"".join(body[i:i + rec_len] + b"\xAA" * 4
                      for i in range(0, len(body), rec_len))
    struct.pack_into("<H", buf, 105, rec_len + 4)
    path.write_bytes(bytes(buf[:point_offset]) + padded)


def _truncate(path):
    buf = path.read_bytes()
    point_offset, = struct.unpack_from("<I", buf, 96)
    rec_len, = struct.unpack_from("<H", buf, 105)
    path.write_bytes(buf[:point_offset + 10 * rec_len])


@pytest.mark.parametrize("case", ["scale_offset", "extra_bytes",
                                  "u64_count", "truncated"])
def test_las_read_cases_match_jax(tmp_path, case):
    """JAX's test_las.py cases: the scale and offset applied, records with
    extra bytes, LAS 1.4's u64 count, a truncated file's clamped count."""
    rng = np.random.default_rng(7)
    path = tmp_path / "x.las"
    if case == "scale_offset":
        pc = {"X": np.array([10.0, 10.25]), "Y": np.array([20.0, 20.25]),
              "Z": np.array([1.0, 1.25])}
        tlas.write_las(path, pc, point_format=0, scale=(0.25, 0.25, 0.25),
                       offset=(10.0, 20.0, 1.0))
    else:
        tlas.write_las(path, _cloud(rng, 77),
                       point_format=6 if case == "u64_count" else 1)
    if case == "extra_bytes":
        _extra_bytes(path)
    if case == "truncated":
        _truncate(path)
    got = tlas.read_las(path)
    assert_same_las(got, jlas.read_las(path))
    n = {"scale_offset": 2, "truncated": 10}.get(case, 77)
    assert got["X"].size == n


@pytest.mark.parametrize("case", ["laz", "not_las", "classification"])
def test_las_refusals_match_jax(tmp_path, case):
    path = tmp_path / "x.las"
    pc = _cloud(np.random.default_rng(1), 5)
    if case == "classification":
        pc["classification"] = np.array([1, 2, 3, 45, 0], np.uint8)
        for codec in (tlas, jlas):
            with pytest.raises(ValueError, match="5-bit"):
                codec.write_las(path, pc, point_format=3)
        tlas.write_las(path, pc, point_format=6)
        assert tlas.read_las(path)["classification"].tolist() == \
            [1, 2, 3, 45, 0]
        return
    if case == "laz":
        tlas.write_las(path, pc, point_format=1)
        _edit(path, lambda b: b.__setitem__(104, b[104] | 0x80))
        match = "LAZ"
    else:
        path.write_bytes(b"NOPE" + b"\x00" * 300)
        match = "signature"
    for codec in (tlas, jlas):
        with pytest.raises(ValueError, match=match):
            codec.read_las(path)


# -- point-cloud statistics ---------------------------------------------------

def test_pointcloud_stats_exact():
    """JAX's hand-computed case: PAI, FHD, CH and the intensity moments of
    two segments."""
    labels = np.zeros((4, 4), np.int32)
    labels[:, 2:] = 1
    pts = {"X": np.array([0.5, 1.5, 0.5, 1.5, 2.5, 3.5, 2.5]),
           "Y": np.array([3.5, 3.5, 2.5, 2.5, 3.5, 3.5, 2.5]),
           "Z": np.array([0.2, 0.8, 3.7, 1.7, 0.1, 0.4, 0.9]),
           "Intensity": np.array([10.0, 20.0, 30.0, 40.0, 5.0, 5.0, 5.0])}
    got = tpc.segment_pointcloud_stats(
        pts, _t(labels), Affine(1.0, 0, 0.0, 0, -1.0, 4.0), 2,
        voxel_resolution=1.0)
    want = jpc.segment_pointcloud_stats(
        pts, labels, JAffine(1.0, 0, 0.0, 0, -1.0, 4.0), 2,
        voxel_resolution=1.0)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)
    np.testing.assert_array_equal(got["ch"], [3.7, 0.9])
    p0 = np.array([0.5, 0.25, 0.25])
    np.testing.assert_allclose(got["fhd"], [-(p0 * np.log(p0)).sum(), 0.0])
    np.testing.assert_allclose(got["pai"], [np.log(2.0), 0.0])


def _labels_and_cloud(seed, n=4000, k=30, nan_z=False, structured=False):
    """A 40 x 56 label raster (-1 holes, k labels, some absent) and a cloud
    over and beyond it, with points on pixel edges and corners."""
    rng = np.random.default_rng(seed)
    lab = rng.integers(-1, k, (40, 56)).astype(np.int32)
    lab[lab == 7] = 8
    t = (0.5, 0, 300000.0, 0, -0.5, 5000020.0)
    x = 300000.0 + rng.uniform(-2, 30, n)
    y = 5000020.0 - rng.uniform(-2, 22, n)
    x[:200] = 300000.0 + 0.5 * rng.integers(0, 57, 200)  # on column edges
    y[100:300] = 5000020.0 - 0.5 * rng.integers(0, 41, 200)  # on row edges
    z = np.where(rng.random(n) < 0.3, rng.uniform(0, 1, n),
                 rng.uniform(1, 30, n))
    if nan_z:
        z[[5, 900]] = np.nan
    pts = {"X": x, "Y": y, "Z": z,
           "Intensity": rng.integers(0, 65536, n).astype(np.uint16)}
    if structured:
        arr = np.zeros(n, [("X", "f8"), ("Y", "f8"), ("Z", "f8"),
                           ("Intensity", "u2")])
        for name in arr.dtype.names:
            arr[name] = pts[name]
        pts = arr
    return lab, t, pts, k


@pytest.mark.parametrize("seed,structured", [(0, False), (1, True),
                                             (2, False)])
@pytest.mark.parametrize("dz", [1.0, 0.37])
def test_pointcloud_stats_match_jax(seed, structured, dz):
    lab, t, pts, k = _labels_and_cloud(seed, structured=structured)
    seg, keep = tpc.assign_points_to_segments(pts, _t(lab), Affine(*t))
    jseg, jkeep = jpc.assign_points_to_segments(pts, lab, JAffine(*t))
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    np.testing.assert_array_equal(seg.numpy(), jseg)
    got = tpc.segment_pointcloud_stats(pts, _t(lab), Affine(*t), k,
                                       voxel_resolution=dz)
    want = jpc.segment_pointcloud_stats(pts, lab, JAffine(*t), k,
                                        voxel_resolution=dz)
    assert got.keys() == want.keys() == set(PC_COLUMNS)
    np.testing.assert_array_equal(got["ch"], want["ch"])
    for c in PC_COLUMNS:
        np.testing.assert_array_equal(np.isnan(got[c]), np.isnan(want[c]))
        np.testing.assert_allclose(got[c], want[c], rtol=1e-12, atol=0,
                                   err_msg=c)
    assert np.isnan(got["ch"][7]) and np.isfinite(got["ch"]).sum() > 20


def test_pointcloud_nan_z_matches_jax():
    """A NaN Z makes its segment's CH NaN and its returns not ground, as
    ``np.maximum.at`` and ``np.minimum.at`` leave them in JAX; FHD raises
    in both packages."""
    lab, t, pts, k = _labels_and_cloud(3, nan_z=True)
    kw = dict(voxel_resolution=1.0, calc_fhd=False)
    got = tpc.segment_pointcloud_stats(pts, _t(lab), Affine(*t), k, **kw)
    with np.errstate(invalid="ignore"):
        want = jpc.segment_pointcloud_stats(pts, lab, JAffine(*t), k, **kw)
    for c in ("ch", "pai", "mean_intensity", "variance_intensity"):
        np.testing.assert_array_equal(np.isnan(got[c]), np.isnan(want[c]))
        np.testing.assert_allclose(got[c], want[c], rtol=1e-12, err_msg=c)
    assert np.isnan(got["ch"]).sum() > np.isnan(
        tpc.segment_pointcloud_stats(
            _labels_and_cloud(3)[2], _t(lab), Affine(*t), k,
            **kw)["ch"]).sum()
    with pytest.raises(IndexError):
        tpc.segment_pointcloud_stats(pts, _t(lab), Affine(*t), k,
                                     voxel_resolution=1.0)
    with pytest.raises(IndexError), np.errstate(invalid="ignore"):
        jpc.segment_pointcloud_stats(pts, lab, JAffine(*t), k,
                                     voxel_resolution=1.0)


def test_pointcloud_outside_and_empty():
    labels = np.zeros((2, 2), np.int32)
    pts = {"X": np.array([10.0]), "Y": np.array([10.0]),
           "Z": np.array([1.0])}
    got = tpc.segment_pointcloud_stats(pts, _t(labels),
                                       Affine(1.0, 0, 0.0, 0, -1.0, 2.0), 2,
                                       voxel_resolution=1.0)
    want = jpc.segment_pointcloud_stats(pts, labels,
                                        JAffine(1.0, 0, 0.0, 0, -1.0, 2.0),
                                        2, voxel_resolution=1.0)
    assert got.keys() == want.keys()
    for k in want:
        assert np.isnan(got[k]).all() and np.isnan(want[k]).all(), k
    with pytest.raises(ValueError, match="voxel_resolution"):
        tpc.segment_pointcloud_stats(pts, _t(labels),
                                     Affine(1.0, 0, 0.0, 0, -1.0, 2.0), 2)


@pytest.mark.parametrize("z", [[0.1, 0.2, 2.5, 2.6], [], [3.0]])
def test_single_object_structural_and_radiometric(z):
    pc = {"Z": np.array(z), "Intensity": np.arange(len(z), dtype=np.uint16)}
    for fn, args in (("calculate_structural_stats", (1.0,)),
                     ("calculate_radiometric_stats", ())):
        got = getattr(tss, fn)(pc, *args)
        want = getattr(jss, fn)(pc, *args)
        assert got.keys() == want.keys()
        np.testing.assert_array_equal(list(got.values()),
                                      list(want.values()))
    assert np.isnan(list(tss.calculate_radiometric_stats(
        {"Z": np.ones(2)}).values())).all()


# -- create_objects with a cloud ----------------------------------------------

@pytest.fixture(scope="module")
def layers():
    """(JAX image, JAX segments, port layer) of one label raster, and a
    cloud over the image in its CRS."""
    from bench import build_scene
    from obia_tpu.handlers.geotif import image_from_array
    from obia_tpu.segmentation.segment_boundaries import create_segments \
        as jax_create_segments
    from obia_tpu_torch.segmentation.segment_boundaries import \
        create_segments
    image = image_from_array(build_scene(h=48, w=64, c=3),
                             JAffine(2.0, 0, 500000.0, 0, -2.0, 4000000.0),
                             crs="EPSG:32610")
    rng = np.random.default_rng(0)
    n = 3000
    pc = {"X": 500000.0 + rng.uniform(0, 128, n),
          "Y": 4000000.0 - rng.uniform(0, 96, n),
          "Z": np.where(rng.random(n) < 0.3, rng.uniform(0, 1, n),
                        rng.uniform(1, 30, n)),
          "Intensity": rng.integers(0, 4096, n).astype(np.uint16)}
    return (image, jax_create_segments(image, n_segments=9),
            create_segments(image, n_segments=9, device="cpu"), pc)


@pytest.mark.parametrize("source", ["dict", "structured", "las"])
def test_create_objects_with_a_cloud_matches_jax(layers, source, tmp_path):
    image, jsegs, layer, pc = layers
    cloud = pc
    if source == "structured":
        cloud = np.zeros(len(pc["X"]), [("X", "f8"), ("Y", "f8"),
                                        ("Z", "f8"), ("Intensity", "u2")])
        for name in cloud.dtype.names:
            cloud[name] = pc[name]
    elif source == "las":
        cloud = str(tmp_path / "pts.las")
        tlas.write_las(cloud, pc, point_format=1, crs="EPSG:32610")
    kw = dict(calculate_structural=True, calculate_radiometric=True,
              voxel_resolution=1.0, calculate_textural=False)
    got = tss.create_objects(layer, image, pointcloud=cloud, **kw)
    want = jss.create_objects(jsegs, image, pointcloud=cloud, **kw)
    np.testing.assert_array_equal(got["ch"], want["ch"].to_numpy())
    for c in PC_COLUMNS:
        np.testing.assert_allclose(got[c], want[c].to_numpy(), rtol=1e-12,
                                   err_msg=c)
        assert np.isfinite(got[c]).any(), c
    if source == "las":
        # the LAS round trip quantises to mm: equal to the dict input's
        # stats of the quantised points
        back = tss.create_objects(layer, image, pointcloud=tlas.read_las(
            cloud), **kw)
        for c in PC_COLUMNS:
            np.testing.assert_array_equal(got[c], back[c])


def test_create_objects_cloud_families_and_refusals(layers, tmp_path):
    image, _, layer, pc = layers
    only_ch = tss.create_objects(layer, image, pointcloud=pc,
                                 calculate_structural=True, calc_pai=False,
                                 calc_fhd=False, calculate_textural=False)
    assert "pai" not in only_ch.columns and np.isfinite(only_ch["ch"]).any()
    assert np.isnan(only_ch["mean_intensity"]).all()
    with pytest.raises(NotImplementedError):
        tss.create_objects(layer, image, calculate_structural=True)
    with pytest.raises(NotImplementedError):
        tss.create_objects(layer, image, ept="tile.json")
    wrong = str(tmp_path / "wrong_crs.las")
    tlas.write_las(wrong, pc, point_format=1, crs="EPSG:4326")
    with pytest.warns(UserWarning, match="reproject"):
        tss.create_objects(layer, image, calculate_spectral=False,
                           calculate_textural=False,
                           calculate_structural=True, pointcloud=wrong,
                           voxel_resolution=1.0)
