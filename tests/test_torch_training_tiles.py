"""obia_tpu_torch's ``utils/training.py`` against the JAX package on the
CPU: ``generate_tiles`` and ``tile_and_process`` on the scenes of
tests/test_training_tiles.py.

Bar: every JPEG's bytes, ``annotations.json`` and ``transforms.json`` equal
JAX's, with OpenCV present and with it blocked (the scipy and numpy paths)
in both packages; the step and band checks raise as JAX's do.

One fault of the JAX package shows here and is not copied: it applies the
mask only when the mask file is planar (PlanarConfiguration 2,
``obia_tpu/utils/training.py:149``, ``:218``), so a chunky mask, what its own
``write_tiff`` writes, is read and ignored. The port applies every mask, as
the reference does (training.py:182-230). The mask cases hold the port, on
the chunky file and on the same file marked planar, to JAX on the planar
file, where JAX applies it.
"""
import json
import os
import struct
import sys

import numpy as np
import pytest

from obia_tpu.geometry import Affine, box
from obia_tpu.io.tiff import TiffReader, write_tiff
from obia_tpu.utils import training as jtraining
from obia_tpu.vector import GeoDataFrame
from obia_tpu_torch.utils import training as ttraining


@pytest.fixture(params=["cv2", "no_cv2"])
def cv2_mode(request, monkeypatch):
    """Run with OpenCV, and with it blocked in both packages."""
    if request.param == "no_cv2":
        monkeypatch.setitem(sys.modules, "cv2", None)
    else:
        pytest.importorskip("cv2")
    return request.param


def _planar_copy(src: str, dst: str) -> str:
    """A copy of a one-band little-endian classic TIFF with its
    PlanarConfiguration tag set to 2 (the same bytes for one sample a
    pixel)."""
    data = bytearray(open(src, "rb").read())
    assert data[:4] == b"II*\x00"
    ifd = struct.unpack_from("<I", data, 4)[0]
    n = struct.unpack_from("<H", data, ifd)[0]
    for i in range(n):
        entry = ifd + 2 + 12 * i
        tag, typ, count = struct.unpack_from("<HHI", data, entry)
        if tag == 284:
            assert typ == 3 and count == 1
            struct.pack_into("<H", data, entry + 8, 2)
            break
    else:
        raise AssertionError("no PlanarConfiguration tag")
    with open(dst, "wb") as f:
        f.write(data)
    assert TiffReader(dst).planar == 2
    return dst


@pytest.fixture
def scene(tmp_path):
    """tests/test_training_tiles.py's scene: 120 x 160 x 5 uint8 in EPSG:32633,
    a random 0/1 mask, two boxes in a GeoPackage; plus the mask marked
    planar, a 0/255 version of it, and the boxes in EPSG:4326."""
    rng = np.random.default_rng(42)
    h, w = 120, 160
    arr = (rng.random((h, w, 5)) * 255).astype(np.uint8)
    path = str(tmp_path / "scene.tif")
    t = Affine(1.0, 0, 5000.0, 0, -1.0, 8000.0)
    write_tiff(path, arr, transform=t, crs="EPSG:32633")
    mask = (rng.random((h, w)) > 0.5).astype(np.uint8)
    mask[: h // 3] = 1
    paths = {"raster": path}
    for name, m in (("mask", mask), ("mask255", mask * 255)):
        p = str(tmp_path / f"{name}.tif")
        write_tiff(p, m, transform=t, crs="EPSG:32633")
        paths[name] = p
        paths[f"{name}_planar"] = _planar_copy(
            p, str(tmp_path / f"{name}_planar.tif"))
    boxes = GeoDataFrame(
        {"tree_id": [1, 2, 3]},
        geometry=[box(5010, 7920, 5030, 7950), box(5060, 7900, 5080, 7930),
                  box(5100, 7960, 5125, 7990)],
        crs="EPSG:32633")
    paths["boxes"] = str(tmp_path / "boxes.gpkg")
    boxes.to_file(paths["boxes"])
    paths["boxes4326"] = str(tmp_path / "boxes4326.gpkg")
    boxes.to_crs(4326).to_file(paths["boxes4326"])
    return paths


def _outputs(out_dir):
    files = {}
    for name in sorted(os.listdir(out_dir)):
        with open(os.path.join(out_dir, name), "rb") as f:
            files[name] = f.read()
    return files


def _run_both(tmp_path, tag, jax_kw, port_kw=None, **kw):
    outs = []
    for mod, extra in ((jtraining, jax_kw), (ttraining, port_kw or jax_kw)):
        out_dir = str(tmp_path / f"{tag}_{mod.__name__.split('.')[0]}")
        mod.tile_and_process(output_dir=out_dir, **kw, **extra)
        outs.append(_outputs(out_dir))
    return outs


def _assert_same(want, got):
    assert sorted(got) == sorted(want)
    assert any(n.endswith(".jpg") for n in got)
    for name in want:
        assert got[name] == want[name], name


def test_generate_tiles_equal():
    for args in (((0, 0, 100, 100), 50, 60), ((5000, 7880, 5160, 8000),
                                               40.0, 60.0),
                 ((0.5, -3.0, 77.0, 41.0), 7.5, 10.0)):
        want = list(jtraining.generate_tiles(*args))
        assert list(ttraining.generate_tiles(*args)) == want
    assert list(ttraining.generate_tiles((0, 0, 100, 100), 50, 60))[0] == \
        (0, 0, 60, 60)


@pytest.mark.parametrize("case", ["full", "hard_mask", "no_clahe"])
def test_tile_and_process_with_mask_and_boxes(scene, tmp_path, cv2_mode,
                                              case):
    """Boxes, the mask's blur/darken/blend (feathered or hard), CLAHE or
    min-max rescale: JAX on the planar mask, the port on the chunky mask
    and on the planar one, byte for byte."""
    kw = dict(raster_path=scene["raster"], boxes_gpkg_path=scene["boxes"],
              tile_size=60.0, overlap=20.0, selected_bands=(4, 2, 1))
    opts = {"full": dict(feather_radius=5.0, blur_kernel=5,
                         darken_factor=0.5),
            "hard_mask": dict(feather_radius=0.0, blur_kernel=(3, 5),
                              darken_factor=0.8),
            "no_clahe": dict(feather_radius=3.0, blur_kernel=0,
                             darken_factor=0, apply_clahe_flag=False,
                             rescale=False)}[case]
    kw.update(opts)
    want, got = _run_both(tmp_path, case,
                          dict(mask_path=scene["mask_planar"]),
                          dict(mask_path=scene["mask"]), **kw)
    _assert_same(want, got)
    ann = json.loads(got["annotations.json"])
    assert sum(len(v["boxes"]) for v in ann.values()) >= 2
    tr = json.loads(got["transforms.json"])
    assert tr[next(iter(tr))]["crs"] == "EPSG:32633"
    _, planar = _run_both(tmp_path, case + "_planar",
                          dict(mask_path=scene["mask_planar"]), **kw)
    _assert_same(want, planar)


def test_tile_and_process_no_mask_no_boxes(scene, tmp_path, cv2_mode):
    want, got = _run_both(tmp_path, "plain", {},
                          raster_path=scene["raster"], tile_size=80.0,
                          overlap=0.0, selected_bands=(1, 2, 3),
                          apply_clahe_flag=False, rescale=False)
    _assert_same(want, got)
    assert "annotations.json" not in got


def test_tile_and_process_255_mask(scene, tmp_path, cv2_mode):
    """A 0/255 mask blends as the 0/1 mask does, in both packages."""
    kw = dict(raster_path=scene["raster"], tile_size=80.0, overlap=0.0,
              selected_bands=(1, 2, 3), feather_radius=0.0)
    want, got = _run_both(tmp_path, "m255",
                          dict(mask_path=scene["mask255_planar"]),
                          dict(mask_path=scene["mask255"]), **kw)
    _assert_same(want, got)
    out01 = str(tmp_path / "m01_port")
    ttraining.tile_and_process(output_dir=out01, mask_path=scene["mask"],
                               **kw)
    _assert_same(got, _outputs(out01))


def test_tile_and_process_chunky_mask_is_applied(scene, tmp_path):
    """The port applies a chunky mask (JAX reads it and leaves the tiles
    unmasked): its tiles differ from the unmasked run's."""
    kw = dict(raster_path=scene["raster"], tile_size=80.0, overlap=0.0,
              selected_bands=(1, 2, 3))
    ttraining.tile_and_process(output_dir=str(tmp_path / "masked"),
                               mask_path=scene["mask"], **kw)
    ttraining.tile_and_process(output_dir=str(tmp_path / "plain"), **kw)
    masked, plain = (_outputs(str(tmp_path / d)) for d in ("masked",
                                                           "plain"))
    assert sorted(masked) == sorted(plain)
    assert any(masked[n] != plain[n] for n in masked if n.endswith(".jpg"))


def test_tile_and_process_reprojects_boxes(scene, tmp_path):
    """Boxes in EPSG:4326 over the EPSG:32633 raster: the same files as
    JAX's, and the annotations within a pixel of the native boxes'."""
    kw = dict(raster_path=scene["raster"], tile_size=60.0, overlap=20.0,
              selected_bands=(1, 2, 3), apply_clahe_flag=False)
    want, got = _run_both(tmp_path, "wgs",
                          dict(boxes_gpkg_path=scene["boxes4326"]), **kw)
    _assert_same(want, got)
    _, native = _run_both(tmp_path, "native",
                          dict(boxes_gpkg_path=scene["boxes"]), **kw)
    a, b = (json.loads(x["annotations.json"]) for x in (got, native))
    assert set(a) == set(b) and len(a) >= 1
    for k in a:
        x = np.asarray(a[k]["boxes"], float).reshape(-1)
        y = np.asarray(b[k]["boxes"], float).reshape(-1)
        assert x.shape == y.shape and np.abs(x - y).max() <= 1.0


def test_tile_and_process_validates_step_and_bands(scene, tmp_path):
    for mod in (jtraining, ttraining):
        with pytest.raises(ValueError, match="overlap"):
            mod.tile_and_process(scene["raster"],
                                 output_dir=str(tmp_path / "o1"),
                                 tile_size=50.0, overlap=50.0,
                                 selected_bands=(1, 2, 3))
        with pytest.raises(IndexError, match="1-based"):
            mod.tile_and_process(scene["raster"],
                                 output_dir=str(tmp_path / "o2"),
                                 tile_size=80.0, overlap=0.0,
                                 selected_bands=(0, 1, 2))
        with pytest.raises(IndexError, match="1-based"):
            mod.tile_and_process(scene["raster"],
                                 output_dir=str(tmp_path / "o3"),
                                 tile_size=80.0, overlap=0.0,
                                 selected_bands=(1, 2, 6))
