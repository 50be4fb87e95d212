"""The reference's public API that obia_tpu_torch ports beside its main
path, against the JAX package on the CPU: ``Image.to_image`` and
``rasterio_obj``, ``_write_geotiff``, ``open_binary_geotiff_as_mask``,
``boundary_mask`` and ``Segments.to_segmented_image``, the
skimage-compatible ``ops.slic.slic``, ``telemetry.timed``/``is_enabled``/
``trace``, and the top-level and ``geometry`` exports.

Bars: images, masks, files and labels equal to JAX's. One ``slic()`` case
(the masked scene) differs in one pixel: a k-means tie that the port's
float64 centre sums settle the other way (``test_torch_slic.py`` holds
SLIC to JAX as partitions for that reason); there the labels are held
equal outside pixels whose label is one of their 4-neighbours' in the
other package, at most 0.05% of the pixels.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from obia_tpu.geometry.affine import Affine as JAffine
from obia_tpu.handlers import geotif as jgeotif
from obia_tpu_torch.handlers import geotif as tgeotif

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def images():
    data = np.random.default_rng(42).random((32, 32, 4)).astype(np.float32)
    return (tgeotif.image_from_array(data, JAffine(1, 0, 0, 0, -1, 32),
                                     crs=4326),
            jgeotif.image_from_array(data, JAffine(1, 0, 0, 0, -1, 32),
                                     crs=4326))


@pytest.mark.parametrize("stretch", [None, "histogram_equalization",
                                     "clahe"])
def test_to_image_matches_jax(images, stretch):
    port, jax = images
    got = port.to_image([2, 0, 1], p_min=5, stretch_type=stretch)
    want = jax.to_image([2, 0, 1], p_min=5, stretch_type=stretch)
    assert got.size == want.size == (32, 32) and got.mode == want.mode
    np.testing.assert_array_equal(np.array(got), np.array(want))


def test_to_image_refusals_and_rasterio_obj(images, tmp_path):
    port, _ = images
    with pytest.raises(ValueError):
        port.to_image([0, 1])
    with pytest.raises(IndexError):
        port.to_image([0, 1, 99])
    with pytest.raises(ValueError):
        port.to_image([0, 1, 2], stretch_type="bogus")
    assert port.rasterio_obj is None and port.reader is None
    path = str(tmp_path / "scene.tif")
    tgeotif.write_tiff(path, (port.img_data * 255).astype(np.uint8),
                       transform=JAffine(1, 0, 0, 0, -1, 32), crs=4326)
    opened = tgeotif.open_geotiff(path)
    assert opened.rasterio_obj is opened.reader is not None
    opened.rasterio_obj = None
    assert opened.reader is None
    again = tgeotif.Image(opened.img_data, opened.crs,
                          opened.affine_transformation, opened.transform,
                          rasterio_obj="handle")
    assert again.reader == "handle"


@pytest.mark.parametrize("kind", ["pil", "band_first", "band_last"])
def test_write_geotiff_bytes_match_jax(tmp_path, kind, capsys):
    from PIL.Image import fromarray
    arr = (np.random.default_rng(1).random((12, 20, 3)) * 255).astype(
        np.uint8)
    src = {"pil": fromarray(arr), "band_first": np.moveaxis(arr, 2, 0),
           "band_last": arr}[kind]
    t = JAffine(2, 0, 600000, 0, -2, 5100000)
    tgeotif._write_geotiff(src, str(tmp_path / "port.tif"), "EPSG:32610", t)
    jgeotif._write_geotiff(src, str(tmp_path / "jax.tif"), "EPSG:32610", t)
    assert (tmp_path / "port.tif").read_bytes() == \
        (tmp_path / "jax.tif").read_bytes()
    assert "Done Writing GeoTIFF" in capsys.readouterr().out


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_open_binary_geotiff_as_mask_matches_jax(tmp_path, dtype):
    arr = (np.random.default_rng(2).random((10, 14)) > 0.5).astype(dtype)
    path = str(tmp_path / "mask.tif")
    tgeotif.write_tiff(path, arr, transform=JAffine(3, 0, 100, 0, -3, 900),
                       crs="EPSG:32633", nodata=0)
    got = tgeotif.open_binary_geotiff_as_mask(path)
    want = jgeotif.open_binary_geotiff_as_mask(path)
    assert len(got) == len(want) == 4
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == bool
    assert got[1] == want[1] == (100.0, 870.0, 142.0, 900.0)
    assert tuple(got[2])[:6] == tuple(want[2])[:6]
    assert got[3].keys() == want[3].keys()
    for k in ("width", "height", "count", "dtype", "nodata"):
        assert got[3][k] == want[3][k], k
    assert got[3]["crs"].to_wkt() == want[3]["crs"].to_wkt()


def test_boundary_mask_matches_jax():
    from obia_tpu.segmentation.segment import boundary_mask as jmask
    from obia_tpu_torch.segmentation.segment import boundary_mask
    lab = np.random.default_rng(3).integers(-1, 4, (17, 23))
    np.testing.assert_array_equal(boundary_mask(lab), jmask(lab))


def test_to_segmented_image_matches_jax(small_rgb):
    from PIL.Image import fromarray
    from obia_tpu.segmentation.segment import segment as jax_segment
    from obia_tpu_torch.segmentation.segment import segment
    img = tgeotif.image_from_array(small_rgb, JAffine(1, 0, 0, 0, -1, 96),
                                   crs="EPSG:32633")
    s = segment(img, method="slic", n_segments=16, device="cpu")
    js = jax_segment(jgeotif.image_from_array(
        small_rgb, JAffine(1, 0, 0, 0, -1, 96), crs="EPSG:32633"),
        method="slic", n_segments=16)
    np.testing.assert_array_equal(s.label_raster, js.label_raster)
    for pil in (img.to_image([0, 1, 2]),
                fromarray((small_rgb[:, :, 0] * 255).astype(np.uint8))):
        got = np.array(s.to_segmented_image(pil))
        np.testing.assert_array_equal(got,
                                      np.array(js.to_segmented_image(pil)))
        assert got.shape == (96, 128, 3)
    yellow = (got == [255, 255, 0]).all(axis=2)
    assert yellow.any() and not yellow.all()
    with pytest.raises(TypeError):
        s.to_segmented_image(small_rgb)


def _slic_cases(small_rgb):
    h, w = small_rgb.shape[:2]
    mask = np.ones((h, w), np.uint8)
    mask[:, :w // 4] = 0
    rnd = np.random.default_rng(42).random((96, 96, 3)).astype(np.float32)
    return {
        "basic": (small_rgb, dict(n_segments=40, compactness=10.0)),
        "strong_edges": (small_rgb, dict(n_segments=60, compactness=1.0,
                                         convert2lab=False)),
        "mask": (small_rgb, dict(n_segments=30, mask=mask)),
        "start_label_0": (small_rgb, dict(n_segments=25, start_label=0)),
        "slic_zero": (small_rgb, dict(n_segments=30, slic_zero=True,
                                      convert2lab=False)),
        "spacing_iso": (rnd, dict(n_segments=25, compactness=10.0,
                                  convert2lab=False, spacing=(2.0, 2.0),
                                  start_label=0)),
        "spacing_aniso": (rnd, dict(n_segments=25, compactness=1.0,
                                    convert2lab=False, spacing=(1.0, 4.0),
                                    start_label=0)),
        "no_connectivity": (small_rgb, dict(n_segments=30,
                                            enforce_connectivity=False)),
    }


@pytest.mark.parametrize("case", ["basic", "strong_edges", "mask",
                                  "start_label_0", "slic_zero",
                                  "spacing_iso", "spacing_aniso",
                                  "no_connectivity"])
def test_slic_matches_jax(small_rgb, case):
    """``test_ops_slic.py``'s ``slic()`` cases, with the port on an array
    (the CPU asked for) and on a tensor (its own device)."""
    import torch
    from obia_tpu.ops.slic import slic as jax_slic
    from obia_tpu_torch.ops.slic import slic
    img, kw = _slic_cases(small_rgb)[case]
    want = jax_slic(img, **kw)
    got = slic(img, device="cpu", **kw)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(slic(torch.as_tensor(img), **kw), got)
    if "mask" in kw:
        off = kw["mask"] == 0
        assert (got[off] == 0).all() and got[~off].min() == 1
    differ = got != want
    if case != "mask":
        np.testing.assert_array_equal(got, want)
    assert differ.mean() <= 5e-4
    pad = np.pad(want, 1, constant_values=-2)
    for r, c in zip(*np.nonzero(differ)):
        assert got[r, c] in (pad[r, c + 1], pad[r + 2, c + 1],
                             pad[r + 1, c], pad[r + 1, c + 2])


def test_telemetry_timed_is_enabled_and_trace(tmp_path):
    import torch
    from obia_tpu_torch import telemetry

    @telemetry.timed("probe.stage")
    def work(x):
        return (x * 2).sum()

    telemetry.reset()
    assert telemetry.is_enabled() is False
    telemetry.enable(True)
    try:
        assert telemetry.is_enabled() is True
    finally:
        telemetry.enable(False)
    with telemetry.trace(str(tmp_path / "tr")) as prof:
        assert float(work(torch.ones(5))) == 10.0
    assert prof is not None
    assert telemetry.report()["probe.stage"]["count"] == 1
    files = os.listdir(tmp_path / "tr")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "tr" / files[0]) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("mul" in n for n in names), sorted(names)[:20]

    @telemetry.timed()
    def unnamed():
        return 1

    assert unnamed() == 1 and "test_telemetry_timed_is_enabled_and_trace."\
        "<locals>.unnamed" in telemetry.report()


def test_exports_match_jax():
    import obia_tpu
    import obia_tpu.geometry
    import obia_tpu_torch
    import obia_tpu_torch.geometry as tgeom
    for name in ("create_tiled_segments", "segment_mosaic", "segment",
                 "classify", "label_segments", "open_geotiff"):
        assert name in obia_tpu_torch.__all__ and callable(
            getattr(obia_tpu_torch, name)), name
        assert getattr(obia_tpu_torch, name).__name__ == \
            getattr(obia_tpu, name).__name__
    assert set(obia_tpu.geometry.__all__) <= set(tgeom.__all__)
    for name in obia_tpu.geometry.__all__:
        assert getattr(tgeom, name).__name__.rsplit(".", 1)[-1] == \
            getattr(obia_tpu.geometry, name).__name__.rsplit(".", 1)[-1]


BASE_INSTALL = textwrap.dedent("""
    import builtins
    real_import = builtins.__import__

    def blocked(name, *a, **k):
        if name.split(".")[0] in ("cv2", "jax", "obia_tpu"):
            raise ImportError(f"No module named {name!r} (blocked)")
        return real_import(name, *a, **k)

    builtins.__import__ = blocked

    import numpy as np
    from obia_tpu_torch.geometry import Affine
    from obia_tpu_torch.handlers.geotif import open_geotiff
    from obia_tpu_torch.io.tiff import write_tiff
    from obia_tpu_torch.utils.image import (apply_clahe,
                                            apply_histogram_equalization,
                                            variance_of_laplacian)

    arr = (np.random.default_rng(3).random((40, 50, 3)) * 255).astype(
        np.uint8)
    write_tiff("scene.tif", arr, transform=Affine(1, 0, 0, 0, -1, 0),
               crs="EPSG:32610")
    img = open_geotiff("scene.tif")
    assert img.img_data.shape == (40, 50, 3)
    g = arr[..., 0]
    assert apply_clahe(g).shape == (40, 50)
    assert apply_histogram_equalization(g).shape == (40, 50, 3)
    assert variance_of_laplacian(g.astype(np.float32), 5).shape == (40, 50)
    assert img.to_image(bands=[0, 1, 2], stretch_type="clahe").size == (50,
                                                                        40)
    print("BASE_INSTALL_OK")
""")


def test_core_api_without_cv2(tmp_path):
    """JAX's test_base_install.py:47 on the port: open_geotiff, the image
    utilities and ``to_image`` work without OpenCV (and without jax)."""
    proc = subprocess.run(
        [sys.executable, "-c", BASE_INSTALL], cwd=tmp_path, text=True,
        capture_output=True,
        env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path)},
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BASE_INSTALL_OK" in proc.stdout
