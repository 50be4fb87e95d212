"""The port's ``LazyRLERaster`` (the host label raster every ``SegmentLayer``
carries, decoded from its row-wise runs on first use) against the JAX
package's on the same seeded runs: every operation of the ndarray surface
gives the same result (bar: equal values, dtypes and shapes), a copy is the
raster itself, and the consumers that read the attached raster
(``Segments.to_segmented_image``, ``ClassifiedImage.write_geotiff``) give
JAX's images and bytes.
"""
import copy

import numpy as np
import pytest

import obia_tpu.ops.slic as jslic
from obia_tpu.geometry import Affine as JAffine
from obia_tpu_torch.ops import slic as tslic


def _runs(seed=7, shape=(23, 37)):
    """Row-wise runs of a seeded label raster (values int32, lengths int64
    as ``download_labels_rle`` gives them), with a -1 run."""
    rng = np.random.default_rng(seed)
    H, W = shape
    lab = np.repeat(rng.integers(0, 9, (H, W // 4 + 1)), 4, axis=1)[:, :W]
    lab[3, :6] = -1
    lab = lab.astype(np.int32)
    flat = lab.reshape(-1)
    start = np.ones(flat.size, bool)
    start[1:] = flat[1:] != flat[:-1]
    start[::W] = True
    starts = np.flatnonzero(start)
    lengths = np.diff(np.append(starts, flat.size)).astype(np.int64)
    return flat[starts].astype(np.int32), lengths, (H, W), lab


@pytest.fixture
def pair():
    values, lengths, shape, lab = _runs()
    return (tslic.LazyRLERaster(values, lengths, shape),
            jslic.LazyRLERaster(values, lengths, shape), lab)


OPERATIONS = {
    "array": lambda r: np.asarray(r),
    "array_dtype": lambda r: np.asarray(r, dtype=np.float64),
    "getitem": lambda r: r[:, 1:],
    "astype": lambda r: r.astype(np.int64),
    "eq": lambda r: r == 3,
    "ne": lambda r: r != 3,
    "lt": lambda r: r < 4,
    "le": lambda r: r <= 4,
    "gt": lambda r: r > 4,
    "ge": lambda r: r >= 0,
    "add": lambda r: r + 1,
    "radd": lambda r: 1 + r,
    "sub": lambda r: r - 2,
    "rsub": lambda r: 10 - r,
    "mul": lambda r: r * 3,
    "rmul": lambda r: 3 * r,
    "min": lambda r: r.min(),
    "max": lambda r: r.max(),
    "min_axis": lambda r: r.min(axis=0),
    "max_axis": lambda r: r.max(axis=1),
}


@pytest.mark.parametrize("op", sorted(OPERATIONS))
def test_operation_matches_jax(pair, op):
    port, jax, lab = pair
    got, want = OPERATIONS[op](port), OPERATIONS[op](jax)
    assert type(got) is type(want)
    assert np.asarray(got).dtype == np.asarray(want).dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, OPERATIONS[op](lab))


def test_attributes_match_jax(pair):
    port, jax, lab = pair
    for name in ("dtype", "ndim", "size", "shape"):
        assert getattr(port, name) == getattr(jax, name), name
    assert port.dtype == lab.dtype and port.size == lab.size
    assert len(port) == len(jax) == lab.shape[0]


def test_copies_are_the_raster(pair):
    port, jax, _ = pair
    assert copy.copy(port) is port and copy.deepcopy(port) is port
    assert copy.copy(jax) is jax and copy.deepcopy(jax) is jax
    held = copy.deepcopy({"raster": port})
    assert held["raster"] is port


def test_unhashable_and_not_an_identity_comparison(pair):
    port, jax, _ = pair
    for r in (port, jax):
        with pytest.raises(TypeError):
            hash(r)
        assert isinstance(r == 3, np.ndarray)
        assert (r == r).all()


@pytest.fixture
def segmented(small_rgb, monkeypatch):
    """The same scene segmented by both packages, JAX's with its lazy RLE
    raster forced (it attaches one only above 4 MP)."""
    from obia_tpu.handlers.geotif import image_from_array as jimage
    from obia_tpu.segmentation.segment import segment as jsegment
    from obia_tpu_torch.handlers.geotif import image_from_array
    from obia_tpu_torch.segmentation.segment import segment
    monkeypatch.setattr(jslic, "_RLE_MIN_PIXELS", 1)
    t = JAffine(1, 0, 0, 0, -1, 96)
    s = segment(image_from_array(small_rgb, t, crs="EPSG:32633"),
                method="slic", n_segments=24, device="cpu")
    js = jsegment(jimage(small_rgb, t, crs="EPSG:32633"), method="slic",
                  n_segments=24)
    return s, js, t


def test_segmented_image_with_the_lazy_raster_matches_jax(segmented,
                                                          small_rgb):
    from PIL.Image import fromarray
    from obia_tpu.segmentation.segment_boundaries import LABEL_RASTER_ATTR
    s, js, _ = segmented
    assert isinstance(s.layer.label_raster, tslic.LazyRLERaster)
    jlr = js._segments.attrs[LABEL_RASTER_ATTR].value
    assert isinstance(jlr, jslic.LazyRLERaster)
    pil = fromarray((np.clip(small_rgb, 0, 1) * 255).astype(np.uint8))
    got = np.array(s.to_segmented_image(pil))
    np.testing.assert_array_equal(got, np.array(js.to_segmented_image(pil)))
    assert got.shape == (96, 128, 3)


def test_write_geotiff_with_the_lazy_raster_matches_jax(segmented, tmp_path):
    from obia_tpu.classification.classify import ClassifiedImage as JCI
    from obia_tpu.segmentation.segment_boundaries import LABEL_RASTER_ATTR
    from obia_tpu.vector import GeoDataFrame
    from obia_tpu_torch.classification.classify import ClassifiedImage
    s, js, t = segmented
    lr = s.layer.label_raster
    jlr = js._segments.attrs[LABEL_RASTER_ATTR].value
    np.testing.assert_array_equal(np.asarray(lr), np.asarray(jlr))
    cls = np.arange(1, len(s.table) + 1) % 3
    table = s.table.with_columns(predicted_class=cls)
    ClassifiedImage(table, None, None, None, t, "EPSG:32633", {},
                    label_raster=lr, label_rows=table.label_rows
                    ).write_geotiff(str(tmp_path / "port.tif"))
    gdf = GeoDataFrame(js.segments)
    gdf.attrs = dict(js.segments.attrs)
    gdf["predicted_class"] = cls
    JCI(gdf, None, None, None, t, "EPSG:32633", {},
        label_raster=jlr).write_geotiff(str(tmp_path / "jax.tif"))
    assert (tmp_path / "port.tif").read_bytes() == \
        (tmp_path / "jax.tif").read_bytes()
