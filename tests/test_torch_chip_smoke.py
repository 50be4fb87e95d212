"""chip_smoke.py carries its own copy of bench.py's synthetic scene, so it
needs nothing of the repo's JAX side on the card's machine: the copy must
give bench.py's arrays."""
import numpy as np
import pytest

import bench
import chip_smoke


@pytest.mark.parametrize("h,w,c,seed", [(16, 16, 3, 0), (33, 20, 4, 0),
                                        (24, 40, 1, 7)])
def test_build_scene_is_bench_scene(h, w, c, seed):
    got = chip_smoke.build_scene(h=h, w=w, c=c, seed=seed)
    want = bench.build_scene(h=h, w=w, c=c, seed=seed)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_config4_scene_is_bench_config4():
    """bench.bench_config4's 8 bands: build_scene's 4, then 4 rolled."""
    size = 48
    scene = chip_smoke.config4_scene(size)
    base = bench.build_scene(h=size, w=size, c=4)
    assert scene.shape == (size, size, 8) and scene.dtype == np.uint8
    assert np.array_equal(scene[..., :4], base)
    for i in range(4):
        want = np.roll(base[..., i % 4].astype(np.float32), 17 * (i + 1),
                       axis=i % 2).astype(np.uint8)
        assert np.array_equal(scene[..., 4 + i], want)


def test_detection_tiles_load_as_a_dataset(tmp_path):
    """Phase 20's crown tiles: uint16 GeoTIFFs whose annotations.json the
    port's TreeDetectionDataset reads, every box inside its tile; and
    check_boxes refuses a box outside the raster."""
    from obia_tpu_torch.detection.dataset import TreeDetectionDataset

    ann = chip_smoke.write_detection_tiles(str(tmp_path), 2, 96, seed=3)
    ds = TreeDetectionDataset(str(tmp_path), ann)
    assert len(ds) == 2
    for i in range(2):
        img, tgt = ds[i]
        assert img.shape == (chip_smoke.DET_BANDS, 96, 96)
        b = tgt["boxes"]
        assert len(b) == 9 and (b >= 0).all() and (b <= 96).all()
        assert (b[:, 2] > b[:, 0]).all() and (b[:, 3] > b[:, 1]).all()
    ok = {"boxes": np.array([[0.0, 1.0, 96.0, 50.0]], np.float32),
          "scores": np.array([0.9], np.float32), "labels": np.array([1])}
    chip_smoke.check_boxes(ok, 96)
    with pytest.raises(AssertionError, match="leaves the raster"):
        chip_smoke.check_boxes(dict(ok, boxes=ok["boxes"] + 1), 96)


def test_train_inputs_are_the_config5_scene():
    """Phases 23-24's inputs: bench.py's RGB scene in [0, 1) as float32,
    and one seeded target in [0, 8) for each object of the step's grid."""
    from obia_tpu_torch.ops.slic import _grid_shape
    scene, targets = chip_smoke.train_inputs(64, 16)
    want = bench.build_scene(h=64, w=64, c=3).astype(np.float32) / 256.0
    assert scene.dtype == np.float32 and np.array_equal(scene, want)
    assert 0.0 <= scene.min() and scene.max() < 1.0
    gh, gw = _grid_shape(64, 64, 16)
    assert targets.shape == (gh * gw,)
    assert 0 <= targets.min() and targets.max() < chip_smoke.FUSED_CLASSES
    assert np.array_equal(targets, chip_smoke.train_inputs(64, 16)[1])


def test_train_inputs_take_a_width():
    """Phase 24's CPU run on the dry run's 256 x 512: the same scene as
    bench.py's at that shape, targets for that shape's grid."""
    from obia_tpu_torch.ops.slic import _grid_shape
    scene, targets = chip_smoke.train_inputs(32, 16, width=48)
    want = bench.build_scene(h=32, w=48, c=3).astype(np.float32) / 256.0
    assert np.array_equal(scene, want)
    gh, gw = _grid_shape(32, 48, 16)
    assert targets.shape == (gh * gw,)


# -- phase 26's checks (the north-star scene), on the CPU at 256^2 ----------

@pytest.fixture(scope="module")
def north_star_runs():
    """Config 4 and the 2 x 4 mosaic on config 4's 8-band scene at 256^2 on
    the CPU, as phase 26 runs them at 10000^2 on the card (the mosaic with
    64 segments and 32 GLCM levels, which keep its CPU twin small). One
    torch thread: beside other test workers, a pool of threads makes these
    runs of small ops tens of times slower."""
    import types

    import torch

    from obia_tpu_torch.parallel.mesh import make_mesh
    from obia_tpu_torch.parallel.mosaic import mosaic_pipeline
    image = chip_smoke.as_image(chip_smoke.config4_scene(256))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        s, proba, _ = chip_smoke.run_slice(image, "cpu")
        objects = mosaic_pipeline(image, n_segments=64,
                                  mesh=make_mesh(8, ["cpu"]),
                                  objects_kwargs={"glcm_levels": 32})
    finally:
        torch.set_num_threads(threads)
    return s, proba, types.SimpleNamespace(table=objects,
                                           layer=objects.layer)


def _inputs(run, proba=None):
    layer = run.layer
    return dict(labels=layer.labels_dev, K=len(run.table),
                pixels=chip_smoke.pixel_counts(run.table.geometry,
                                               layer.transform),
                table=run.table, proba=proba, what="256^2")


def test_north_star_checks_pass_on_both_paths(north_star_runs):
    s, proba, r5 = north_star_runs
    chip_smoke.check_north_star(**_inputs(s, proba))
    chip_smoke.check_north_star(**_inputs(r5))
    assert proba is not None and len(s.table) > 100 and len(r5.table) > 50
    assert r5.layer.shards is not None


def _hole(kw):
    lab = kw["labels"].clone()
    lab[7, 9] = -1
    return dict(kw, labels=lab)


def _missing_area(kw):
    pixels = kw["pixels"].copy()
    pixels[3] = 0.0  # one polygon lost
    return dict(kw, pixels=pixels)


def _count_off_by_one(kw):
    pixels = kw["pixels"].copy()
    pixels[3] += 1  # the total still adds up
    pixels[4] -= 1
    return dict(kw, pixels=pixels)


def _id_unused(kw):
    lab = kw["labels"].clone()
    lab[lab == 5] = 4  # id 5 gone: not dense
    return dict(kw, labels=lab)


def _short_table(kw):
    K = kw["K"]
    return dict(kw, table=kw["table"].take(np.arange(K - 1)))


def _nan_column(kw):
    col = np.asarray(kw["table"]["b2_contrast"], float).copy()
    col[1] = np.nan
    return dict(kw, table=kw["table"].with_columns(b2_contrast=col))


def _proba_rows(kw):
    proba = kw["proba"].copy()
    proba[0] *= 0.5
    return dict(kw, proba=proba)


@pytest.mark.parametrize("tamper,match", [
    (_hole, "belong to no object"), (_missing_area, "add up to"),
    (_count_off_by_one, "pixel counts"), (_id_unused, "not dense"),
    (_short_table, "rows"), (_nan_column, "NaN"),
    (_proba_rows, "probability rows")])
def test_north_star_checks_refuse(north_star_runs, tamper, match):
    s, proba, _ = north_star_runs
    with pytest.raises(AssertionError, match=match):
        chip_smoke.check_north_star(**tamper(_inputs(s, proba)))


def test_pixel_counts_use_the_pixel_area(north_star_runs):
    """A 2 m grid: each polygon's area is 4 m^2 a pixel."""
    from obia_tpu_torch.geometry import Affine
    s, _, _ = north_star_runs
    geoms = s.table.geometry
    one = chip_smoke.pixel_counts(geoms, s.layer.transform)
    assert one.sum() == pytest.approx(256 * 256, rel=1e-12)
    half = chip_smoke.pixel_counts(geoms, Affine(2.0, 0, 0, 0, -2.0, 0))
    np.testing.assert_allclose(half, one / 4)


# -- phase 27's helpers (the obia_torch flow, the new functions, the
# detection row), on the CPU at 96^2 -----------------------------------------

@pytest.fixture(scope="module")
def alias_run(tmp_path_factory):
    """Phase 27 (a)'s flow through ``obia_torch`` at 96^2 on the CPU (30
    segments, so that every object has texture pairs), as phase 27 runs it
    at 4096^2 on the card, and a direct ``obia_tpu_torch`` call on the
    same scene."""
    from obia_tpu_torch.segmentation.segment import segment
    root = tmp_path_factory.mktemp("alias")
    scene = chip_smoke.build_scene(h=96, w=96)
    path = chip_smoke.write_scene(str(root / "scene.tif"), scene)
    s, res, back, wall = chip_smoke.alias_flow(
        path, str(root / "classified.tif"), "cpu", n_segments=30)
    direct = segment(chip_smoke.as_image(scene), method="slic",
                     n_segments=30, compactness=10, device="cpu")
    return s, res, back, direct


def test_alias_phase_runs_on_the_cpu(alias_run):
    """Phase 27 (a) and (b) end to end at 96^2, K held to a direct
    ``obia_tpu_torch`` call's as phase 27 holds it to the bench's config-1
    row (the same call)."""
    launches = chip_smoke.alias_phase("cpu", len(alias_run[3].table),
                                      size=96, device="cpu", n_segments=30,
                                      cross=48, n_points=40)
    assert set(launches) == {"glcm_sums", "glcm_hist", "qs_density",
                             "qs_parent", "slic_pass"}
    assert not any(launches.values())  # the CPU takes the twins


def _tampered(alias_run, what):
    import copy
    s, res, back, direct = alias_run
    if what == "count":
        return (s, res, back, direct, len(s.table) + 1)
    if what == "labels":
        other = copy.copy(direct)
        other.layer = copy.copy(direct.layer)
        rle = direct.layer.label_raster
        vals = rle.values.copy()
        vals[0] += 1
        other.layer.label_raster = type(rle)(vals, rle.lengths, rle.shape)
        return (s, res, back, other, None)
    if what == "geotiff":
        bad = back.copy()
        bad[0, 0, 0] = 99
        return (s, res, bad, direct, None)
    s2 = copy.copy(s)
    s2.table = copy.copy(s.table)
    col = np.asarray(s.table["b0_mean"], np.float64).copy()
    col[1] = np.nan
    s2.table = s.table.with_columns(b0_mean=col)
    return (s2, res, back, direct, None)


def test_alias_checks_pass(alias_run):
    s, res, back, direct = alias_run
    chip_smoke.check_alias_flow(s, res, back, direct, len(s.table), "96^2")
    assert back.shape[:2] == (96, 96) and len(s.table) > 10


@pytest.mark.parametrize("tamper,match", [
    ("count", "objects"), ("labels", "direct"), ("geotiff", "GeoTIFF"),
    ("nan", "NaN")])
def test_alias_checks_refuse(alias_run, tamper, match):
    with pytest.raises(AssertionError, match=match):
        chip_smoke.check_alias_flow(*_tampered(alias_run, tamper), "96^2")


def test_join_check_refuses_a_point_in_no_polygon(alias_run):
    s = alias_run[0]
    geoms = list(s.table.geometry)
    shape = tuple(s.layer.labels_dev.shape)
    chip_smoke.join_check(geoms, s.layer.transform, shape, 50, 1, "96^2")
    with pytest.raises(AssertionError, match="no polygon"):
        chip_smoke.join_check(geoms[1:], s.layer.transform, shape, 200, 1,
                              "96^2")


@pytest.mark.parametrize("rtol,atol,delta,match", [
    (0, 0, 0.0, None), (0, 0, 1e-6, "beyond"), (1e-4, 0, 1e-6, None),
    (0, 0, np.nan, "NaN slots")])
def test_same_tables(rtol, atol, delta, match):
    want = {"a": np.array([1.0, np.nan, 3.0], np.float32)}
    got = {"a": want["a"] + np.array([delta, 0, 0], np.float32)}
    if match is None:
        chip_smoke._same_tables(got, want, rtol, atol, "t")
    else:
        with pytest.raises(AssertionError, match=match):
            chip_smoke._same_tables(got, want, rtol, atol, "t")
    with pytest.raises(AssertionError, match="names"):
        chip_smoke._same_tables({"b": want["a"]}, want, 0, 0, "t")


def _detection_row(**change):
    row = {k: 1.0 for k in chip_smoke.TOOL_DETECTION_KEYS}
    row.update(device="NVIDIA H100 80GB HBM3, 700.00 W",
               launches={"glcm_sums": 0})
    row.update(change)
    return {"detection_bench": row}


@pytest.mark.parametrize("change,match", [
    ({}, None), ({"loss": float("nan")}, "loss"),
    ({"device": "cpu"}, "device"), ({"predict_s": 0.0}, "times"),
    ({"extra": 1}, "keys")])
def test_check_detection_row(change, match):
    card = "NVIDIA H100 80GB HBM3, 700.00 W"
    if match is None:
        assert chip_smoke.check_detection_row(_detection_row(), card)[
            "loss"] == 1.0
    else:
        with pytest.raises(AssertionError, match=match):
            chip_smoke.check_detection_row(_detection_row(**change), card)


def test_detection_keys_are_the_tools():
    """chip_smoke's copy of tools/bench_detection.py's keys: the keys of
    the ``detection_bench`` dict that the tool prints."""
    import ast
    from pathlib import Path

    tool = Path(chip_smoke.ROOT) / "tools" / "bench_detection.py"
    rows = [n for n in ast.walk(ast.parse(tool.read_text()))
            if isinstance(n, ast.Dict) and any(
                isinstance(k, ast.Constant) and k.value == "detection_bench"
                for k in n.keys)]
    assert len(rows) == 1
    inner = rows[0].values[0]
    assert tuple(k.value for k in inner.keys) == \
        chip_smoke.TOOL_DETECTION_KEYS


def test_north_star_runs_logs_the_warm_runs_sweeps(monkeypatch, capsys):
    """Phase 26's runs on the CPU at 64^2 (the card's memory calls and the
    profiled rerun stubbed): the log line carries the CCL sweeps of the
    warm run alone, read from the telemetry's counters."""
    import torch

    from obia_tpu_torch import telemetry
    for name in ("empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda: 0)
    monkeypatch.setattr(chip_smoke, "profiled", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "card_line", lambda: "cpu")
    image = chip_smoke.as_image(chip_smoke.config4_scene(64))
    warm_sweeps = []

    def run(image, device):
        before = telemetry.counters().get("ccl.sweeps", 0)
        out = chip_smoke.run_slice(image, "cpu")
        warm_sweeps.append(telemetry.counters().get("ccl.sweeps", 0)
                           - before)
        return out

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        chip_smoke.north_star_runs(run, image, "64^2")
    finally:
        torch.set_num_threads(threads)
    line = capsys.readouterr().out
    assert warm_sweeps[1] >= 1
    assert f"; CCL sweeps {warm_sweeps[1]} (cpu)" in line


# -- phase 28's inputs and yardsticks (the SLIC pass kernel), on the CPU -----

def test_slic_scene_is_seeded_and_in_lab_ranges():
    import torch
    a = chip_smoke.slic_scene(24, "cpu", seed=3)
    b = chip_smoke.slic_scene(24, "cpu", seed=3)
    assert a.shape == (24, 24, 3) and a.dtype == torch.float32
    assert torch.equal(a, b) and a.is_contiguous()
    assert not torch.equal(a, chip_smoke.slic_scene(24, "cpu", seed=4))
    for c, (lo, hi) in enumerate(((0, 100), (-50, 50), (-50, 50))):
        assert float(a[..., c].min()) == pytest.approx(lo, abs=1e-4)
        assert float(a[..., c].max()) == pytest.approx(hi, abs=1e-4)


def test_slic_twin_iterate_is_the_cpu_loop():
    """On the CPU ``_slic_iterate`` runs the twin, so phase 28's written-out
    twin loop gives its labels; and the bytes bound of 11 passes at 100 MP:
    13 B/px a pass and 8 B/px of labels."""
    import torch
    from obia_tpu_torch.ops import slic as tslic
    img = chip_smoke.slic_scene(40, "cpu", seed=1)
    valid = torch.ones((40, 40), dtype=torch.bool)
    gh, gw = tslic._grid_shape(40, 40, 25)
    step, half = tslic._grid_step(40, 40, 25), tslic._grid_half(40, 40, 25)
    want = tslic._slic_iterate(img, valid, gh, gw, 10.0, 4, grid_step=step,
                               grid_half=half)
    got, centers = chip_smoke.slic_twin_iterate(img, valid, gh, gw, 10.0, 4,
                                                step, half)
    assert torch.equal(got, want) and centers.shape == (gh, gw, 5)
    assert chip_smoke.slic_bound_ms(10 ** 8, 3, 11) == pytest.approx(
        1e8 * (13 * 11 + 8) / 3.35e9)
