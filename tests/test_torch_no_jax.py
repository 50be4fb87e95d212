"""obia_tpu_torch runs with jax, pandas, sklearn, PIL and the JAX package
``obia_tpu`` unavailable, as on a machine that has only torch, numpy and
scipy: the port imports none of them on its main paths (SLIC + forest,
quickshift + MLP, ``classify`` with the MLP and Kernel SHAP on object
tables, ``create_objects`` on a filtered table and on a GeoPackage read
back (the rasterise path) with a LAS point cloud, the sharded mosaic on a
2 x 4 CPU mesh, tiled segmentation with the ``sigma`` pre-blur, the canopy
seed and cost-surface workflow, the detection subsystem: build, train
on GeoTIFF tiles, predict; the fused model's forward and one sharded
training step, the process-group start-up on one process, the bench's
config 1 with its stand-in forest, and the README's flow through the
``obia_torch`` import paths with the MLP route, every ``obia_torch`` module
and ``obia_tpu_torch.vector`` imported), and never
loads jax, flax, optax, click,
tqdm, matplotlib or OpenCV (the CLI module imports without click), nor
the ``obia`` namespace. Its sources, ``obia_torch``'s and
``chip_smoke.py`` import neither jax, ``obia_tpu``, ``obia`` nor the
repository's ``bench.py``."""
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

SCRIPT = textwrap.dedent("""
    import builtins
    import sys
    BLOCKED = ("jax", "jaxlib", "pandas", "sklearn", "PIL", "flax", "optax",
               "obia_tpu", "obia", "click", "tqdm", "matplotlib", "cv2")
    real_import = builtins.__import__

    def blocked(name, *a, **k):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"No module named {name!r} (blocked)")
        return real_import(name, *a, **k)

    builtins.__import__ = blocked

    import numpy as np
    import torch
    import obia_tpu_torch
    from obia_tpu_torch.classification.forest import (ForestArrays,
                                                      forest_proba)
    from obia_tpu_torch.geometry.affine import Affine
    from obia_tpu_torch.handlers.geotif import image_from_array
    from obia_tpu_torch.segmentation.segment import segment

    rng = np.random.default_rng(0)
    arr = (rng.random((64, 80, 4)) * 255).astype(np.uint8)
    arr[:32] //= 3
    image = image_from_array(arr, Affine(1, 0, 0, 0, -1, 64),
                             crs="EPSG:32633")
    s = segment(image, segmentation_bands=[0, 1, 2], n_segments=12,
                compactness=10, device="cpu")
    t = s.table
    assert len(t) > 3 and len(t.geometry) == len(t)
    X = np.nan_to_num(np.stack([t[c] for c in t.columns
                                if c != "segment_id"], axis=1))
    f = X.shape[1]
    forest = ForestArrays.from_numpy(
        feature=[[0, -1, -1]], threshold=[[np.median(X[:, 0]), 0, 0]],
        left=[[1, 1, 2]], right=[[2, 1, 2]],
        leaf_proba=[[[0.5, 0.5], [1.0, 0.0], [0.0, 1.0]]],
        classes=[0, 1], max_depth=1, device="cpu")
    p = forest_proba(forest, torch.as_tensor(X)).numpy()
    assert np.allclose(p.sum(1), 1.0)

    from obia_tpu_torch.classification.mlp import TorchMLPClassifier
    q = segment(image, segmentation_bands=[0, 1, 2], method="quickshift",
                kernel_size=2, max_dist=8.0, device="cpu")
    tq = q.table
    assert len(tq) > 3 and len(tq.geometry) == len(tq)
    Xq = np.nan_to_num(np.stack([tq[c] for c in tq.columns
                                 if c != "segment_id"], axis=1))
    clf = TorchMLPClassifier(hidden_layer_sizes=(8,), max_iter=3,
                             device="cpu")
    clf.fit(Xq, Xq[:, 0] > np.median(Xq[:, 0]))
    assert np.allclose(clf.predict_proba(Xq).sum(1), 1.0, atol=1e-5)

    from obia_tpu_torch.io.las import write_las
    from obia_tpu_torch.segmentation.segment_statistics import create_objects
    from obia_tpu_torch.vector.features import read_features
    rng2 = np.random.default_rng(1)
    write_las("pts.las", {"X": rng2.uniform(0, 80, 500),
                          "Y": rng2.uniform(0, 64, 500),
                          "Z": rng2.uniform(0, 20, 500),
                          "Intensity": rng2.integers(0, 999, 500)},
              point_format=6, crs="EPSG:32633")
    s.layer.to_file("segments.gpkg")
    o = create_objects(read_features("segments.gpkg"), image,
                       pointcloud="pts.las", calculate_structural=True,
                       calculate_radiometric=True, voxel_resolution=1.0,
                       device="cpu")
    assert len(o) == len(t) and np.isfinite(o["ch"]).any()
    half = create_objects(t.take(np.arange(0, len(t), 2)), image,
                          strict_reference_glcm=True, textural_bands=[0])
    assert np.allclose(half["b0_mean"], t["b0_mean"][::2], rtol=1e-6)

    from obia_tpu_torch.classification.classify import classify
    training = t.with_columns(
        feature_class=(X[:, 0] > np.median(X[:, 0])).astype(int))
    res = classify(t, training, method="mlp", hidden_layer_sizes=(8,),
                   max_iter=5, compute_shap=True, sample_shap=True,
                   device="cpu")
    rows = res.shap_inputs[0]
    assert res.shap_values.shape == (len(rows), rows.shape[1], 2)
    assert np.isfinite(res.shap_values).all()
    assert len(res.table["predicted_class"]) == len(t)
    assert np.allclose(res.proba.sum(1), 1.0, atol=1e-5)

    from obia_tpu_torch.parallel.mesh import make_mesh
    from obia_tpu_torch.parallel.mosaic import mosaic_pipeline
    tm = mosaic_pipeline(image, n_segments=12, mesh=make_mesh(8, ["cpu"]),
                         objects_kwargs={"glcm_levels": 32})
    assert len(tm) > 3 and len(tm.geometry) == len(tm)
    assert np.isfinite(tm["b0_mean"]).all()

    import os
    import obia_tpu_torch.checkpoint
    import obia_tpu_torch.cli
    from obia_tpu_torch.io.gpkg import read_gpkg
    from obia_tpu_torch.io.tiff import write_tiff
    from obia_tpu_torch.utils.tiling import create_tiled_segments
    write_tiff("scene.tif", arr[:, :, :3], transform=Affine(1, 0, 0, 0, -1, 64),
               crs="EPSG:32633")
    tiled = create_tiled_segments("scene.tif", "tiled", tile_size=32,
                                  buffer=8, n_segments=6, sigma=1.0,
                                  device="cpu")
    cols, geoms, _ = read_gpkg(os.path.join("tiled", "segments.gpkg"))
    assert len(tiled) > 3 and cols["segment_id"] == list(
        range(1, len(tiled) + 1)) and len(geoms) == len(tiled)

    import obia_tpu_torch.parallel.distributed as tdist
    from obia_tpu_torch.models.pipeline import (initial_centers,
                                                make_flagship,
                                                make_sharded_train_step)
    tdist.initialize()
    assert tdist.process_info()["process_count"] == 1
    fn, (fimg, fmodel) = make_flagship(64, 64, 3, 16, 4, device="cpu")
    logits, flab = fn(fimg, fmodel)
    assert logits.shape == (16, 4) and bool(torch.isfinite(logits).all())
    step, init, (gh, gw, K) = make_sharded_train_step(
        make_mesh(8, ["cpu"]), 64, 64, 3, 16, 4)
    model, opt = init()
    model, opt, loss, _ = step(fimg, torch.arange(K) % 4,
                               initial_centers(fimg, gh, gw), model, opt)
    assert bool(torch.isfinite(loss))
    from obia_tpu_torch import bench
    row = bench.run(64, 1, device="cpu")
    assert row["forest"] == "stand-in" and row["n_objects"] > 3
    try:
        bench.run(64, 4, forest="fit", device="cpu")
    except ImportError as exc:
        assert "sklearn" in str(exc)
    else:
        raise AssertionError("forest='fit' ran without sklearn")

    import importlib
    import pkgutil
    import obia_torch
    import obia_tpu_torch.vector
    for m in pkgutil.walk_packages(obia_torch.__path__, "obia_torch."):
        importlib.import_module(m.name)
    from obia_torch.classification.classify import classify as oclassify
    from obia_torch.handlers.geotif import open_geotiff
    from obia_torch.segmentation.segment import segment as osegment
    hs = osegment(open_geotiff("scene.tif"), method="slic", n_segments=12,
                  compactness=10, device="cpu")
    ht = hs.table
    hy = (np.asarray(ht["b0_mean"]) > np.median(ht["b0_mean"])).astype(int)
    hidx = np.arange(0, len(ht), 2)
    hout = oclassify(ht, ht.take(hidx).with_columns(feature_class=hy[hidx]),
                     method="mlp", hidden_layer_sizes=(8,), max_iter=5,
                     device="cpu")
    hout.write_geotiff("classified.tif")
    assert open_geotiff("classified.tif").img_data.shape[:2] == (64, 80)
    for mod in BLOCKED:
        assert mod not in sys.modules, mod
    print("NO_JAX_OK", len(t), f, len(tq), len(tm))
""")


def test_port_runs_without_jax_pandas_sklearn_pil(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=tmp_path, text=True,
        capture_output=True,
        env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path)},
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout


CANOPY = textwrap.dedent("""
    import builtins
    import sys
    BLOCKED = ("jax", "jaxlib", "pandas", "sklearn", "PIL", "flax", "optax",
               "obia_tpu", "click", "tqdm", "matplotlib", "cv2")
    real_import = builtins.__import__

    def blocked(name, *a, **k):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"No module named {name!r} (blocked)")
        return real_import(name, *a, **k)

    builtins.__import__ = blocked

    import os
    import numpy as np
    import chip_smoke
    from obia_tpu_torch.io.gpkg import read_gpkg
    from obia_tpu_torch.io.tiff import TiffReader
    from obia_tpu_torch.utils.cost import make_cost_surface
    from obia_tpu_torch.utils.seeds import (make_canonical_seeds,
                                            make_chm_seeds,
                                            make_density_seeds)

    p = chip_smoke.write_canopy_inputs(".", 64, 0, "cpu", n_segments=12)
    make_chm_seeds(p["chm"], "chm_seeds.gpkg", device="cpu")
    make_density_seeds(p["density"], "den_seeds.gpkg", device="cpu")
    make_cost_surface(p["wv3"], p["chm"], "cost.tif", slic=p["slic"],
                      weights=(0.4, 0.2, 0.2, 0.2), device="cpu")
    out = make_canonical_seeds("chm_seeds.gpkg", "den_seeds.gpkg", p["chm"],
                               "cost.tif", "canonical.gpkg", device="cpu")
    cols, geoms, _ = read_gpkg("canonical.gpkg", layer="canonical_seeds")
    assert len(out) == len(geoms) > 3 and cols["id"] == list(range(len(out)))
    cost = TiffReader("cost.tif").read()
    assert ((cost == -9999) | ((cost >= 0) & (cost <= 1))).all()
    for mod in BLOCKED:
        assert mod not in sys.modules, mod
    print("CANOPY_OK", len(out))
""")


def test_canopy_runs_without_jax_pandas_sklearn_pil(tmp_path):
    """chm-seeds -> density-seeds -> cost-surface (with a SLIC layer in
    EPSG:4326) -> canonical-seeds at 64^2, with OpenCV blocked too."""
    proc = subprocess.run(
        [sys.executable, "-c", CANOPY], cwd=tmp_path, text=True,
        capture_output=True,
        env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path)},
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "CANOPY_OK" in proc.stdout


DETECTION = textwrap.dedent("""
    import builtins
    import sys
    BLOCKED = ("jax", "jaxlib", "pandas", "sklearn", "PIL", "flax", "optax",
               "obia_tpu", "click", "tqdm", "matplotlib", "cv2")
    real_import = builtins.__import__

    def blocked(name, *a, **k):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"No module named {name!r} (blocked)")
        return real_import(name, *a, **k)

    builtins.__import__ = blocked

    import json
    import os
    import numpy as np
    import obia_tpu_torch.utils.training
    from obia_tpu_torch.detection import (build_detection_model, predict,
                                          train_model)
    from obia_tpu_torch.detection.dataset import (DataLoader,
                                                  TreeDetectionDataset)
    from obia_tpu_torch.detection.metrics import evaluate_model
    from obia_tpu_torch.detection.utils import get_transforms
    from obia_tpu_torch.geometry.affine import Affine
    from obia_tpu_torch.io.tiff import write_tiff

    rng = np.random.default_rng(0)
    ann = {}
    for i in range(4):
        img = (rng.random((96, 112, 4)) * 3000).astype(np.uint16)
        x0, y0 = (int(v) for v in rng.integers(8, 60, 2))
        img[y0:y0 + 24, x0:x0 + 24] += 30000
        write_tiff(f"t{i}.tif", img, transform=Affine(1, 0, 0, 0, -1, 96))
        ann[str(i)] = {"file_name": f"t{i}.tif", "labels": [1],
                       "boxes": [[x0, y0, x0 + 24, y0 + 24]]}
    with open("annotations.json", "w") as f:
        json.dump(ann, f)
    model = build_detection_model(num_classes=2, in_channels=4,
                                  backbone_width=8, fpn_channels=32,
                                  stage_sizes=(1, 1, 1, 1), device="cpu")
    ds = TreeDetectionDataset(".", "annotations.json",
                              transforms=get_transforms(True))
    train_model(model, DataLoader(ds, batch_size=2, seed=0), num_epochs=1,
                checkpoint_dir="ckpt")
    assert os.path.exists(os.path.join("ckpt", "epoch_1.npz"))
    out = predict(model, "t0.tif", score_threshold=0.0)
    assert len(out["boxes"]) > 0 and out["boxes"][:, 2].max() <= 112
    res = evaluate_model(model, TreeDetectionDataset(".",
                                                     "annotations.json"))
    assert res["n_images"] == 4 and 0.0 <= res["AP"] <= 1.0
    for mod in BLOCKED:
        assert mod not in sys.modules, mod
    print("DETECTION_OK", len(out["boxes"]))
""")


def test_detection_runs_without_jax_pandas_sklearn_pil(tmp_path):
    """The detection path at width 8 on the CPU: build, one epoch of
    ``train_model`` on GeoTIFF tiles with a checkpoint, ``predict`` on a
    GeoTIFF, ``evaluate_model``, with PIL, matplotlib, tqdm and OpenCV
    blocked too."""
    proc = subprocess.run(
        [sys.executable, "-c", DETECTION], cwd=tmp_path, text=True,
        capture_output=True,
        env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path)},
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "DETECTION_OK" in proc.stdout


def test_port_sources_never_import_jax():
    """No source of the port, of ``obia_torch`` nor chip_smoke.py imports
    jax, flax, optax, tqdm, the JAX package, the ``obia`` namespace or the
    repository's bench.py (the port has its own,
    ``obia_tpu_torch/bench.py``), and ``obia_torch`` names no module of the
    JAX package; PIL, matplotlib and OpenCV only inside a function (a
    machine with only torch, numpy and scipy has none of them)."""
    bad = []
    sources = [*(REPO / "obia_tpu_torch").rglob("*.py"),
               *(REPO / "obia_torch").rglob("*.py"), REPO / "chip_smoke.py"]
    for path in sources:
        text = path.read_text()
        if path.is_relative_to(REPO / "obia_torch") and \
                text.count("obia_tpu") != text.count("obia_tpu_torch"):
            bad.append(f"{path}: names obia_tpu")
        for n, line in enumerate(text.splitlines(), 1):
            words = line.strip().split()
            if words[:1] not in (["import"], ["from"]) or len(words) < 2:
                continue
            top = words[1].split(".")[0]
            if top in ("jax", "jaxlib", "obia_tpu", "obia", "flax", "optax",
                       "tqdm", "bench") or (top in ("PIL", "matplotlib", "cv2")
                                   and not line[:1].isspace()):
                bad.append(f"{path}:{n}")
    assert (sorted(p.relative_to(REPO / "obia_torch")
                   for p in (REPO / "obia_torch").rglob("*.py"))
            == sorted(p.relative_to(REPO / "obia")
                      for p in (REPO / "obia").rglob("*.py")))
    assert not bad, bad
