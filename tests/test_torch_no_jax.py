"""obia_tpu_torch runs with jax, pandas, sklearn, PIL and the JAX package
``obia_tpu`` unavailable, as on a machine that has only torch, numpy and
scipy: the port imports none of them on its main paths (SLIC + forest,
quickshift + MLP, the sharded mosaic on a 2 x 4 CPU mesh), and never loads
jax, flax or optax. Its sources and ``chip_smoke.py`` import neither jax
nor ``obia_tpu``."""
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

SCRIPT = textwrap.dedent("""
    import builtins
    import sys
    BLOCKED = ("jax", "jaxlib", "pandas", "sklearn", "PIL", "flax", "optax",
               "obia_tpu")
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

    from obia_tpu_torch.parallel.mesh import make_mesh
    from obia_tpu_torch.parallel.mosaic import mosaic_pipeline
    tm = mosaic_pipeline(image, n_segments=12, mesh=make_mesh(8, ["cpu"]),
                         objects_kwargs={"glcm_levels": 32})
    assert len(tm) > 3 and len(tm.geometry) == len(tm)
    assert np.isfinite(tm["b0_mean"]).all()
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


def test_port_sources_never_import_jax():
    bad = []
    sources = [*(REPO / "obia_tpu_torch").rglob("*.py"),
               REPO / "chip_smoke.py"]
    for path in sources:
        for n, line in enumerate(path.read_text().splitlines(), 1):
            words = line.strip().split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1 and \
                    words[1].split(".")[0] in ("jax", "jaxlib", "obia_tpu"):
                bad.append(f"{path}:{n}")
    assert not bad, bad
