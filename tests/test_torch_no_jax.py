"""obia_tpu_torch runs with jax, pandas, sklearn and PIL unavailable, as on
a machine that has only torch, numpy and scipy: the port imports none of
them on its main path, and never loads jax."""
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

SCRIPT = textwrap.dedent("""
    import builtins
    import sys
    BLOCKED = ("jax", "jaxlib", "pandas", "sklearn", "PIL", "flax", "optax")
    real_import = builtins.__import__

    def blocked(name, *a, **k):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"No module named {name!r} (blocked)")
        return real_import(name, *a, **k)

    builtins.__import__ = blocked

    import numpy as np
    import torch
    import obia_tpu_torch
    from obia_tpu.geometry.affine import Affine
    from obia_tpu_torch.classification.forest import (ForestArrays,
                                                      forest_proba)
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
        classes=[0, 1], max_depth=1)
    p = forest_proba(forest, torch.as_tensor(X)).numpy()
    assert np.allclose(p.sum(1), 1.0)
    for mod in BLOCKED:
        assert mod not in sys.modules, mod
    print("NO_JAX_OK", len(t), f)
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
    for path in (REPO / "obia_tpu_torch").rglob("*.py"):
        for n, line in enumerate(path.read_text().splitlines(), 1):
            words = line.strip().split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1 and \
                    words[1].split(".")[0] in ("jax", "jaxlib"):
                bad.append(f"{path}:{n}")
    assert not bad, bad
