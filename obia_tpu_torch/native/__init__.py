"""The port's host-side native library, bound with ctypes.

``obia_native.cpp`` (beside this file) holds the sparse union-find that the
sharded CCL resolves its seams with, the polygoniser that traces every
object from the row-wise runs of the label raster, and the path-dependent
TreeSHAP that ``classify(method="rf", compute_shap=True)`` explains the
forest with. At first use it is built with ::

    g++ -O3 -std=c++17 -shared -fPIC -o build/native/libobia_native_<hash>.so

into ``build/native/`` beside the package, named by a hash of the source,
so an edited source is rebuilt and an unchanged one loaded as it is. The
build writes a temporary file and renames it into place, so processes that
import the package at once never load a torn library. A failed build
raises: there is no Python fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "obia_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libobia_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the source unless its library exists; returns its path.
    Raises with the compiler's output when the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        res = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC)],
                             capture_output=True, text=True, timeout=300)
    except OSError as exc:
        raise RuntimeError(f"cannot build the native library: {exc}") from exc
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {SRC.name} ({res.returncode}):\n"
                           f"{res.stderr[-4000:]}")
    os.replace(tmp, out)  # atomic: a concurrent build never loads a torn file
    return out


def load() -> ctypes.CDLL:
    """The native library, built on first call and cached in-process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p64 = ctypes.POINTER(ctypes.c_int64)
            p32 = ctypes.POINTER(ctypes.c_int32)
            pd = ctypes.POINTER(ctypes.c_double)
            i64 = ctypes.c_int64
            lib.resolve_components.argtypes = [p64, i64, p64, p64, i64, p64]
            lib.resolve_components.restype = None
            lib.polygonize_build_rle.argtypes = [p32, p32, i64, i64, i64,
                                                 ctypes.c_int]
            lib.polygonize_build_rle.restype = ctypes.c_void_p
            lib.polygonize_num_rings.argtypes = [ctypes.c_void_p]
            lib.polygonize_num_rings.restype = i64
            lib.polygonize_total_pts.argtypes = [ctypes.c_void_p]
            lib.polygonize_total_pts.restype = i64
            lib.polygonize_export.argtypes = [ctypes.c_void_p, p64, p64, pd,
                                              pd]
            lib.polygonize_export.restype = None
            lib.polygonize_free.argtypes = [ctypes.c_void_p]
            lib.polygonize_free.restype = None
            lib.tree_shap.argtypes = [p32, pd, p32, p32, pd, pd, i64,
                                      ctypes.c_int32, ctypes.c_int32, pd,
                                      i64, pd, ctypes.c_int32]
            lib.tree_shap.restype = None
            _lib = lib
        return _lib


def _p64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _p32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def resolve_components(comp: np.ndarray, pairs_a: np.ndarray,
                       pairs_b: np.ndarray) -> np.ndarray:
    """Union the (value, value) equivalence pairs and map every element of
    ``comp`` to its root, the smallest value of its class (-1 stays -1)."""
    comp = np.ascontiguousarray(comp, np.int64)
    a = np.ascontiguousarray(pairs_a, np.int64)
    b = np.ascontiguousarray(pairs_b, np.int64)
    out = np.empty_like(comp)
    load().resolve_components(_p64(comp.reshape(-1)), comp.size, _p64(a),
                              _p64(b), a.size, _p64(out.reshape(-1)))
    return out


def polygonize_rings_rle_packed(values: np.ndarray, lengths: np.ndarray,
                                shape, simplify: bool = True
                                ) -> Tuple[np.ndarray, np.ndarray,
                                           np.ndarray, np.ndarray]:
    """Trace every label of a row-wise RLE raster (runs break at row ends)
    into closed rings, O(runs + boundary pixels). Returns (labels (n,)
    int64, n_pts (n,) int64, signed_areas (n,) float64, coords (total, 2)
    float64 in pixel-corner (col, row) coordinates, the rings concatenated
    in order)."""
    lib = load()
    H, W = shape
    values = np.ascontiguousarray(values, np.int32)
    lengths = np.ascontiguousarray(lengths, np.int32)
    h = lib.polygonize_build_rle(_p32(values), _p32(lengths), len(values),
                                 H, W, 1 if simplify else 0)
    try:
        n = lib.polygonize_num_rings(h)
        total = lib.polygonize_total_pts(h)
        labels = np.empty(n, np.int64)
        n_pts = np.empty(n, np.int64)
        areas = np.empty(n, np.float64)
        coords = np.empty((total, 2), np.float64)
        pd = ctypes.POINTER(ctypes.c_double)
        lib.polygonize_export(h, _p64(labels), _p64(n_pts),
                              areas.ctypes.data_as(pd),
                              coords.ctypes.data_as(pd))
        return labels, n_pts, areas, coords
    finally:
        lib.polygonize_free(h)


def tree_shap_forest(rf, X: np.ndarray) -> np.ndarray:
    """Path-dependent TreeSHAP for a fitted forest with sklearn's fields
    (``estimators_[i].tree_`` and ``classes_``). Returns (n_samples,
    n_features, n_classes) float64 attributions to the class probabilities,
    averaged over the trees. A failed build of the library raises."""
    lib = load()
    X = np.ascontiguousarray(X, np.float64)
    n_samples, n_features = X.shape
    n_classes = len(rf.classes_)
    phi_total = np.zeros((n_samples, n_features + 1, n_classes), np.float64)
    phi = np.empty_like(phi_total)
    pd = ctypes.POINTER(ctypes.c_double)
    for est in rf.estimators_:
        t = est.tree_
        n = t.node_count
        feature = np.ascontiguousarray(t.feature, np.int32)
        # sklearn's thresholds are float64 midpoints of adjacent float32
        # feature values: a float32 copy can flip x <= threshold on a
        # boundary sample and attribute the wrong leaf
        threshold = np.ascontiguousarray(t.threshold, np.float64)
        idx = np.arange(n, dtype=np.int32)
        left = np.where(t.children_left < 0, idx,
                        t.children_left).astype(np.int32)
        right = np.where(t.children_right < 0, idx,
                         t.children_right).astype(np.int32)
        v = t.value[:, 0, :].astype(np.float64)
        v = np.ascontiguousarray(v / np.maximum(v.sum(axis=1, keepdims=True),
                                                1e-12))
        cover = np.ascontiguousarray(t.weighted_n_node_samples, np.float64)
        phi.fill(0.0)
        lib.tree_shap(_p32(feature), threshold.ctypes.data_as(pd),
                      _p32(left), _p32(right), v.ctypes.data_as(pd),
                      cover.ctypes.data_as(pd), n, n_classes, n_features,
                      X.ctypes.data_as(pd), n_samples, phi.ctypes.data_as(pd),
                      int(t.max_depth) + 1)
        phi_total += phi
    return phi_total[:, :n_features, :] / len(rf.estimators_)
