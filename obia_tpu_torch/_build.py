"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Every ``csrc/*.cu`` file is compiled, at first use, to an object file by
its own nvcc process (all started together), and the objects are linked into
one shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -c -Xcompiler -fPIC x.cu
    nvcc -shared -o libobia_kernels_<hash>.so *.o

The library lands in ``build/kernels/`` beside the package, named by a hash
of the sources, so an edited source is rebuilt and an unchanged one is
loaded as it is. No source includes PyTorch's headers, which keeps a build at
seconds. Importing this module builds nothing and needs no CUDA toolkit.

Each C entry point takes every pointer and the stream as ``void*`` and
returns ``cudaGetLastError()`` after its launch; the Python wrappers raise
when that is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of this process's build


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the CUDA kernels")


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return BUILD_DIR / f"libobia_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the sources unless the library for them exists; returns
    its path. Raises with nvcc's output when the build fails."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-c", "-Xcompiler",
         "-fPIC", "-Xptxas", "-v", "-o", str(obj), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for src, obj in zip(_sources(), objs)]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        logs = [proc.communicate()[1].strip() for proc in procs]
        for src, proc, log in zip(_sources(), procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} "
                                   f"({proc.returncode}):\n{log}")
        res = subprocess.run([_nvcc(), *ARCH_FLAGS, "-shared", "-o",
                              str(tmp), *map(str, objs)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{res.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    if verbose:
        print("\n".join(logs), flush=True)
    os.replace(tmp, out)  # atomic: a concurrent build never loads a torn file
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first call and cached in-process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            lib.obia_glcm_sums.argtypes = [p, p, ll, ll, ll, p, p, p, ll, i,
                                           ctypes.POINTER(i), i, p, p, p, p]
            lib.obia_glcm_sums.restype = i
            lib.obia_glcm_spanner_hist.argtypes = [
                p, p, i, ll, ll, ll, i, p, p, p, ll, p, p, ll, i,
                ctypes.POINTER(i), i, p, p, p]
            lib.obia_glcm_spanner_hist.restype = i
            f = ctypes.c_float
            lib.obia_qs_density.argtypes = [p, i, ll, ll, i, i, i, f, p, p]
            lib.obia_qs_density.restype = i
            lib.obia_qs_parent.argtypes = [p, p, i, ll, ll, i, i, i, f, p, p,
                                           p]
            lib.obia_qs_parent.restype = i
            lib.obia_qs_attributes.argtypes = [i, i, ctypes.POINTER(i)]
            lib.obia_qs_attributes.restype = i
            lib.obia_slic_pass.argtypes = [p, p, p, p, i, ll, ll, ll, ll, ll,
                                           ll, i, i, f, f, f, f, i, i, i, i,
                                           p, p, p]
            lib.obia_slic_pass.restype = i
            _lib = lib
        return _lib
