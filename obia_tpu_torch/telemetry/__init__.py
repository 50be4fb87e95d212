"""Per-stage wall-clock timers (port of ``obia_tpu/telemetry``).

``stage`` records each run of a named block in a process-wide registry that
``report()`` reads. With profiling on (``OBIA_PROFILE=1`` or ``enable()``),
every stage synchronises the CUDA device when it starts and when it ends, so
the asynchronous kernels a stage launched are charged to that stage and not
to the next one; stages also print as they complete. With profiling off no
stage synchronises, and the device runs ahead of the host as usual.
``timed`` is the decorator form of ``stage``; ``trace(log_dir)`` records a
``torch.profiler`` trace of a block (CUDA activity included where a card is
present) and writes it to ``log_dir`` as a Chrome trace.
"""
from __future__ import annotations

import contextlib
import functools
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

_records: Dict[str, List[float]] = defaultdict(list)
_extra: Dict[str, Dict[str, float]] = defaultdict(dict)
_enabled = os.environ.get("OBIA_PROFILE", "0") not in ("0", "", "false")


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


def is_enabled() -> bool:
    return _enabled


def reset() -> None:
    _records.clear()
    _extra.clear()


def sync(x=None):
    """Wait for the CUDA device when profiling is on (a no-op otherwise, and
    on a process that never touched CUDA). Returns ``x``."""
    if _enabled and torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return x


@contextlib.contextmanager
def stage(name: str, megapixels: Optional[float] = None,
          host_only: bool = False):
    """Time a pipeline stage; optionally record MP throughput.
    ``host_only`` marks host work that runs beside the device (the
    background polygonisation): it never waits for the device."""
    if not host_only:
        sync()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if not host_only:
            sync()
        dt = time.perf_counter() - t0
        _records[name].append(dt)
        if megapixels is not None and dt > 0:
            _extra[name]["total_mp"] = (_extra[name].get("total_mp", 0.0)
                                        + megapixels)
            _extra[name]["mp_per_s"] = (_extra[name]["total_mp"]
                                        / sum(_records[name]))
        if _enabled:
            mp = (f"  [{megapixels / dt:.2f} MP/s]"
                  if megapixels is not None and dt > 0 else "")
            print(f"[obia_tpu_torch] {name}: {dt * 1000:.1f} ms{mp}",
                  flush=True)


def timed(name: Optional[str] = None):
    """Decorator form of :func:`stage` (the stage is named ``name``, or
    the function's qualified name)."""
    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with stage(label):
                return fn(*args, **kwargs)
        return wrapper
    return deco


def report() -> Dict[str, Dict[str, float]]:
    """Aggregated stage timings: {stage: {count, total_s, mean_s, ...}}."""
    return {name: {"count": len(t), "total_s": sum(t),
                   "mean_s": sum(t) / len(t), "last_s": t[-1],
                   **_extra.get(name, {})}
            for name, t in _records.items()}


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a ``torch.profiler`` trace of the enclosed block, with CUDA
    activity when a card is present, and write it to ``log_dir`` as a Chrome
    trace (``trace_<pid>_<n>.json``, viewable in Perfetto). Yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            # the block's kernels finish inside the trace
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()
    n = len([f for f in os.listdir(log_dir) if f.startswith("trace_")])
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_{os.getpid()}_{n}.json"))
