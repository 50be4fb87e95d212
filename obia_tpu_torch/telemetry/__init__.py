"""Per-stage wall-clock timers, a span log and counters (port of
``obia_tpu/telemetry``).

``stage`` records each run of a named block in a process-wide registry that
``report()`` reads. With profiling on (``OBIA_PROFILE=1`` or ``enable()``),
every stage synchronises the CUDA device when it starts and when it ends, so
the asynchronous kernels a stage launched are charged to that stage and not
to the next one; stages also print as they complete. A device stage also
records the most device memory allocated while it ran (``peak_bytes`` in
``report()``): it resets the card's peak counter as it starts and carries
its own peak into the stage around it, so with profiling on
``torch.cuda.max_memory_allocated()`` no longer covers a whole run. With
profiling off no stage synchronises or reads the card's memory, and the
device runs ahead of the host as usual.

While profiling is on or a ``torch.profiler`` is recording, every stage
also logs a :class:`Span`: its name, its start and end on
``time.time_ns()`` (the clock of the profiler's events), its thread, the
span it opened inside and the outermost span of that chain (its root).
``spans()`` returns the newest :data:`SPAN_CAPACITY` of them. Under a
recording profiler a stage also opens ``torch.profiler.record_function``
under its own name, so the profiler's trace shows it around the device
work it launched. A stage run with neither pays for none of this.
Work handed to another thread keeps its place in the chain when it runs
in a copy of the submitting context (``contextvars.copy_context().run``).
The pipeline opens no stage around a whole scene, so on its own each
top-level stage (``image.convert``, ``segment.kernel``, ...) is a root;
a caller that wants one id for a scene opens a stage around it.

``count(name, n)`` adds to a named counter (kernel launches, host-synced
sweeps); counters always count, and ``counters()`` and ``report()`` (as
``{"total": n}`` under the counter's name) read them.

``timed`` is the decorator form of ``stage``; ``trace(log_dir)`` records a
``torch.profiler`` trace of a block (CUDA activity included where a card is
present) and writes it to ``log_dir`` as a Chrome trace. ``reset()`` clears
the stages, the span log and the counters.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
import itertools
import os
import threading
import time
from collections import defaultdict, deque
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

SPAN_CAPACITY = 65_536  # the span log keeps this many of the newest spans

_records: Dict[str, List[float]] = defaultdict(list)
_extra: Dict[str, Dict[str, float]] = defaultdict(dict)
# per open device stage: [the card's peak counter when it began (the
# enclosing stage's so far), the largest peak of the stages nested in it]
_peaks: List[List[int]] = []
_enabled = os.environ.get("OBIA_PROFILE", "0") not in ("0", "", "false")
_spans: deque = deque(maxlen=SPAN_CAPACITY)
_span_ids = itertools.count(1)
# (id, root id) of the innermost span open in this context, or None
_open: contextvars.ContextVar[Optional[Tuple[int, int]]] = \
    contextvars.ContextVar("obia_tpu_torch_open_span", default=None)
_counters: Dict[str, int] = {}
_counters_lock = threading.Lock()
_profiler_recording = torch._C._autograd._profiler_enabled


class Span(NamedTuple):
    """One run of a stage; times in ``time.time_ns()`` nanoseconds."""
    name: str
    start_ns: int
    end_ns: int
    thread: int             # its thread's ``native_id``
    id: int
    parent: Optional[int]   # the span it ran inside, or None
    root: int               # the outermost span of its chain (its own id)


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


def is_enabled() -> bool:
    return _enabled


def reset() -> None:
    _records.clear()
    _extra.clear()
    _spans.clear()
    with _counters_lock:
        _counters.clear()


def spans() -> List[Span]:
    """The span log, oldest first (at most :data:`SPAN_CAPACITY`)."""
    return list(_spans)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _counters_lock:
        _counters[name] = _counters.get(name, 0) + n


def counters() -> Dict[str, int]:
    """Every counter's total since the last :func:`reset`."""
    with _counters_lock:
        return dict(_counters)


def _on_card() -> bool:
    return (_enabled and torch.cuda.is_available()
            and torch.cuda.is_initialized())


def sync(x=None):
    """Wait for the CUDA device when profiling is on (a no-op otherwise, and
    on a process that never touched CUDA). Returns ``x``."""
    if _on_card():
        torch.cuda.synchronize()
    return x


class _OpenSpan:
    """A span from its start to :meth:`close`: its place in the chain of
    open spans and, under a recording profiler, its ``record_function``."""

    __slots__ = ("name", "id", "parent", "root", "token", "annotation",
                 "start_ns")

    def __init__(self, name: str):
        self.name = name
        self.id = next(_span_ids)
        outer = _open.get()
        self.parent, self.root = (outer if outer is not None
                                  else (None, self.id))
        self.token = _open.set((self.id, self.root))
        self.annotation = None
        if _profiler_recording():
            self.annotation = torch.profiler.record_function(name)
            self.annotation.__enter__()
        self.start_ns = time.time_ns()

    def close(self) -> None:
        end = time.time_ns()
        if self.annotation is not None:
            self.annotation.__exit__(None, None, None)
        _open.reset(self.token)
        # the id the thread stored when it started: get_native_id() is a
        # system call, slow on a host that traps system calls
        _spans.append(Span(self.name, self.start_ns, end,
                           threading.current_thread().native_id, self.id,
                           self.parent, self.root))


@contextlib.contextmanager
def stage(name: str, megapixels: Optional[float] = None,
          host_only: bool = False):
    """Time a pipeline stage; optionally record MP throughput.
    ``host_only`` marks host work that runs beside the device (the
    background polygonisation): it never waits for the device."""
    memory = not host_only and _on_card()
    if not host_only:
        sync()
    if memory:
        _peaks.append([torch.cuda.max_memory_allocated(), 0])
        torch.cuda.reset_peak_memory_stats()
    span = _OpenSpan(name) if _enabled or _profiler_recording() else None
    t0 = time.perf_counter()
    try:
        yield
    finally:
        try:
            if not host_only:
                sync()
        finally:
            dt = time.perf_counter() - t0
            if span is not None:
                span.close()
        _records[name].append(dt)
        if memory:
            before, nested = _peaks.pop()
            peak = max(torch.cuda.max_memory_allocated(), nested)
            _extra[name]["peak_bytes"] = max(
                _extra[name].get("peak_bytes", 0), peak)
            if _peaks:
                _peaks[-1][1] = max(_peaks[-1][1], before, peak)
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
    """Aggregated stage timings, {stage: {count, total_s, mean_s, ...}},
    and each counter as {counter: {total}}."""
    out = {name: {"count": len(t), "total_s": sum(t),
                  "mean_s": sum(t) / len(t), "last_s": t[-1],
                  **_extra.get(name, {})}
           for name, t in _records.items()}
    out.update((name, {"total": n}) for name, n in counters().items())
    return out


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a ``torch.profiler`` trace of the enclosed block, with CUDA
    activity when a card is present, and write it to ``log_dir`` as a Chrome
    trace (``trace_<pid>_<n>.json``, viewable in Perfetto). Every stage run
    inside shows as a ``record_function`` range. Yields the profiler."""
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
