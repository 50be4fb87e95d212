"""The share of the profiled scenes' device-idle time (gaps of at least
``trace.GAP_FLOOR_NS``) in which the main thread had no span of the
program open: the benchmark's own code and the Python between the
program's calls. The program's spans (``telemetry.spans()``, taken on the
profiler's clock) and the device's gaps are intersected exactly. A program
that logs no spans gives nothing to read."""
import threading

from benchmark.trace import GAP_FLOOR_NS


def merged(intervals) -> list:
    """Sorted, disjoint [start, end] intervals covering ``intervals``
    (the spans nest, so they overlap)."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif s < e:
            out.append([s, e])
    return out


def idle_gaps(tr) -> list:
    """The device's idle gaps of ``tr``'s window, each at least
    ``GAP_FLOOR_NS`` long, between the busy intervals of
    ``DeviceTrace._busy`` (as its own ``idle_gaps`` takes them)."""
    edges = [tr.t0] + [x for iv in tr._busy() for x in iv] + [tr.t1]
    return [(a, b) for a, b in zip(edges[0::2], edges[1::2])
            if b - a >= GAP_FLOOR_NS]


def overlap_ns(a: list, b: list) -> int:
    """Nanoseconds that two sorted, disjoint interval lists share."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr.empty:
        return None
    from obia_tpu_torch import telemetry
    spans = getattr(telemetry, "spans", None)
    if spans is None:
        return None
    main = threading.main_thread().native_id
    opened = merged((max(s.start_ns, tr.t0), min(s.end_ns, tr.t1))
                    for s in spans() if s.thread == main)
    gaps = idle_gaps(tr)
    idle = sum(b - a for a, b in gaps)
    if idle == 0:
        return 0.0
    return 100.0 * (idle - overlap_ns(gaps, opened)) / idle
