"""Device activity from a ``torch.profiler`` run, read from its raw events.

The events' clock is the host's ``time.time_ns()``, so the benchmark's own
spans, taken on that clock, name what the host was doing in each gap
between device operations. No trace file is written.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

GAP_FLOOR_NS = 20_000  # gaps shorter than this are launch spacing


class DeviceTrace:
    """The device's operations (kernels, copies, sets) and the host's
    operator events of one profiled window [t0, t1] (ns), with the
    benchmark's spans [(name, start, end)] on the same clock."""

    def __init__(self, events, t0: int, t1: int, spans):
        self.t0, self.t1 = int(t0), int(t1)
        self.spans = sorted(spans, key=lambda s: s[1])
        dev, host = [], []
        for e in events:
            if _annotation(e):
                continue
            start = int(e.start_ns())
            end = start + int(e.duration_ns())
            if end <= self.t0 or start >= self.t1:
                continue
            kind = str(e.device_type()).rsplit(".", 1)[-1]
            (dev if kind == "CUDA" else host).append((e.name(), start, end))
        self.device = sorted(dev, key=lambda d: d[1])
        host.sort(key=lambda h: h[1])
        self.host = host
        self._host_starts = [h[1] for h in host]

    @property
    def empty(self) -> bool:
        return not self.device

    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def _busy(self):
        """Merged device intervals, clipped to the window."""
        out = []
        for _, s, e in self.device:
            s, e = max(s, self.t0), min(e, self.t1)
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self._busy()) / 1e9

    def kernel_s(self, prefixes) -> float:
        """Seconds of the device operations whose names, past a leading
        ``void `` (a template's return type), start with one of
        ``prefixes``."""
        return sum(e - s for n, s, e in self.device
                   if n.removeprefix("void ").startswith(tuple(prefixes))
                   ) / 1e9

    def top_ops(self, n: int = 10) -> list:
        """The ``n`` device operations (by name without its argument
        list) that took the most seconds."""
        tot = defaultdict(int)
        for name, s, e in self.device:
            tot[short_name(name)] += e - s
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v / 1e9] for k, v in top]

    def _span_at(self, t: int) -> str:
        for name, s, e in self.spans:
            if s <= t < e:
                return name
        return "between"

    def _host_op_at(self, t: int) -> str:
        """The innermost host operator running at ``t``, if any."""
        i = bisect.bisect_right(self._host_starts, t) - 1
        for j in range(i, max(-1, i - 400), -1):
            name, _, e = self.host[j]
            if e >= t:
                return name
        return "python"

    def idle_gaps(self, n: int = 10) -> list:
        """Idle seconds summed by what the host was doing at each gap's
        midpoint (the benchmark's span, then the host operator), the ``n``
        largest."""
        busy = self._busy()
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        tot = defaultdict(int)
        for a, b in zip(edges[0::2], edges[1::2]):
            if b - a < GAP_FLOOR_NS:
                continue
            mid = (a + b) // 2
            tot[f"{self._span_at(mid)}:{self._host_op_at(mid)}"] += b - a
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v / 1e9] for k, v in top]


def _annotation(e) -> bool:
    """A user annotation (``record_function``, an optimizer's step), which
    the profiler also puts on the device's timeline: a span, no work."""
    flag = getattr(e, "is_user_annotation", None)
    if flag is not None and flag():
        return True
    kind = getattr(e, "activity_type", None)
    return kind is not None and "annotation" in str(kind()).lower()


def short_name(name: str, width: int = 120) -> str:
    """A kernel's name without its trailing argument list, cut to
    ``width`` characters."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name.strip()[:width]


def device_events(prof) -> list:
    """The raw events of a finished ``torch.profiler.profile``."""
    return list(prof.profiler.kineto_results.events())

