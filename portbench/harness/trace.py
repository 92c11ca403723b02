"""The device trace of a window and its reduction.

``busy_union`` is frozen from ``cli/profile_generate._busy_us`` at commit
b5205ad5a7d96ed2c2fe9e7fed8fc49e99a4e0cc: the union of the kernels' device
intervals. ``Trace`` reads the profiler's raw Kineto events (not the
per-operator tree, whose construction takes minutes at ~10^5 kernels)."""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Tuple


def busy_union(spans: List[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """Union length of (start, end) intervals and the merged intervals."""
    merged: List[Tuple[float, float]] = []
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
                merged.append((cur_s, cur_e))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
        merged.append((cur_s, cur_e))
    return total, merged


def _ns(ev, what: str) -> float:
    """An event's start or duration in ns, across profiler versions."""
    f = getattr(ev, f"{what}_ns", None)
    if f is not None:
        return float(f())
    return float(getattr(ev, f"{what}_us")()) * 1e3


@dataclass
class Trace:
    """One traced window: the device operations (name, start, end; seconds
    on the host's timeline), the host operators, and the window's bounds."""

    window: Tuple[float, float]
    device: List[Tuple[str, float, float]] = field(default_factory=list)
    host: List[Tuple[str, float, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_s(self) -> float:
        return busy_union([(s, e) for _, s, e in self.device])[0]

    def device_s(self, match) -> float:
        """Summed device time of the operations whose name ``match`` accepts."""
        return sum(e - s for n, s, e in self.device if match(n))

    def count(self, match=lambda n: True) -> int:
        return sum(1 for n, _, _ in self.device if match(n))

    def top_ops(self, k: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for n, s, e in self.device:
            by[n] = by.get(n, 0.0) + (e - s)
        return [[n[:160], t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """Idle time of the device inside the window, summed by the innermost
        host operator running at each gap's midpoint ("python" where none)."""
        lo, hi = self.window
        merged = busy_union([(max(s, lo), min(e, hi)) for _, s, e in self.device
                             if e > lo and s < hi])[1]
        edges = [lo] + [x for se in merged for x in se] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        by: Dict[str, float] = {}
        for s, e in gaps:
            mid = 0.5 * (s + e)
            best = None
            i = bisect.bisect_right(starts, mid)
            for name, hs, he in host[max(0, i - 2000): i][::-1]:
                if hs <= mid <= he and (best is None or he - hs < best[1]):
                    best = (name, he - hs)
            key = best[0] if best else "python"
            by[key] = by.get(key, 0.0) + (e - s)
        return [[n[:160], t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:k]]


def collect(prof, start_ns: int, end_ns: int) -> Trace:
    """A ``Trace`` from a finished ``torch.profiler.profile``; ``start_ns``
    and ``end_ns`` are ``time.time_ns()`` at the traced window's bounds, on
    the clock of the profiler's event timestamps (nanoseconds of the epoch).
    Times are returned in seconds from ``start_ns``."""
    from torch.autograd import DeviceType

    trace = Trace(window=(0.0, (end_ns - start_ns) * 1e-9))
    for ev in prof.profiler.kineto_results.events():
        start = (_ns(ev, "start") - start_ns) * 1e-9
        end = start + _ns(ev, "duration") * 1e-9
        if ev.device_type() == DeviceType.CUDA:
            trace.device.append((ev.name(), start, end))
        else:
            trace.host.append((ev.name(), start, end))
    return trace
