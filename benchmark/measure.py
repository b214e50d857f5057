"""Host clocks, percentiles, and the profiler trace of part of a window.

``Tracer`` runs ``torch.profiler`` (host and device activity) over a span
of the measured window that the traffic file sets (``trace_lead_s``,
``trace_s``), and sums the trace into a ``TraceSummary``: the device's
busy seconds (the union of the intervals in which any device operation
ran), device seconds by kernel name, and the idle seconds between device
operations by what the host was doing (the innermost host range open at
the gap's middle, under the benchmark's own ``bench.*`` range). Its
approach, sums by kernel name from the profiler with the ranges of host
ops left out, is ``chip_smoke.py:device_rows``'.
"""

from __future__ import annotations

import bisect
import dataclasses
import math
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100) of all ``values``, by linear
    interpolation between order statistics (numpy's default)."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def describe(name: str, values: Sequence[float], scale: float = 1e3, unit: str = "ms") -> str:
    """One line: count, median and 95th percentile of a sample."""
    return (f"{name}: n={len(values)} median={percentile(values, 50) * scale!r} {unit} "
            f"p95={percentile(values, 95) * scale!r} {unit} "
            f"beyond_p95={sum(v > percentile(values, 95) for v in values)}")


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float]
    kernel_n: Dict[str, int]
    idle_s: Dict[str, float]

    def device_s(self, patterns: Sequence[str]) -> float:
        """Device seconds of the kernels whose names hold any of
        ``patterns``."""
        return sum(s for name, s in self.kernel_s.items() if any(p in name for p in patterns))

    def breakdown(self) -> Dict[str, List[List]]:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_s.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[name[:120], s] for name, s in ops],
                "idle_gaps": [[name[:120], s] for name, s in gaps]}


class Tracer:
    """Profiles from ``lead_s`` after the window opens for ``length_s``.
    Drivers call ``poll()`` between units of work (or ``start`` / ``stop``
    around whole ones); nothing happens unless ``enabled``. The trace is
    read only once the window has closed."""

    def __init__(self, enabled: bool, lead_s: float, length_s: float):
        self.enabled = enabled
        self.lead_s, self.length_s = lead_s, length_s
        self.window_open: Optional[float] = None
        self._prof = None
        self._t: Tuple[float, float] = (0.0, 0.0)
        self._done = None  # the stopped profiler, summed on first use
        self._summary: Optional[TraceSummary] = None

    @property
    def summary(self) -> Optional[TraceSummary]:
        """The trace's sums; computed on first use, after the window."""
        if self._summary is None and self._done is not None:
            self._summary = summarize(self._done, self._t[1] - self._t[0])
            self._done = None
        return self._summary

    @property
    def active(self) -> bool:
        return self._prof is not None

    def open_window(self) -> None:
        """Mark the window's start; when tracing, first start and stop the
        profiler once, so that its one-time start-up is not in the window."""
        if self.enabled:
            self.start()
            self._prof.stop()
            self._prof = None
        self.window_open = time.perf_counter()

    def poll(self) -> None:
        if not self.enabled or self._t[1]:
            return
        now = time.perf_counter()
        if self._prof is None and now >= self.window_open + self.lead_s:
            self.start()
        elif self._prof is not None and now >= self._t[0] + self.length_s:
            self.stop()

    def start(self) -> None:
        if not self.enabled or self._prof is not None or self._t[1]:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.start()
        self._t = (time.perf_counter(), 0.0)

    def stop(self) -> None:
        if self._prof is None:
            return
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._t = (self._t[0], time.perf_counter())
        self._done, self._prof = self._prof, None
        self._done.stop()


def summarize(prof, window_s: float) -> TraceSummary:
    from torch.autograd import DeviceType

    events = prof.events()
    host = [e for e in events if e.device_type == DeviceType.CPU]
    host_names = {e.name for e in host}
    device = [e for e in events if e.device_type != DeviceType.CPU and e.name not in host_names]
    kernel_s: Dict[str, float] = defaultdict(float)
    kernel_n: Dict[str, int] = defaultdict(int)
    spans = []
    for e in device:
        start, end = e.time_range.start, e.time_range.end
        kernel_s[e.name] += (end - start) * 1e-6
        kernel_n[e.name] += 1
        spans.append((start, end))
    spans.sort()
    merged: List[List[float]] = []
    for start, end in spans:
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    busy_s = sum(end - start for start, end in merged) * 1e-6
    idle_s = _label_gaps(host, merged)
    return TraceSummary(window_s, busy_s, dict(kernel_s), dict(kernel_n), idle_s)


def _label_gaps(host, merged) -> Dict[str, float]:
    """Idle seconds between device operations, by the host's innermost
    range open at each gap's middle (``bench.*`` range first)."""
    ranges = sorted((e.time_range.start, e.time_range.end, e.name) for e in host)
    starts = [r[0] for r in ranges]
    ours = [r for r in ranges if r[2].startswith("bench.")]
    our_starts = [r[0] for r in ours]
    idle: Dict[str, float] = defaultdict(float)

    def innermost(rs, rs_starts, t, scan=4096) -> str:
        i = bisect.bisect_right(rs_starts, t) - 1
        stop = max(-1, i - scan)
        while i > stop:
            if rs[i][1] >= t:
                return rs[i][2]
            i -= 1
        return ""

    for (_, prev_end), (next_start, _) in zip(merged, merged[1:]):
        gap = next_start - prev_end
        if gap <= 0:
            continue
        mid = prev_end + gap / 2
        outer, inner = innermost(ours, our_starts, mid), innermost(ranges, starts, mid)
        label = " > ".join(dict.fromkeys(x for x in (outer, inner) if x)) or "no host op"
        idle[label] += gap * 1e-6
    return dict(idle)


def finite(x: Optional[float]) -> Optional[float]:
    return x if x is not None and math.isfinite(x) else None
