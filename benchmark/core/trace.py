"""The traced run's instruments: wrappers around each layer's entry, and the
reduction of a profiler window to what the per-layer metrics read.

A wrapper replaces a layer's entry where the program looks it up.  Around
every call it opens a profiler range ``bench::<layer>`` and, while
``timing`` is on, takes the host time; while ``profiling`` is on it counts
the call under its shape key.  Device time is attributed to ranges, not to
CUDA function names: each device activity is charged to the innermost
``bench::`` range that was open on the launching thread when it was
launched (the launch's correlation id ties the two).  Only aggregates leave
the profiler: nothing is written to disk.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import functools
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

PREFIX = "bench::"
# host calls of the CUDA runtime and driver APIs (the launches) are named so
LAUNCH_PREFIXES = ("cuda", "cu")


class Recorder:
    """Wrappers and what they count.  ``spans[label]``: host seconds of each
    call made while ``timing``; ``calls[label][key]``: calls made while
    ``profiling``, by the key ``shape(*args)`` gives."""

    def __init__(self):
        self.spans: Dict[str, List[float]] = collections.defaultdict(list)
        self.calls: Dict[str, collections.Counter] = collections.defaultdict(collections.Counter)
        self.timing = False
        self.profiling = False
        self._undo: List[Tuple[Any, str, Any]] = []

    def wrap(self, owner, attr: str, label: str,
             shape: Optional[Callable[..., Any]] = None) -> None:
        from torch.profiler import record_function

        orig = getattr(owner, attr)
        rec = self

        @functools.wraps(orig)  # keeps the attributes the program counts in
        def wrapper(*args, **kwargs):
            if shape is not None and rec.profiling:
                rec.calls[label][shape(*args, **kwargs)] += 1
            t0 = time.perf_counter()
            with record_function(PREFIX + label):
                out = orig(*args, **kwargs)
            if rec.timing:
                rec.spans[label].append(time.perf_counter() - t0)
            return out

        self._undo.append((owner, attr, orig))
        setattr(owner, attr, wrapper)

    def restore(self) -> None:
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo.clear()


@dataclasses.dataclass
class DeviceWindow:
    """One profiled window, reduced."""

    window_s: float
    busy_s: float
    activities: int
    device_s_by_range: Dict[str, float]  # innermost bench:: range at launch
    device_ops: List[Tuple[str, float]]  # by activity name, most time first
    idle_by_host: List[Tuple[str, float]]  # idle seconds by the host's range


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


class _Innermost:
    """Innermost open range at a time, per thread (ranges nest per thread)."""

    def __init__(self, ranges: List[Tuple[int, int, str]]):
        self.ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
        self.starts = [r[0] for r in self.ranges]
        self.parent: List[int] = []
        stack: List[int] = []
        for i, (s, _, _) in enumerate(self.ranges):
            while stack and self.ranges[stack[-1]][1] < s:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def at(self, t: int) -> Optional[str]:
        # the last range to start before t, or the nearest of its enclosing
        # ranges still open at t
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.ranges[i][1] < t:
            i = self.parent[i]
        return self.ranges[i][2] if i >= 0 else None


def reduce_profile(prof, window_label: str = "window", top: int = 10) -> DeviceWindow:
    """Reduce a ``torch.profiler.profile`` whose window is the
    ``bench::<window_label>`` range."""
    events = prof.profiler.kineto_results.events()
    ranges: Dict[int, List[Tuple[int, int, str]]] = collections.defaultdict(list)
    launches: Dict[int, Tuple[int, int]] = {}
    device: List[Tuple[int, int, str, int]] = []
    window = None
    import torch

    for e in events:
        name = e.name()
        start, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # kernels, copies and fills; a range's mirror on the device
            # timeline is no activity
            if not name.startswith(PREFIX):
                device.append((start, start + dur, name, e.correlation_id()))
        elif name.startswith(PREFIX):
            tid = e.start_thread_id()
            label = name[len(PREFIX):]
            if label == window_label:
                window = (start, start + dur, tid)
            else:
                ranges[tid].append((start, start + dur, label))
        elif name.startswith(LAUNCH_PREFIXES):
            launches[e.correlation_id()] = (e.start_thread_id(), start)
    if window is None:
        raise RuntimeError(f"profile holds no {PREFIX}{window_label} range")
    w0, w1, main_tid = window
    device = [d for d in device if d[1] > w0 and d[0] < w1]
    if not device:
        raise RuntimeError("the profiler recorded no device activity in the window")
    inner = {tid: _Innermost(rs) for tid, rs in ranges.items()}
    by_range: Dict[str, float] = collections.defaultdict(float)
    by_name: Dict[str, float] = collections.defaultdict(float)
    for s, e, name, corr in device:
        s, e = max(s, w0), min(e, w1)
        by_name[name[:120]] += (e - s) * 1e-9
        launch = launches.get(corr)
        if launch is None:
            label = "unlinked"  # no launch seen for it
        else:
            label = (inner[launch[0]].at(launch[1]) if launch[0] in inner else None) or "harness"
        by_range[label] += (e - s) * 1e-9
    busy = _merge([(max(s, w0), min(e, w1)) for s, e, _, _ in device])
    host = inner.get(main_tid)
    idle: Dict[str, float] = collections.defaultdict(float)
    t = w0
    for s, e in busy + [(w1, w1)]:
        if s > t:
            idle[(host.at(t) if host else None) or "harness"] += (s - t) * 1e-9
        t = max(t, e)
    busy_s = sum(e - s for s, e in busy) * 1e-9
    rank = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]  # noqa: E731
    return DeviceWindow(window_s=(w1 - w0) * 1e-9, busy_s=busy_s, activities=len(device),
                        device_s_by_range=dict(by_range), device_ops=rank(by_name),
                        idle_by_host=rank(idle))


@dataclasses.dataclass
class Trace:
    """What a per-layer metric's reader gets: the cell's kind (``serve`` or
    ``train``), its model's head blocks (``(D, V)`` each, the family's
    ``head_blocks``), the host spans and call counts of the wrappers, the
    units of work done (``chunks``, ``chars``, ``steps``, ``jobs``) in the
    timed and in the profiled part, the timed window's seconds, the useful
    operations of the profiled part by precision, the peaks, and the device
    window."""

    kind: str
    head_blocks: List[Tuple[int, int]]
    spans: Dict[str, List[float]]
    calls: Dict[str, collections.Counter]
    timed_units: Dict[str, int]
    timed_s: float
    profiled_units: Dict[str, int]
    useful_ops: Dict[str, float]
    peaks: Dict[str, float]
    device: DeviceWindow

    def untraced_s(self, unit: str) -> Optional[float]:
        """Seconds the timed window took for as much work, counted in
        ``unit``, as the profiled part did.  The profiler's host cost
        lengthens the profiled window itself, so shares of the time (idle,
        MFU) take the device's seconds from the trace over these."""
        done, profiled = self.timed_units.get(unit), self.profiled_units.get(unit)
        if not done or not profiled:
            return None
        return self.timed_s * profiled / done
