"""The program's own spans in a profiled window.

While the program's tracer is on (``jlm_tpu_torch.utils.profiling``) and a
profiler records, each of its spans is a profiler range ``jlm::<name>``:
``decode.job``, ``decode.pack``, ``decode.enqueue``, ``decode.fetch`` and
``decode.surfaces`` in the engine, ``train.forward``, ``train.backward`` and
``train.optimizer`` in the trainer.  ``reduce_spans`` reads them beside the
window's device activity:

- ``device_s_by_span`` charges each activity to the innermost program span
  open on its launching thread at the launch; where that thread has none
  open (autograd's worker thread, which launches the backward), to the
  innermost one open on the window's main thread at that time.
- ``idle_by_span`` splits each idle gap of the device over the main
  thread's innermost program span along the gap's whole length, not at its
  start alone.

Time under no program span is ``outside``.  ``without_program_ranges`` is
the same profile without the program's ranges: ``trace.reduce_profile``
counts a range's mirror on the device timeline as an activity unless the
range is the benchmark's own, so with the tracer on its readings are taken
from this view.  Nothing here imports the program.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import types
from typing import Dict, List, Optional, Tuple

from benchmark.core.trace import LAUNCH_PREFIXES, PREFIX as BENCH_PREFIX, _Innermost, _merge

PREFIX = "jlm::"
OUTSIDE = "outside"


@dataclasses.dataclass
class SpanWindow:
    window_s: float
    busy_s: float
    device_s_by_span: Dict[str, float]
    idle_by_span: Dict[str, float]

    @property
    def idle_s(self) -> float:
        return self.window_s - self.busy_s


class _Timeline:
    """The innermost range of one thread as a step function of time."""

    def __init__(self, ranges: List[Tuple[int, int, str]]):
        inner = _Innermost(ranges)
        self.cuts = sorted({t for s, e, _ in ranges for t in (s, e)})
        self.labels = [inner.at((a + b) / 2) for a, b in zip(self.cuts, self.cuts[1:])]

    def split(self, t0: int, t1: int, into: Dict[str, float]) -> None:
        """Add the seconds of ``[t0, t1)`` under each innermost range."""
        k = bisect.bisect_right(self.cuts, t0) - 1
        t = t0
        while t < t1:
            if k < 0:
                nxt, label = (self.cuts[0] if self.cuts else t1), None
            elif k >= len(self.labels):
                nxt, label = t1, None
            else:
                nxt, label = self.cuts[k + 1], self.labels[k]
            e = min(nxt, t1)
            into[label or OUTSIDE] += (e - t) * 1e-9
            t, k = e, k + 1


def reduce_spans(prof, window_label: str = "window") -> SpanWindow:
    """Reduce a ``torch.profiler.profile`` whose window is the
    ``bench::<window_label>`` range by the program's spans."""
    import torch

    ranges: Dict[int, List[Tuple[int, int, str]]] = collections.defaultdict(list)
    launches: Dict[int, Tuple[int, int]] = {}
    device: List[Tuple[int, int, int]] = []
    window = None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not name.startswith((BENCH_PREFIX, PREFIX)):
                device.append((start, start + dur, e.correlation_id()))
        elif name.startswith(PREFIX):
            ranges[e.start_thread_id()].append((start, start + dur, name[len(PREFIX):]))
        elif name == BENCH_PREFIX + window_label:
            window = (start, start + dur, e.start_thread_id())
        elif name.startswith(LAUNCH_PREFIXES):
            launches[e.correlation_id()] = (e.start_thread_id(), start)
    if window is None:
        raise RuntimeError(f"profile holds no {BENCH_PREFIX}{window_label} range")
    w0, w1, main_tid = window
    device = [(max(s, w0), min(e, w1), c) for s, e, c in device if e > w0 and s < w1]
    inner = {tid: _Innermost(rs) for tid, rs in ranges.items()}
    main: Optional[_Innermost] = inner.get(main_tid)
    by_span: Dict[str, float] = collections.defaultdict(float)
    for s, e, corr in device:
        launch = launches.get(corr)
        if launch is None:
            label = "unlinked"
        else:
            tid, t = launch
            label = ((inner[tid].at(t) if tid in inner else None)
                     or (main.at(t) if main is not None else None) or OUTSIDE)
        by_span[label] += (e - s) * 1e-9
    busy = _merge([(s, e) for s, e, _ in device])
    timeline = _Timeline(ranges.get(main_tid, []))
    idle: Dict[str, float] = collections.defaultdict(float)
    t = w0
    for s, e in busy + [(w1, w1)]:
        if s > t:
            timeline.split(t, s, idle)
        t = max(t, e)
    return SpanWindow(window_s=(w1 - w0) * 1e-9, busy_s=sum(e - s for s, e in busy) * 1e-9,
                      device_s_by_span=dict(by_span), idle_by_span=dict(idle))


def without_program_ranges(prof):
    """A stand-in for ``prof`` whose events leave out the program's ranges
    and their mirrors on the device timeline."""
    events = [e for e in prof.profiler.kineto_results.events()
              if not e.name().startswith(PREFIX)]
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=results))
