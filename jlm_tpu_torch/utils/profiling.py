"""Device profiling helpers (SURVEY.md §7 "Tracing / profiling").

Counterpart of :mod:`jlm_tpu.utils.profiling`.  ``trace`` wraps
``torch.profiler`` and writes a Chrome trace (``chrome://tracing`` or
Perfetto opens it); ``device_timer`` measures the steady-state time of a
call, forcing each call to finish before its clock stops: a CUDA
synchronize where a card is present, then a host copy of the first tensor
of the output, as the original forces a host fetch.

The port's own tracer: ``span(name)`` marks a phase of the engine or the
trainer and ``count(name, n)`` adds to a named counter.  Both do nothing
until ``enable(True)``: off, a span is one flag test and returns a shared
do-nothing context, and a counter is skipped.  On, each span keeps a record
(name, start and end on ``time.perf_counter_ns``, the enclosing span's
index, the request id: the outermost span's index, so every phase of one
``decode_stream`` job carries its job's id) in a buffer of ``CAPACITY``
records, the oldest dropped first; per-name counts and seconds outlive the
buffer.  While a ``torch.profiler`` records, a span also opens the range
``jlm::<name>``, so the phases sit on the profiler's timeline beside every
kernel and copy (``trace``'s Chrome trace shows them).  ``snapshot()``
returns the records, the totals and the counters; ``reset()`` clears them;
``by_request`` sums each request's records by phase (the seconds of every
phase of one ``decode_stream`` job, and the job's time outside them).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import Any, Callable, Dict, NamedTuple

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Record the enclosed block with ``torch.profiler`` (CPU activity, and
    CUDA activity where a card is present) and write its Chrome trace to
    ``log_dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# ---- spans and counters ----------------------------------------------------

CAPACITY = 1 << 16  # span records kept
RANGE_PREFIX = "jlm::"  # the profiler ranges' names

_on = False
_records: "collections.deque[SpanRecord]" = collections.deque(maxlen=CAPACITY)
_totals: Dict[str, list] = {}  # name -> [spans, nanoseconds]
_counters: Dict[str, int] = collections.defaultdict(int)
_index = itertools.count()
_open = threading.local()  # .stack: the spans open on this thread
_lock = threading.Lock()  # the totals and counters, added to from any thread


class SpanRecord(NamedTuple):
    index: int
    name: str
    start_ns: int
    end_ns: int
    parent: int  # the enclosing span's index, -1 for none
    request: int


class _Off:
    """The span while the tracer is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "index", "parent", "request", "start", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        top = stack[-1] if stack else None
        self.index = next(_index)
        self.parent = top.index if top is not None else -1
        self.request = top.request if top is not None else self.index
        self.range = None
        if torch._C._autograd._profiler_enabled():
            self.range = torch.profiler.record_function(RANGE_PREFIX + self.name)
            self.range.__enter__()
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _open.stack.pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        _records.append(SpanRecord(self.index, self.name, self.start, end, self.parent,
                                   self.request))
        with _lock:
            total = _totals.setdefault(self.name, [0, 0])
            total[0] += 1
            total[1] += end - self.start
        return False


def span(name: str):
    """A context that records the phase ``name`` while the tracer is on."""
    return _Span(name) if _on else _OFF


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` while the tracer is on."""
    if _on:
        with _lock:
            _counters[name] += int(n)


def enable(on: bool = True) -> None:
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def reset() -> None:
    """Drop every record, total and counter (open spans still record)."""
    with _lock:
        _records.clear()
        _totals.clear()
        _counters.clear()


def snapshot() -> Dict[str, Any]:
    """``spans``: the kept records in start order, as dicts; ``totals``:
    per name, the spans ended and their seconds; ``counters``."""
    with _lock:
        records, totals, counters = list(_records), dict(_totals), dict(_counters)
    return {"spans": [r._asdict() for r in sorted(records)],
            "totals": {k: {"count": c, "seconds": ns * 1e-9} for k, (c, ns) in totals.items()},
            "counters": counters}


def by_request(spans) -> Dict[int, Dict[str, Any]]:
    """Per request id of ``snapshot()["spans"]``: its outermost span's
    ``name`` and ``seconds``, ``phases`` (per name, the seconds of the
    request's spans inside it) and ``outside`` (the outermost span's seconds
    under none of the spans directly inside it).  Once the buffer has
    wrapped, a request begun before the oldest kept record ended may have
    lost spans, and is left out."""
    oldest = min(s["end_ns"] for s in spans) if len(spans) >= _records.maxlen else -1
    out = {s["index"]: {"name": s["name"], "seconds": (s["end_ns"] - s["start_ns"]) * 1e-9,
                        "phases": {}, "outside": (s["end_ns"] - s["start_ns"]) * 1e-9}
           for s in spans if s["parent"] == -1 and s["start_ns"] > oldest}
    for s in spans:
        r = out.get(s["request"])
        if r is None or s["index"] == s["request"]:
            continue
        took = (s["end_ns"] - s["start_ns"]) * 1e-9
        r["phases"][s["name"]] = r["phases"].get(s["name"], 0.0) + took
        if s["parent"] == s["request"]:
            r["outside"] -= took
    return out


def _first_tensor(out):
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):  # in key order, as a pytree's leaves
        out = [out[k] for k in sorted(out)]
    if isinstance(out, (list, tuple)):
        for x in out:
            leaf = _first_tensor(x)
            if leaf is not None:
                return leaf
    return None


def _touch(out) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    leaf = _first_tensor(out)
    if leaf is not None:
        np.asarray(leaf.detach().cpu())


def device_timer(fn: Callable, *args, reps: int = 5, warmup: int = 1) -> float:
    """Median seconds per call of ``fn(*args)`` with forced materialization."""
    for _ in range(warmup):
        _touch(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.time()
        _touch(fn(*args))
        times.append(time.time() - t0)
    return sorted(times)[len(times) // 2]
