"""The program's spans in a profiled window (``core/spans.py``), on
synthetic profiler events: idle gaps split along their length, activities
of a thread with no span open charged to the main thread's span, and the
existing reduction's readings unchanged by the program's ranges."""

import collections
import types

import pytest
import torch

from benchmark.core import registry
from benchmark.core.spans import OUTSIDE, reduce_spans, without_program_ranges
from benchmark.core.trace import Trace, reduce_profile

MAIN, WORKER = 1, 2


class Event:
    def __init__(self, name, start, end, tid=MAIN, corr=0, device=False):
        self._name, self._start, self._dur = name, start, end - start
        self._tid, self._corr, self._device = tid, corr, device

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def start_thread_id(self):
        return self._tid

    def correlation_id(self):
        return self._corr

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._device else torch.autograd.DeviceType.CPU


def profile(events):
    results = types.SimpleNamespace(events=lambda: list(events))
    return types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=results))


def kernel(name, start, end, launch_at, corr, tid=MAIN):
    """A device activity and its launch on the host."""
    return [Event("cudaLaunchKernel", launch_at, launch_at + 5, tid=tid, corr=corr),
            Event(name, start, end, corr=corr, device=True)]


def program_range(name, start, end, tid=MAIN):
    """A program span's range and its mirror on the device timeline."""
    return [Event("jlm::" + name, start, end, tid=tid),
            Event("jlm::" + name, start + 10, end - 10, device=True)]


def test_a_gap_over_surfaces_outside_and_pack_is_split_three_ways():
    events = [Event("bench::window", 0, 1000),
              *kernel("k0", 0, 150, 5, 1),
              *program_range("decode.surfaces", 100, 300),
              *program_range("decode.pack", 500, 700),
              *kernel("k1", 800, 1000, 600, 2)]
    got = reduce_spans(profile(events))
    # the gap 150..800: surfaces to 300, nothing to 500, pack to 700, nothing
    assert got.idle_by_span == pytest.approx({"decode.surfaces": 150e-9, OUTSIDE: 300e-9,
                                              "decode.pack": 200e-9})
    assert sum(got.idle_by_span.values()) == pytest.approx(got.idle_s)
    assert got.device_s_by_span == pytest.approx({OUTSIDE: 150e-9, "decode.pack": 200e-9})
    # the existing reduction charges the whole gap to its start
    assert dict(reduce_profile(without_program_ranges(profile(events))).idle_by_host) == {
        "harness": pytest.approx(650e-9)}


def test_a_launch_from_a_thread_with_no_span_goes_to_the_main_threads_span():
    events = [Event("bench::window", 0, 1000),
              *program_range("train.forward", 0, 100),
              *kernel("fwd", 10, 90, 20, 1),
              *program_range("train.backward", 100, 600),
              *kernel("bwd", 200, 500, 300, 2, tid=WORKER),
              *program_range("train.optimizer", 600, 900),
              *kernel("adam", 600, 850, 610, 3),
              *kernel("zeros", 950, 990, 940, 4)]
    got = reduce_spans(profile(events))
    assert got.device_s_by_span == pytest.approx({"train.forward": 80e-9,
                                                  "train.backward": 300e-9,
                                                  "train.optimizer": 250e-9, OUTSIDE: 40e-9})
    assert got.busy_s == pytest.approx(670e-9)


def _trace(kind, dw):
    serve = kind == "serve"
    model = registry.config("jlm-50k-1l")["model"]
    calls = ({"project_lse": collections.Counter({20480: 30}),
              "lstm_cell": collections.Counter({(20480, 256, 512): 30})} if serve else
             {"softmax_ce": collections.Counter({("fwd", 8192, 512, 50000): 2,
                                                 ("bwd", 8192, 512, 50000): 2}),
              "lstm_scan": collections.Counter({("fwd", 32, 256, 256, 512): 2,
                                                ("bwd", 32, 256, 256, 512): 2})})
    units = {"chunks": 6, "chars": 120000, "jobs": 3} if serve else {"steps": 2}
    return Trace(kind=kind, head_blocks=registry.family("lstm").head_blocks(model),
                 spans={"pack": [0.04] * 12, "materialize": [0.03] * 12,
                        "decode_scan": [0.035] * 12},
                 calls=calls, timed_units={k: 2 * v for k, v in units.items()}, timed_s=1.5,
                 profiled_units=units, useful_ops={"int8": 5e11, "bf16": 3e10, "fp32": 2e10},
                 peaks={"int8": 1979e12, "bf16": 989e12, "fp32": 67e12, "bytes": 3.35e12,
                        "exp": 4.2e12},
                 device=dw)


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_the_existing_readings_are_the_same_with_the_programs_ranges(kind):
    labels = (("decode_scan", "project_lse", "lstm_cell", "materialize", "pack")
              if kind == "serve" else ("forward", "softmax_ce", "lstm_scan", "optimizer",
                                       "train_step"))
    base = [Event("bench::window", 0, 10_000)]
    for i, label in enumerate(labels):
        t = 1_000 + 1_500 * i
        base += [Event("bench::" + label, t, t + 1_200)]
        base += kernel(f"k_{label}", t + 300, t + 1_100, t + 100, i + 1)
    base += kernel("k_worker", 9_000, 9_600, 8_900, 99, tid=WORKER)
    ours = (program_range("decode.job" if kind == "serve" else "train.backward", 500, 9_900)
            + program_range("decode.pack" if kind == "serve" else "train.forward", 900, 2_400))
    before = reduce_profile(profile(base))
    after = reduce_profile(without_program_ranges(profile(base + ours)))
    assert after == before
    assert reduce_spans(profile(base + ours)).busy_s == pytest.approx(before.busy_s)
    readings = {}
    for dw in (before, after):
        for name, mod in registry.metrics().items():
            readings.setdefault(name, []).append(mod.read(_trace(kind, dw)))
    assert len(readings) >= 13 and all(a == b for a, b in readings.values())
    assert sum(a is not None for a, _ in readings.values()) >= 4
