"""The roofline and MFU counts equal hand-computed ones at the cells' shapes
(``chip_smoke.py``'s bounds where it has the same shape)."""

import importlib.util
import os

import pytest

from benchmark.core import registry
from benchmark.core.trace import DeviceWindow, Trace
from benchmark.core.peaks import PEAK, bound_s

LSTM = registry.family("lstm")
serve_ops, train_ops = LSTM.serve_ops, LSTM.train_ops


def metric(name):
    return registry.metrics()[name]


M50 = registry.config("jlm-50k-1l")["model"]
M100 = registry.config("jlm-100k-2l-dsoftmax")["model"]


def test_project_lse_bound_at_the_serving_frame():
    # R = 2,048 sentences x beam 10; chip_smoke.py row 1: 0.5299 ms (ops)
    work = metric("project_lse_roofline.serve").work
    nbytes, ops, kind, exps = work(20480, LSTM.head_blocks(M50))
    assert ops == 2 * 20480 * 512 * 50000 and kind == "int8" and exps == 20480 * 50000
    assert nbytes == 20480 * 512 * 2 + 512 * 50000 + 50000 * 8 + 20480 * 4
    assert bound_s(nbytes, ops, kind, PEAK) == pytest.approx((ops / 1979e12, "operations"))
    assert bound_s(nbytes, ops, kind, PEAK)[0] * 1e3 == pytest.approx(0.5299, abs=1e-4)
    # config 5's blocks: 16,000 x 512 + 34,000 x 256 + 50,000 x 128 = 23.3 M weights
    nb5, ops5, _, exps5 = work(20480, LSTM.head_blocks(M100))
    assert ops5 == 2 * 20480 * (16000 * 512 + 34000 * 256 + 50000 * 128)
    assert exps5 == 20480 * 100000
    # with the exponential rate of 16 a clock on 132 SMs at 1,980 MHz it is exp-bound
    peak = dict(PEAK, exp=16 * 132 * 1980e6)
    assert bound_s(nb5, ops5, "int8", peak, exps5)[1] == "exp"


def test_lstm_cell_bound():
    # chip_smoke.py row 2: 0.0651 ms (ops)
    nbytes, ops, kind = metric("lstm_cell_roofline.serve").work(20480, 256, 512)
    assert ops == 2 * 20480 * 768 * 2048 and kind == "bf16"
    assert bound_s(nbytes, ops, kind, PEAK)[0] * 1e3 == pytest.approx(0.0651, abs=1e-4)


def test_scan_and_ce_bounds_at_the_training_step():
    scan = metric("lstm_scan_roofline.train").work
    # chip_smoke.py rows 7 and 8: 0.0481 and 0.0962 ms (ops)
    assert bound_s(*scan("fwd", 32, 32, 256, 512), PEAK)[0] * 1e3 == pytest.approx(0.0481,
                                                                                   abs=1e-4)
    assert bound_s(*scan("bwd", 32, 32, 256, 512), PEAK)[0] * 1e3 == pytest.approx(0.0962,
                                                                                   abs=1e-4)
    ce = metric("softmax_ce_roofline.train").work
    fwd, bwd = ce("fwd", 1024, 512, 50000), ce("bwd", 1024, 512, 50000)
    assert fwd[1] == 2 * 1024 * 512 * 50000 and bwd[1] == 2 * fwd[1]
    # the logits, dh and dW once each: 157.3 GFLOP of bf16 a step, 0.159 ms
    assert (fwd[1] + bwd[1]) / 989e12 * 1e3 == pytest.approx(0.1590, abs=1e-4)


def test_mfu_counts():
    tp = registry.workload("train.jlm50k.b256x32")["traffic"]
    ops = train_ops(M50, tp, 1)
    assert ops == {"fp32": 6 * 8192 * 768 * 2048, "bf16": 6 * 8192 * 512 * 50000}
    # a 2-kana sentence over one word "ab" and single kana "a": root + 2 positions
    by_reading = {"a": [5], "ab": [6], "b": [7, 8]}
    serve = {"beam_width": 10, "quantize": True, "int8_mxu": True}
    got = serve_ops(["ab"], M50, serve, by_reading, 5)
    rows = 3 * 10
    cell = 2 * (256 + 512) * 4 * 512
    # candidate columns: position 0 {5, 6} + eos, position 1 {7, 8} + eos, position 2 eos
    cands = 3 + 3 + 1
    assert got == {"bf16": rows * cell + 10 * cands * 2 * 512, "int8": rows * 2 * 512 * 50000}
    got5 = serve_ops(["ab"], M100, serve, by_reading, 5)
    assert got5["int8"] == rows * 2 * (16000 * 512 + 34000 * 256 + 50000 * 128)
    assert got5["bf16"] == rows * (2 * 768 * 2048 + 2 * 1024 * 2048) + 10 * cands * 2 * 512


def _trace(kind, timed_units, timed_s, profiled_units, busy_s, window_s, ops):
    dev = DeviceWindow(window_s=window_s, busy_s=busy_s, activities=1, device_s_by_range={},
                       device_ops=[], idle_by_host=[])
    return Trace(kind=kind, head_blocks=LSTM.head_blocks(M50), spans={}, calls={},
                 timed_units=timed_units, timed_s=timed_s, profiled_units=profiled_units, useful_ops=ops,
                 peaks=dict(PEAK), device=dev)


@pytest.mark.parametrize("kind,unit", [("serve", "chars"), ("train", "steps")])
def test_idle_and_mfu_take_the_timed_windows_pace(kind, unit):
    """The profiled part ran 3 units in 1.5 s (the profiler slowed the
    host); the timed window ran 100 units in 30 s, so the same work took
    0.9 s without the profiler: 0.18 s busy is 80% idle of it, not 88%."""
    ops = {"bf16": 0.09 * 989e12}  # 0.09 s of the bf16 peak
    t = _trace(kind, {unit: 100, "jobs": 5}, 30.0, {unit: 3, "jobs": 1}, 0.18, 1.5, ops)
    assert t.untraced_s(unit) == pytest.approx(0.9)
    assert metric(f"device_idle_share.{kind}").read(t) == pytest.approx(80.0)
    assert metric(f"mfu.{kind}").read(t) == pytest.approx(10.0)
    other = "train" if kind == "serve" else "serve"
    assert metric(f"device_idle_share.{other}").read(t) is None
    empty = _trace(kind, {}, 30.0, {}, 0.18, 1.5, ops)
    assert metric(f"device_idle_share.{kind}").read(empty) is None
    assert metric(f"mfu.{kind}").read(empty) is None
