"""The port's tracer (``jlm_tpu_torch.utils.profiling``: spans, counters)
at the engine's and the trainer's phase boundaries, on the CPU."""

import collections
import json
import time

import numpy as np
import pytest
import torch

from jlm_tpu_torch.config import Config
from jlm_tpu_torch.decoder.engine import BeamDecoder
from jlm_tpu_torch.decoder.lattice import build_lattice
from jlm_tpu_torch.utils import JsonlLogger, profiling, timed_span

KANAS = ["きょうはいい", "あめがふる", "はしをみる", "かみとかわ", "きょうはいいてんき", "ゑ",
         "とてもさむいです"]
DECODE = ("decode.pack", "decode.enqueue", "decode.fetch", "decode.surfaces")


@pytest.fixture(autouse=True)
def tracer_off_after():
    profiling.reset()
    yield
    profiling.enable(False)
    profiling.reset()


@pytest.fixture(scope="module")
def engine(tiny_params, tiny_config, lexicon, vocab):
    return BeamDecoder(tiny_params, lexicon, vocab, tiny_config, device="cpu")


def _traced(fn, *args, **kwargs):
    profiling.reset()
    profiling.enable(True)
    try:
        out = fn(*args, **kwargs)
    finally:
        profiling.enable(False)
    return out, profiling.snapshot()


def test_off_by_default_records_nothing(engine):
    assert not profiling.enabled()
    engine.decode_stream(KANAS, chunk_size=3)
    profiling.count("decode.chunks", 1)
    assert profiling.snapshot() == {"spans": [], "totals": {}, "counters": {}}
    # off, every span is the one shared do-nothing context
    assert profiling.span("decode.pack") is profiling.span("train.forward")


def test_decode_spans_nest_under_one_job(engine):
    (_, snap), (_, again) = (_traced(engine.decode_stream, KANAS, chunk_size=3)
                             for _ in range(2))
    spans = snap["spans"]
    job = spans[0]
    assert job["name"] == "decode.job" and job["parent"] == -1
    assert job["request"] == job["index"]
    chunks = -(-len(KANAS) // 3)
    assert [s["name"] for s in spans[1:]] == (["decode.pack", "decode.enqueue"] * chunks
                                              + ["decode.fetch", "decode.surfaces"] * chunks)
    for s in spans[1:]:
        assert s["parent"] == job["index"] and s["request"] == job["index"]
        assert job["start_ns"] <= s["start_ns"] <= s["end_ns"] <= job["end_ns"]
    for a, b in zip(spans[1:], spans[2:]):  # siblings, one after another
        assert a["end_ns"] <= b["start_ns"]
    assert {k: v["count"] for k, v in snap["totals"].items()} == {
        "decode.job": 1, **{n: chunks for n in DECODE}}
    assert snap["counters"]["decode.chunks"] == chunks
    assert {s["request"] for s in again["spans"]} == {again["spans"][0]["index"]} != {
        job["request"]}


def test_counters_equal_the_packed_chunks(engine, tiny_config, lexicon, vocab):
    chunks = [KANAS[:4], KANAS[4:]]
    want = collections.Counter({"decode.pack_calls": 0})
    for chunk in chunks:
        packed, _ = engine._pack(chunk)  # tracer off: counts nothing
        rows, T, N = packed.shape
        assert rows == engine._bucket(len(chunk))
        nodes = sum(int(build_lattice(k, lexicon, vocab, tiny_config).node_mask.sum())
                    for k in chunk)
        want.update({"decode.chunks": 1, "decode.sentences": len(chunk), "decode.rows": rows,
                     "decode.kana": sum(len(k) for k in chunk), "decode.frame_slots": rows * T,
                     "decode.nodes": nodes, "decode.node_slots": rows * T * N,
                     "decode.pack_calls": engine._native is not None})
    assert not profiling.snapshot()["counters"]
    _, snap = _traced(engine.decode_stream, KANAS, chunk_size=4, sort_by_length=False)
    assert snap["counters"] == dict(want)
    assert 0 < want["decode.nodes"] < want["decode.node_slots"]


def test_dropped_nodes_counter_matches_an_overflowing_lattice(tiny_params, tiny_config,
                                                              lexicon, vocab):
    config = tiny_config.replace(max_nodes_per_frame=2, node_overflow="ignore")
    kana = "きょうはいいてんき"
    dropped = build_lattice(kana, lexicon, vocab, config).dropped_nodes
    assert dropped > 0
    for native in (False, None):  # the Python builder, and the native one where built
        dec = BeamDecoder(tiny_params, lexicon, vocab, config, use_native=native, device="cpu")
        _, snap = _traced(dec.decode_stream, [kana])
        assert snap["counters"]["decode.dropped_nodes"] == dropped


@pytest.mark.parametrize("native", [False, None])
def test_dropped_nodes_count_the_real_rows_of_a_padded_chunk(native, tiny_params, tiny_config,
                                                             lexicon, vocab):
    # three sentences pad to a bucket of four rows, a copy of the last one
    config = tiny_config.replace(max_nodes_per_frame=2, node_overflow="ignore")
    kanas = ["きょうはいいてんき", "きょうはいい", "きょうはいいてんき"]
    dropped = sum(build_lattice(k, lexicon, vocab, config).dropped_nodes for k in kanas)
    assert dropped > 0
    dec = BeamDecoder(tiny_params, lexicon, vocab, config, use_native=native, device="cpu")
    (results, snap) = _traced(dec.decode_stream, kanas, sort_by_length=False)
    counters = snap["counters"]
    assert (counters["decode.sentences"], counters["decode.rows"]) == (3, 4)
    assert counters["decode.dropped_nodes"] == dropped
    packed, lengths = dec._pack(kanas)
    np.testing.assert_array_equal(packed[3], packed[2])
    assert lengths.tolist() == [len(k) for k in kanas] + [len(kanas[-1])]
    assert results[0] == results[2]


@pytest.mark.parametrize("native", [False, True])
def test_pack_calls_count_one_native_call_a_chunk(native, tiny_params, tiny_config, lexicon,
                                                  vocab):
    from jlm_tpu_torch import native as native_mod

    if native and not native_mod.available():
        pytest.skip("no native toolchain")
    dec = BeamDecoder(tiny_params, lexicon, vocab, tiny_config, use_native=native, device="cpu")
    _, snap = _traced(dec.decode_stream, KANAS, chunk_size=3)
    chunks = snap["counters"]["decode.chunks"]
    assert chunks == -(-len(KANAS) // 3)
    assert snap["counters"]["decode.pack_calls"] == (chunks if native else 0)


def test_by_request_sums_each_jobs_phases(engine):
    profiling.enable(True)
    engine.decode_stream(KANAS, chunk_size=3)
    engine.decode_stream(KANAS[:2])
    profiling.enable(False)
    spans = profiling.snapshot()["spans"]
    jobs = profiling.by_request(spans)
    assert [j["name"] for j in jobs.values()] == ["decode.job"] * 2
    for req, job in jobs.items():
        (root,) = [s for s in spans if s["index"] == req]
        inner = [s for s in spans if s["request"] == req and s["index"] != req]
        assert sorted(job["phases"]) == sorted(DECODE)
        took = sum(s["end_ns"] - s["start_ns"] for s in inner) * 1e-9
        assert sum(job["phases"].values()) == pytest.approx(took)
        assert job["seconds"] == pytest.approx((root["end_ns"] - root["start_ns"]) * 1e-9)
        assert job["outside"] == pytest.approx(job["seconds"] - took)
        assert job["outside"] >= 0


def test_by_request_leaves_out_a_request_the_wrap_cut(monkeypatch):
    monkeypatch.setattr(profiling, "_records", collections.deque(maxlen=8))
    profiling.enable(True)
    for _ in range(5):  # 15 records; the last 8 hold the third job without its pack
        with profiling.span("decode.job"):
            with profiling.span("decode.pack"):
                time.sleep(0.001)
            with profiling.span("decode.surfaces"):
                pass
    spans = profiling.snapshot()["spans"]
    jobs = profiling.by_request(spans)
    assert [s["name"] for s in spans].count("decode.job") == 3
    assert len(jobs) == 2
    for job in jobs.values():
        assert sorted(job["phases"]) == ["decode.pack", "decode.surfaces"]
        assert job["phases"]["decode.pack"] >= 0.001


def test_profiler_ranges_carry_the_spans(engine):
    from torch.profiler import ProfilerActivity, profile

    profiling.enable(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.decode_stream(KANAS, chunk_size=3)
        with profiling.span("decode.job"):
            time.sleep(0.03)
    profiling.enable(False)
    spans = profiling.snapshot()["spans"]
    ranges = sorted((e.start_ns(), e.duration_ns(), e.name()[len(profiling.RANGE_PREFIX):])
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith(profiling.RANGE_PREFIX))
    assert [n for _, _, n in ranges] == [s["name"] for s in spans]
    # a range opens before its span's clock starts and closes after it
    # stops; past the range's own cost (tens of microseconds a range on
    # the CPU), the two agree within 5%
    long = 0
    for (_, dur, _), s in zip(ranges, spans):
        took = s["end_ns"] - s["start_ns"]
        assert took <= dur
        if took >= 20_000_000:
            assert dur <= 1.05 * took
            long += 1
    assert long >= 2 and spans[-1]["end_ns"] - spans[-1]["start_ns"] >= 20_000_000


def test_trainer_step_records_its_three_phases():
    from jlm_tpu_torch.data import build_vocab, encode_corpus, generate_corpus
    from jlm_tpu_torch.train import Trainer

    lines = generate_corpus(60, seed=3)
    ids = encode_corpus(lines, build_vocab(lines, 64))
    cfg = Config(vocab_size=64, embed_size=8, hidden_size=16, batch_size=2, num_steps=4,
                 seed=5)
    trainer = Trainer(cfg, device="cpu")
    steps = trainer.train_steps(np.asarray(ids[:64]), epoch=0)
    _, snap = _traced(next, steps)
    spans = snap["spans"]
    assert [s["name"] for s in spans] == ["train.forward", "train.backward", "train.optimizer"]
    assert snap["counters"] == {"optim.plain_calls": 1}  # CPU leaves: the plain optimizer
    assert all(s["parent"] == -1 for s in spans)
    for a, b in zip(spans, spans[1:]):
        assert a["end_ns"] <= b["start_ns"]


def test_the_buffer_wraps_and_the_totals_stay(monkeypatch):
    monkeypatch.setattr(profiling, "_records", collections.deque(maxlen=8))
    profiling.enable(True)
    for _ in range(10):
        with profiling.span("decode.job"):
            with profiling.span("decode.pack"):
                pass
    snap = profiling.snapshot()
    assert len(snap["spans"]) == 8
    assert [s["name"] for s in snap["spans"]] == ["decode.job", "decode.pack"] * 4
    assert [s["parent"] for s in snap["spans"][1::2]] == [s["index"]
                                                          for s in snap["spans"][::2]]
    assert {k: v["count"] for k, v in snap["totals"].items()} == {"decode.job": 10,
                                                                  "decode.pack": 10}
    assert snap["totals"]["decode.job"]["seconds"] >= snap["totals"]["decode.pack"]["seconds"]


def test_timed_span_opens_the_tracers_span(tmp_path):
    logger = JsonlLogger(str(tmp_path / "log.jsonl"), echo=False)
    profiling.enable(True)
    with timed_span(logger, "eval", chunk=2):
        time.sleep(0.005)
    with open(tmp_path / "log.jsonl") as f:
        rec = json.loads(f.read())
    (span,) = profiling.snapshot()["spans"]
    assert span["name"] == rec["name"] == "eval" and rec["chunk"] == 2
    assert rec["seconds"] == pytest.approx((span["end_ns"] - span["start_ns"]) * 1e-9,
                                           abs=1e-3)


def test_threads_lose_no_span_or_count():
    import sys
    import threading

    def work():
        for _ in range(500):
            with profiling.span("decode.job"):
                profiling.count("decode.chunks", 1)

    profiling.enable(True)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    snap = profiling.snapshot()
    assert snap["totals"]["decode.job"]["count"] == snap["counters"]["decode.chunks"] == 8000
    assert all(s["parent"] == -1 for s in snap["spans"])  # each thread's own stack
