"""Serve cells: jobs of sentences through ``BeamDecoder.decode_stream``.

Set-up makes the weights from the seed, quantizes them to the served
format, builds the decoder and converts ``warm_jobs`` jobs of the cell's
own shapes.  The window is a closed loop of one client: job after job
until ``seconds`` have passed, each timed from the call to its results in
host memory; the jobs' latency is reported at the quantile the traffic
names (``job_p<100 q>_ms``).  Afterwards a sample of the converted
sentences, drawn from the seed and holding the longest one converted, goes
to the reference.
"""

from __future__ import annotations

import gc
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from benchmark.core import program
from benchmark.core.trace import Recorder, Trace, reduce_profile
from benchmark.core.weights import dequantize_params, make_weights, quantize_params
from benchmark.reference.beam import beam_search, rescore, valid_path


def quantile(values: List[float], q: float) -> float:
    """The ``q`` quantile, interpolated between the nearest ranks."""
    xs = sorted(values)
    pos = q * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def lookahead_counts(kana: str, by_reading: Dict[str, List[int]], M: int) -> List[int]:
    """Distinct words starting at each position (an unmatched kana: ``<unk>``)."""
    out = []
    for i in range(len(kana)):
        ws = set()
        for j in range(i + 1, min(i + M, len(kana)) + 1):
            ws.update(by_reading.get(kana[i:j], ()))
        out.append(len(ws) + (0 if kana[i] in by_reading else 1))
    return out


def run(cell: Dict[str, Any], cfg: Dict[str, Any], family, traffic, seed: int, seconds: float,
        trace: bool, device, t_start: float, build_dir: str) -> Dict[str, Any]:
    model, serve, tp = cfg["model"], cfg["serve"], cell["traffic"]
    program.use_build_dir(build_dir)
    config = family.make_config(model, serve, max_nodes_per_frame=tp["max_nodes_per_frame"])
    leaves = family.leaves(model)
    weights = make_weights(leaves, cfg["weights"], seed, device)
    params = quantize_params(weights, leaves) if serve.get("quantize") else weights
    del weights
    decoder = family.make_decoder(params, traffic.lexicon, config, serve["precision"], device)
    chunk, n_best = tp["chunk_size"], tp["n_best"]
    for j in range(tp["warm_jobs"]):
        decoder.decode_stream(traffic.job(-1 - j), chunk_size=chunk, n_best=n_best)
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    sync()
    setup_s = time.perf_counter() - t_start
    gc.collect()
    gc.freeze()  # set-up's objects (lexicon, pool, program) out of the collector's walks

    rec = Recorder()
    if trace:
        for owner, attr, label, shape in family.serve_patch_points():
            rec.wrap(owner, attr, label, shape)
        rec.timing = True
    lat, chars, attempted, failed = [], 0, 0, 0
    done: List[Tuple[float, int]] = []  # (completion time, chars) of each job
    sample = Reservoir(tp["check_sentences"] - 1, seed)
    longest: Optional[Tuple[str, Any]] = None
    t0 = time.perf_counter()
    j = 0
    while True:
        kanas = traffic.job(j)
        tc = time.perf_counter()
        results = decoder.decode_stream(kanas, chunk_size=chunk, n_best=n_best)
        lat.append(time.perf_counter() - tc)
        n_chars = sum(len(k) for k in kanas)
        chars += n_chars
        done.append((time.perf_counter() - t0, n_chars))
        attempted += len(kanas)
        failed += sum(1 for r in results if not r)
        sample.offer([(kanas[i], results[i]) for i in traffic.pick(j, sample.size)])
        i_long = max(range(len(kanas)), key=lambda i: len(kanas[i]))
        if longest is None or len(kanas[i_long]) > len(longest[0]):
            longest = (kanas[i_long], results[i_long])
        j += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window = time.perf_counter() - t0
    gc.unfreeze()
    rec.timing = False
    q = tp["latency_quantile"]
    out: Dict[str, Any] = {"attempted": attempted, "failed": failed, "setup_s": setup_s,
                           "metrics": {"chars_per_s": (chars / window, "chars/s"),
                                       latency_metric(q): (quantile(lat, q) * 1e3, "ms"),
                                       "setup_s": (setup_s, "s")},
                           "jobs": j, "window_s": window, "rate_by_fifth": by_fifth(done, window)}
    if trace:
        out["trace"] = _profile(rec, decoder, family, traffic, cell, cfg, config,
                                {"jobs": j, "chars": chars}, window, device)
    rec.restore()
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0)
    del decoder
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    lm = family.reference_lm(dequantize_params(params, leaves), model)
    out["checks"] = compare(lm, [longest] + sample.items, traffic.lexicon, serve["beam_width"],
                            config.max_word_len, tp["max_nodes_per_frame"], device, failed,
                            cell["limits"])
    out["check_s"] = time.perf_counter() - t_check
    return out


def latency_metric(q: float) -> str:
    """The name of the jobs' latency at quantile ``q``: ``job_p90_ms`` for 0.9."""
    return f"job_p{round(q * 100)}_ms"


def by_fifth(done: List[Tuple[float, int]], window: float) -> List[float]:
    """Chars/s of the jobs completed in each fifth of the window (a
    steadiness reading printed beside the result)."""
    out = []
    for k in range(5):
        lo, hi = window * k / 5, window * (k + 1) / 5
        out.append(sum(c for t, c in done if lo < t <= hi) / (hi - lo))
    return out


class Reservoir:
    """A uniform sample of ``size`` converted sentences over every job,
    drawn from the seed, holding no more than ``size`` results: job ``j``
    offers ``size`` of its sentences, and each slot takes the offer with
    probability ``1 / (j + 1)``."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.items: List[Tuple[str, Any]] = []
        self.jobs = 0
        self.rng = np.random.default_rng([seed % (1 << 63), 4])

    def offer(self, items: List[Tuple[str, Any]]) -> None:
        self.jobs += 1
        if not self.items:
            self.items = list(items)
            return
        take = self.rng.random(self.size) < 1.0 / self.jobs
        self.items = [new if t else old for old, new, t in zip(self.items, items, take)]


def compare(lm, sample, lex, beam: int, max_word_len: int, max_nodes: int, device,
            failed: int, limits: Dict[str, float],
            served: Optional[List[Tuple[float, List[int]]]] = None) -> Dict[str, Dict[str, float]]:
    """The output check.  ``sample``: (kana, the program's n-best) pairs;
    ``served`` (the control) replaces the program's top paths by (score,
    word ids).  Numbers: sentences with no result, top paths that are no
    segmentation of their kana into lexicon words, the widest gap between a
    top path's reported score and the reference's score of that path, and
    the widest margin by which the reference's own beam-search best beats
    the reference's score of the top path."""
    by_reading = lex.by_reading()
    kanas = [k for k, _ in sample]
    if served is None:
        tops = [r[0] if r else None for _, r in sample]
        invalid = sum(1 for k, t in zip(kanas, tops)
                      if t is None or not valid_path(k, t.segments, lex, by_reading,
                                                     max_word_len))
        served = [(t.score, [w for _, w in t.segments]) if t else (float("nan"), [])
                  for t in tops]
    else:
        invalid = 0
    ok = [i for i, (_, p) in enumerate(served) if p]
    ref_best = beam_search(lm, kanas, lex, beam, max_word_len, max_nodes, device)
    ref_served = rescore(lm, [served[i][1] for i in ok], device) if ok else []
    score_gap = max((abs(served[i][0] - r) for i, r in zip(ok, ref_served)), default=0.0)
    path_gap = max((ref_best[i][0] - r for i, r in zip(ok, ref_served)), default=0.0)
    values = {"missing": float(failed + len(sample) - len(ok)), "invalid_paths": float(invalid),
              "score_gap": float(score_gap), "path_gap": float(path_gap)}
    return {k: {"value": v, "limit": limits[k]} for k, v in values.items()}


def _profile(rec: Recorder, decoder, family, traffic, cell, cfg, config, timed: Dict[str, int],
             timed_s: float, device) -> Trace:
    from torch.profiler import ProfilerActivity, profile, record_function

    tp = cell["traffic"]
    timed = dict(timed, chunks=len(rec.spans.get("decode_scan", [])))
    jobs = [traffic.job(timed["jobs"] + k) for k in range(tp["profile_jobs"])]
    torch.cuda.synchronize(device)
    rec.profiling = True
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("bench::window"):
            for kanas in jobs:
                decoder.decode_stream(kanas, chunk_size=tp["chunk_size"], n_best=tp["n_best"])
            torch.cuda.synchronize(device)
    rec.profiling = False
    chunk = tp["chunk_size"]
    by_reading = traffic.lexicon.by_reading()
    ops: Dict[str, float] = {}
    for kanas in jobs:
        for k, v in family.serve_ops(kanas, cfg["model"], cfg["serve"], by_reading,
                                     config.max_word_len).items():
            ops[k] = ops.get(k, 0.0) + v
    from benchmark.core.peaks import peaks

    return Trace(kind="serve", head_blocks=family.head_blocks(cfg["model"]),
                 spans=dict(rec.spans), calls=dict(rec.calls),
                 timed_units=timed, timed_s=timed_s,
                 profiled_units={"jobs": len(jobs),
                                 "chunks": sum(-(-len(k) // chunk) for k in jobs),
                                 "chars": sum(len(s) for k in jobs for s in k)},
                 useful_ops=ops, peaks=peaks(device.index or 0), device=reduce_profile(prof))
