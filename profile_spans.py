#!/usr/bin/env python3
"""The program's spans and counters in one run of a benchmark cell, on one GPU.

Run from the repository root on a machine with one CUDA card:
``python3 profile_spans.py --workload <cell> --seed <n> [--seconds 51]
[--tracer 0|1] [--out chiprun_out/spans.jsonl]``.  It runs the cell once
as ``benchmark/run.py --trace 1`` does (set-up, the timed window under the
benchmark's wrappers, the profiled window after it), with ``--tracer 1``
the program's tracer (``jlm_tpu_torch.utils.profiling``) on from the timed
window's start to the profiled window's end, and appends one JSON line to
``--out``: the end-to-end metrics, ``correct`` and the per-layer metrics as
the benchmark reads them (its reduction given the profile without the
program's ranges, ``benchmark/core/spans.py``), and with the tracer on

- ``timed``: the timed window's span totals and counters;
- ``spans``: the profiled window's device seconds and idle seconds by the
  innermost program span (``reduce_spans``);
- ``readings``: serve cells: ``fetch_wait_ms_per_chunk`` and
  ``surfaces_ms_per_chunk`` (host ms a chunk in ``decode.fetch`` and
  ``decode.surfaces``, timed window), ``pack_idle_ms_per_chunk``,
  ``surfaces_idle_ms_per_chunk`` and ``enqueue_idle_ms_per_chunk`` (device
  idle under each span a profiled chunk), ``node_fill``, ``frame_fill`` and
  ``row_fill`` (% of the scanned node, frame and sentence slots that hold a
  real node, kana or sentence), ``job_phases_ms`` (``job_phases``: ms a job
  by phase, over all jobs and over the slowest past the latency quantile);
  training cells: ``forward_ms_per_step``, ``backward_ms_per_step`` and
  ``optimizer_ms_per_step`` (device ms a profiled step under each span,
  autograd's thread charged to the main thread's span), and the share of
  busy time under no span.

A run with ``--tracer 0`` beside one with ``--tracer 1`` on the same seed
measures what the tracer costs the timed window.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def job_phases(spans, q: float) -> dict:
    """Mean ms a job by phase (``profiling.by_request``), over the timed
    window's jobs (``all``) and over those at or past its latency quantile
    ``q`` (``tail``): the phases the jobs that set ``job_p<q>_ms`` lose
    their time in."""
    from jlm_tpu_torch.utils import profiling

    jobs = sorted(profiling.by_request(spans).values(), key=lambda j: j["seconds"])
    if not jobs:
        return {}

    def mean_ms(js) -> dict:
        names = sorted({n for j in js for n in j["phases"]})
        return {"jobs": len(js), "job": 1e3 * sum(j["seconds"] for j in js) / len(js),
                **{n: 1e3 * sum(j["phases"].get(n, 0.0) for j in js) / len(js) for n in names},
                "outside": 1e3 * sum(j["outside"] for j in js) / len(js)}

    cut = jobs[max(0, math.ceil(q * len(jobs)) - 1)]["seconds"]
    return {"all": mean_ms(jobs), "tail": mean_ms([j for j in jobs if j["seconds"] >= cut])}


def readings(kind: str, t, timed, sw, per_layer, q: float) -> dict:
    """The per-layer readings of the program's spans and counters."""
    totals, counters = timed["totals"], timed["counters"]
    if kind == "serve":
        chunks, profiled = t.timed_units["chunks"], t.profiled_units["chunks"]
        host = {n: totals.get(f"decode.{n}", {}).get("seconds", 0.0) * 1e3 / chunks
                for n in ("pack", "enqueue", "fetch", "surfaces")}
        out = {"fetch_wait_ms_per_chunk": host["fetch"],
               "surfaces_ms_per_chunk": host["surfaces"],
               "pack_host_ms_per_chunk": host["pack"],
               "enqueue_host_ms_per_chunk": host["enqueue"]}
        for n in ("pack", "surfaces", "enqueue"):
            out[f"{n}_idle_ms_per_chunk"] = sw.idle_by_span.get(f"decode.{n}", 0.0) * 1e3 / profiled
        out["node_fill"] = 100.0 * counters["decode.nodes"] / counters["decode.node_slots"]
        out["frame_fill"] = 100.0 * counters["decode.kana"] / counters["decode.frame_slots"]
        out["row_fill"] = 100.0 * counters["decode.sentences"] / counters["decode.rows"]
        out["job_phases_ms"] = job_phases(timed["spans"], q)
        out["dropped_nodes"] = counters.get("decode.dropped_nodes", 0)
        out["chunks_counted_vs_timed"] = [counters["decode.chunks"], chunks]
        mat = per_layer.get("materialize_ms_per_chunk.serve")
        if mat:
            out["fetch_plus_surfaces_over_materialize"] = (host["fetch"] + host["surfaces"]) / mat
        out["idle_by_span_over_idle"] = sum(sw.idle_by_span.values()) / sw.idle_s
        return out
    steps = t.profiled_units["steps"]
    out = {f"{n}_ms_per_step": sw.device_s_by_span.get(f"train.{n}", 0.0) * 1e3 / steps
           for n in ("forward", "backward", "optimizer")}
    phases = sum(out.values()) * steps * 1e-3
    out["phases_over_busy"] = phases / sw.busy_s
    out["outside_share_of_busy"] = sw.device_s_by_span.get("outside", 0.0) / sw.busy_s
    optim = per_layer.get("optim_ms_per_step.train")
    if optim:
        out["optimizer_over_optim_ms_per_step"] = out["optimizer_ms_per_step"] / optim
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--tracer", type=int, choices=(0, 1), default=1)
    ap.add_argument("--out", default="chiprun_out/spans.jsonl")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("profile_spans: needs one CUDA card", file=sys.stderr)
        return 1
    from benchmark.core import registry, run_cell, serve, spans, train
    from benchmark.core import trace as bench_trace
    from benchmark.core.peaks import card
    from jlm_tpu_torch.utils import profiling

    cell = registry.workload(args.workload)
    cfg = registry.config(cell["config"])
    kind = registry.traffic(cell["traffic"]["kind"])
    device = torch.device("cuda", 0)
    torch.set_num_threads(1)
    got = {}

    class Recorder(bench_trace.Recorder):
        """The benchmark's wrappers; the tracer follows ``timing`` on and
        stays on through the profiled window."""

        def __setattr__(self, name, value):
            if name == "timing" and args.tracer:
                if value:
                    profiling.reset()
                    profiling.enable(True)
                elif profiling.enabled():
                    got["timed"] = profiling.snapshot()
                    profiling.reset()
            super().__setattr__(name, value)

    def reduce_profile(prof, *a, **kw):
        if args.tracer:
            profiling.enable(False)
            got["spans"] = spans.reduce_spans(prof)
        return bench_trace.reduce_profile(spans.without_program_ranges(prof), *a, **kw)

    for mod in (serve, train):
        mod.Recorder, mod.reduce_profile = Recorder, reduce_profile
    out = run_cell.run(cell, cfg, kind, args.seed, args.seconds, True, device, T_START,
                       os.path.join(ROOT, "build", "native"))
    line = run_cell.result_line(out, True, registry.metrics(), device, cell["chips"])
    per_layer = {k: v["value"] for k, v in line["metrics"].items()}
    rec = {"workload": args.workload, "seed": args.seed, "tracer": args.tracer, "card": card(),
           "correct": line["correct"],
           "end_to_end": {k: v for k, (v, _) in out["metrics"].items()},
           "per_layer": per_layer, "idle_gaps": line["breakdown"]["idle_gaps"],
           "busy_s": line["device"]["busy_s"], "window_s": line["device"]["window_s"]}
    if args.tracer:
        t, sw = out["trace"], got["spans"]
        rec["timed"] = {"totals": got["timed"]["totals"], "counters": got["timed"]["counters"]}
        rec["spans"] = {"busy_s": sw.busy_s, "idle_s": sw.idle_s,
                        "device_s_by_span": sw.device_s_by_span,
                        "idle_by_span": sw.idle_by_span}
        rec["readings"] = readings(t.kind, t, got["timed"], sw, per_layer,
                                   cell["traffic"].get("latency_quantile", 0.9))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a") as f:
        f.write(json.dumps(rec) + "\n")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
