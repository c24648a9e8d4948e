#!/usr/bin/env python3
"""Profile of the port's serving path on one GPU.

Run from the repository root on a machine with one CUDA card:
``python3 profile_serve.py [--out chiprun_out/serve_profile.json]``.  It
serves ``chip_smoke.py``'s serving cells — the 50k flagship (1 layer,
full int8 head) with the split frame (the default forward:
``lstm_cell_step``, ``cand_dot``, ``project_lse``) and with the fused
frame (``50k fused``: ``make_fused_frame_forward``, ``cell_cand_step``
then ``project_lse``), BASELINE config 5 (2 layers, V=100,000, D-softmax
int8 head), all int8-MXU speed mode, and BASELINE config 2 on one card
(``50k bf16``: the same 50k model with bf16 weights, beam 10, the split
frame) — over the same 2,048-lattice chunk, in the turns of ``RUNS``.  Per run: 1 warm-up pass,
the host-clock time of 3 passes (each ending in the result fetch), then 1
pass under ``torch.profiler``.  From the profile: device busy ms per pass
(the sum of device activity; one stream), the idle share of the profiled
wall time and of the unprofiled median pass, device activities per
forward, and each decode kernel's ms per pass and share of device time,
matched by the function names of ``csrc/project_lse.cu`` (the int8 head's
quantization pass and merge counted with it),
``csrc/lstm_cell.cu``, ``csrc/cand_dot.cu`` and ``csrc/cell_cand.cu``; the
rest is PyTorch's glue.  Prints one JSON summary per run and writes them
to ``--out``, each run's gzipped chrome trace beside it.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import torch

from chip_smoke import S, bench_data, bench_data5
from profile_train import kernel_name

# the device functions of the three decode kernels' sources
DECODE_KERNELS = {"project_lse": ("proj_int8_kernel", "quantize_rows_kernel", "proj_bf16_kernel",
                                  "lse_merge_kernel"),
                  "lstm_cell_step": ("lstm_cell_wgmma_kernel", "lstm_cell_f32_kernel"),
                  "cand_dot": ("cand_dot_kernel",),
                  "cell_cand_step": ("cell_cand_kernel",)}
RUNS = ("50k", "50k fused", "50k bf16", "config 5", "config 5", "50k bf16", "50k fused", "50k")
TIMED = 3


def profile_run(dev, cell, trace_path: str) -> dict:
    """Warm-up, timed and profiled passes of one serving cell."""
    from jlm_tpu_torch.decoder.engine import BeamDecoder, make_fused_frame_forward

    label, config, vocab, lexicon, params, kanas = cell
    fwd = make_fused_frame_forward(config) if label.endswith("fused") else None
    engine = BeamDecoder(params, lexicon, vocab, config, precision="default", device=dev,
                         forward_fn=fwd)
    stream = (kanas * (-(-S // len(kanas))))[:S]
    n_chars = sum(len(k) for k in stream)
    frames = min(engine._t_bucket(max(len(k) for k in stream)), config.max_kana_len)
    engine.decode_stream(stream, chunk_size=S)
    times = []
    for _ in range(TIMED):
        t0 = time.perf_counter()
        engine.decode_stream(stream, chunk_size=S)
        times.append(time.perf_counter() - t0)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        engine.decode_stream(stream, chunk_size=S)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(trace_path)
    with open(trace_path, "rb") as src, gzip.open(trace_path + ".gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    os.remove(trace_path)

    by_name: dict = {}
    count = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            count += 1
            name = kernel_name(e.name)
            by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    kernels = {k: sum(by_name.get(f, 0.0) for f in fns) for k, fns in DECODE_KERNELS.items()}
    med_ms = statistics.median(times) * 1e3
    forwards = frames + 1
    return {
        "run": label,
        "layers": config.num_layers,
        "head": config.head,
        "frames": frames,
        "chars_per_pass": n_chars,
        "unprofiled_pass_ms": [t * 1e3 for t in times],
        "unprofiled_chars_per_s_median": n_chars / med_ms * 1e3,
        "profiled_wall_ms": wall_ms,
        "device_busy_ms_per_pass": busy,
        "device_busy_ms_per_forward": busy / forwards,
        "idle_share_profiled": 1 - busy / wall_ms,
        "idle_share_unprofiled": 1 - busy / med_ms,
        "device_activities_per_forward": count / forwards,
        "kernel_ms_per_pass": kernels,
        "kernel_share_of_device": {k: v / busy for k, v in kernels.items()},
        "glue_share_of_device": 1 - sum(kernels.values()) / busy,
        "top_ms_per_pass": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:12]),
        "trace": trace_path + ".gz",
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out/serve_profile.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_serve: needs one CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    config, vocab, lexicon, params, qp, kanas = bench_data()
    cfg5, vocab5, lexicon5, _, qp5 = bench_data5()
    cells = {"50k": ("50k", config, vocab, lexicon, qp, kanas),
             "50k fused": ("50k fused", config, vocab, lexicon, qp, kanas),
             "50k bf16": ("50k bf16", config, vocab, lexicon, params, kanas),
             "config 5": ("config 5", cfg5, vocab5, lexicon5, qp5, kanas)}
    runs = []
    for i, label in enumerate(RUNS):
        trace = os.path.join(out_dir, f"serve_trace_{i}_{label.replace(' ', '_')}.json")
        summary = profile_run(dev, cells[label], trace)
        print(json.dumps(summary, indent=1), flush=True)
        runs.append(summary)
        torch.cuda.empty_cache()
    with open(args.out, "w") as f:
        json.dump({"card": card, "runs": runs}, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
