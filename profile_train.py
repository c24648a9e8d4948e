#!/usr/bin/env python3
"""Profile of the port's training step on one GPU.

Run from the repository root on a machine with one CUDA card:
``python3 profile_train.py [--out FILE] [--root DIR] [--only LABEL] [--wide]``.  It
trains ``chip_smoke.py``'s training configuration (V=50,000, E=256,
H=512, one layer, batch 32 x window 32, Adam, fused CE) from the same
weights and data in three ways, in turns: the LSTM as a loop of plain
steps with the CE kernels, the same with each CE kernel swapped for its
plain version, and ``--pallas-scan`` (the LSTM through the scan's
kernels, CE kernels on: the forward's two, the backward's three).
``--root`` imports ``jlm_tpu_torch`` from another checkout (a parent commit
unpacked into a git-ignored directory, so that two trees are profiled in
turns, each in its own process); ``--only`` keeps the turns of one run
label; ``--wide`` trains at H = E = 1,024 (``chip_smoke.py``'s phase 5d
width, weights from ``init_params``) instead.  Per run: 3 warm-up steps, then the host-clock
ms/step of 10 steps (ending in a synchronize), then 5 steps under
``torch.profiler``.  From the profile: device busy ms per step (the sum of
device activity; one stream), the idle share of the profiled wall time and
of the unprofiled step time, device activities per step, and each CE and
scan kernel's ms per step and share of device time, matched by the exact
function names of ``csrc/softmax_ce.cu`` and ``csrc/lstm_scan.cu``.
Prints one JSON summary per run and writes them to ``--out``, each run's
gzipped chrome trace beside it.
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import json
import os
import shutil
import subprocess
import sys
import time

import torch

from chip_smoke import HW, N_CE, TB, TT, bench_data, plain_ce, training_corpus

# the device functions of csrc/softmax_ce.cu and csrc/lstm_scan.cu
# (ce_bwd_dh_kernel and ce_bwd_dw_kernel are templates since their wgmma
# redesign, named the same; cast_wt_kernel, the step's transposing cast of
# W, came with it: an older tree's plain cast is a PyTorch kernel; the bf16
# forward is ce_fwd_bf16_kernel since its wgmma redesign, ce_fwd_kernel in
# a tree from before it)
CE_KERNELS = ("ce_fwd_bf16_kernel", "ce_fwd_kernel", "ms_merge_kernel", "ce_bwd_dh_kernel",
              "sum_splits_kernel", "ce_bwd_dw_kernel", "cast_wt_kernel")
# (lstm_scan_fwd_kernel: the forward of a tree from before its split into
# scan_gemm_kernel + scan_fwd_recur_kernel, profiled with --root)
SCAN_KERNELS = ("scan_fwd_recur_kernel", "scan_gemm_kernel", "scan_gemm_bf16_kernel",
                "scan_recur_kernel", "lstm_scan_fwd_kernel")
WARMUP, TIMED, PROFILED = 3, 10, 5


def kernel_name(name: str) -> str:
    """The bare function name (no template arguments) of a device
    activity's demangled name."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0]
    return name.split("<")[0].split(" ")[-1]


def profile_run(dev, config, params, train_ids, label: str, swap, trace_path: str) -> dict:
    """One run of ``config``'s training steps, inside ``swap`` (a context
    that swaps kernels for plain versions) if given."""
    from jlm_tpu_torch.train import Trainer

    trainer = Trainer(config, params, device=dev)
    with swap() if swap else contextlib.nullcontext():
        steps = trainer.train_steps(train_ids, epoch=0)
        for _ in range(WARMUP):
            next(steps)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TIMED):
            next(steps)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / TIMED
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILED):
                next(steps)
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
    ce = {k: by_name.get(k, 0.0) / PROFILED for k in CE_KERNELS}
    scan = {k: by_name.get(k, 0.0) / PROFILED for k in SCAN_KERNELS}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {
        "run": label,
        "steps_profiled": PROFILED,
        "unprofiled_ms_per_step": step_ms,
        "unprofiled_tokens_per_s": N_CE / step_ms * 1e3,
        "profiled_wall_ms_per_step": wall_ms / PROFILED,
        "device_busy_ms_per_step": busy / PROFILED,
        "idle_share_profiled": 1 - busy / wall_ms,
        "idle_share_unprofiled": 1 - busy / PROFILED / step_ms,
        "device_activities_per_step": count / PROFILED,
        "ce_kernels_ms_per_step": sum(ce.values()),
        "ce_share_of_device": sum(ce.values()) * PROFILED / busy if busy else 0.0,
        "ce_ms_per_step_by_kernel": ce,
        "scan_kernels_ms_per_step": sum(scan.values()),
        "scan_share_of_device": sum(scan.values()) * PROFILED / busy if busy else 0.0,
        "scan_ms_per_step_by_kernel": scan,
        "top_ms_per_step": {k: v / PROFILED for k, v in top},
        "trace": trace_path + ".gz",
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out/train_profile.json")
    ap.add_argument("--root", default=None, help="import jlm_tpu_torch from this checkout")
    ap.add_argument("--only", default=None, help="run only the turns of this run label")
    ap.add_argument("--wide", action="store_true", help="train at H = E = 1,024")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train: needs one CUDA card", file=sys.stderr)
        return 1
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    config, vocab, _, params, _, _ = bench_data()
    config = config.replace(batch_size=TB, num_steps=TT, fused_ce=True)
    if args.wide:
        from jlm_tpu_torch.models.params import init_params

        config = config.replace(hidden_size=HW, embed_size=HW)
        params = init_params(config)
    runs_of = {"CE kernels": (config, None), "CE plain versions": (config, plain_ce),
               "scan kernels": (config.replace(use_pallas_scan=True), None)}
    train_ids, _ = training_corpus(vocab)
    runs = []
    turns = ("CE kernels", "scan kernels", "CE plain versions",
             "CE plain versions", "scan kernels", "CE kernels")
    turns = tuple(t for t in turns if args.only in (None, t))
    for i, label in enumerate(turns):
        trace = os.path.join(out_dir, f"train_trace_{i}_{label.replace(' ', '_')}.json")
        cfg, swap = runs_of[label]
        summary = profile_run(dev, cfg, params, train_ids, label, swap, trace)
        print(json.dumps(summary, indent=1), flush=True)
        runs.append(summary)
    with open(args.out, "w") as f:
        json.dump({"card": card, "tree": args.root or ".", "wide": args.wide, "runs": runs}, f,
                  indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
