#!/usr/bin/env python3
"""Profile of the port's per-keystroke serving (BASELINE config 4) on one GPU.

Run from the repository root on a machine with one CUDA card:
``python3 profile_keystroke.py [--out chiprun_out/keystroke_profile.json]``.
Under ``torch.profiler`` (device time: every CUDA kernel and copy it
records, summed):

- ``project_lse`` at the keystroke paths' rows (``chip_smoke.py``'s
  ``keystroke_cases``: int8-MXU at R = 10, 40, 640, dequant fp32 at
  R = 10, config 5's D-softmax int8 at R = 10 and 640), device µs a call
  over 50 calls and each kernel's share;
- ``IncrementalDecoder`` typing 10 of the 50 test sentences (speed mode,
  ``speculate`` 0 and 4; the parity mode) and ``SessionServer`` at 64
  sessions (probes on and off): device µs a keystroke or a push, wall µs
  under the profiler, the idle share of that wall time, the top kernels.

Prints one line per reading with the card's name and power limit and
writes them all to ``--out`` as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

SENTENCES = 10  # typed per decoder run
SESSIONS = 64


def profiled(fn, n: int):
    """(device µs a call, by kernel name, wall µs a call under the
    profiler): ``chip_smoke.profiled`` in µs."""
    import chip_smoke as cs

    ms, by, wall = cs.profiled(fn, n)
    return ms * 1e3, {k: v * 1e3 for k, v in by.items()}, wall * 1e3


def top(by, k=6, scale=1.0):
    return {name[:48]: round(us / scale, 2)
            for name, us in sorted(by.items(), key=lambda kv: -kv[1])[:k]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out/keystroke_profile.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_keystroke: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from jlm_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    _build.lib()
    out = {"card": card, "heads": [], "decoders": []}

    cases = cs.keystroke_cases(dev, np.random.default_rng(0))
    for name, kernel, *_ in cases:
        us, by, wall = profiled(kernel, 50)
        print(f"{name}: device {us:.2f} us a call, wall {wall:.1f} us; {top(by, 4)} on {card}",
              flush=True)
        out["heads"].append({"case": name, "device_us": us, "wall_us": wall, "by_kernel": by})
    del cases
    torch.cuda.empty_cache()

    # the head rows above need only ops/project.py, so they also run (and
    # then stop here) in an earlier tree without the decoders
    from jlm_tpu_torch.decoder import IncrementalDecoder, SessionServer

    config, vocab, lexicon, _params, qp, kanas = cs.bench_data()
    sentences = kanas[:SENTENCES]
    n_keys = sum(len(k) for k in sentences)

    def typing(dec):
        def run():
            for kana in sentences:
                dec.reset()
                for ch in kana:
                    dec.push(ch)
        return run

    for label, kw in (("keystroke, speculate 0", {"precision": "default"}),
                      ("keystroke, speculate 4", {"precision": "default", "speculate": 4}),
                      ("keystroke, parity", {"precision": "highest", "use_kernel": True})):
        dec = IncrementalDecoder(qp, lexicon, vocab, config, device=dev, **kw)
        us, by, wall = profiled(typing(dec), 3)
        print(f"{label}: device {us / n_keys:.1f} us a keystroke, wall {wall / n_keys:.1f} us "
              f"(profiled), idle {1 - us / wall:.3f}; {len(by)} kernels; "
              f"{top(by, scale=n_keys)} on {card}", flush=True)
        out["decoders"].append({"run": label, "device_us": us / n_keys,
                                "wall_us": wall / n_keys, "by_kernel": by})
        del dec

    texts = [kanas[i % len(kanas)] for i in range(SESSIONS)]
    n_push = max(len(x) for x in texts)
    for probes in (True, False):
        srv = SessionServer(qp, lexicon, vocab, config, max_sessions=SESSIONS,
                            precision="default", probes=probes, device=dev)

        def serve():
            sids = [srv.open() for _ in texts]
            for t in range(n_push):
                srv.push([(s, x[t]) for s, x in zip(sids, texts) if t < len(x)])
            for s in sids:
                srv.close(s)

        label = f"server, {SESSIONS} sessions, probes {'on' if probes else 'off'}"
        us, by, wall = profiled(serve, 3)
        print(f"{label}: device {us / n_push:.1f} us a push, wall {wall / n_push:.1f} us "
              f"(profiled), idle {1 - us / wall:.3f}; {top(by, scale=n_push)} on {card}",
              flush=True)
        out["decoders"].append({"run": label, "device_us": us / n_push,
                                "wall_us": wall / n_push, "by_kernel": by})
        del srv
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
