#!/usr/bin/env python3
"""What separates chunking from arithmetic in ``decode_long``, on one GPU.

Run from the repository root on a machine with one CUDA card:
``python3 long_witness.py [--out chiprun_out/long_witness.json]``.

At the bench's width (V = 50,000, E = 256, H = 512, beam 10, int8
weights) and, for two weight sets, BASELINE config 5, ``chip_smoke.py``'s
``long_readings`` on each weight set of ``VARIANTS``: inputs of 42 to 62
kana searched in one scan and chunked at 41 and 16 with the same forward
(the int8 speed mode, the exact-fp32 kernel forward), each forward's
top-1 against the uncapped int8 oracle on those inputs and on phase 3e's
four long ones, and what the deliberate faults of ``chip_smoke.planted``
read there.  Weight sets: the random init (near-uniform log-probs), the
head alone scaled to 0.5 (``chip_smoke.PEAKED``), the embedding to 1 and
the head to 0.5 (``chip_smoke.long_peaked``), and every weight to 0.2.

Prints one JSON line a reading with the card's name and power limit and
writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

import chip_smoke as cs


def scaled(params, std):
    """Every weight matrix (embedding, LSTM, head) scaled to ``std``."""
    def scale(w):
        w = np.asarray(w, np.float32)
        return w * np.float32(std / w.std())

    head = params["head"]
    head = ({"blocks": [{**b, "W": scale(b["W"])} for b in head["blocks"]]}
            if "blocks" in head else {**head, "W": scale(head["W"])})
    return {**params, "embedding": scale(params["embedding"]),
            "lstm": [{**l, "W": scale(l["W"])} for l in params["lstm"]], "head": head}


VARIANTS = {
    "init": lambda p: p,
    "head 0.5": cs.peaked,
    "embedding 1, head 0.5": cs.long_peaked,
    "all 0.2": lambda p: scaled(p, 0.2),
}
CONFIG5_VARIANTS = ("init", "embedding 1, head 0.5")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/long_witness.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("long_witness: needs one CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    config, vocab, lexicon, params, _, kanas = cs.bench_data()
    cfg5, vocab5, lexicon5, params5, _ = cs.bench_data5()
    shorts = cs.witness_inputs(kanas)
    longs = cs.long_inputs(kanas, lexicon, config.max_kana_len)
    rows = []

    def emit(row):
        row = {**row, "card": card}
        rows.append(row)
        print(json.dumps(row, ensure_ascii=False), flush=True)

    emit({"inputs": {"short": [len(k) for k in shorts], "long": [len(k) for k in longs]}})
    for name, make in VARIANTS.items():
        t0 = time.perf_counter()
        got = cs.long_readings(dev, config, vocab, lexicon, make(params), shorts, longs)
        emit({"model": "50k", "weights": name, **got, "s": time.perf_counter() - t0})
        torch.cuda.empty_cache()
    for name in CONFIG5_VARIANTS:
        t0 = time.perf_counter()
        got = cs.long_readings(dev, cfg5, vocab5, lexicon5, VARIANTS[name](params5), shorts[:2],
                               longs[:1], faults=False)
        emit({"model": "config 5", "weights": name, **got, "s": time.perf_counter() - t0})
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, ensure_ascii=False, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
