#!/usr/bin/env python3
"""Device times of the decode frame's kernels at the serving frame, both ways.

Run from the repository root on a machine with one CUDA card:
``python3 time_kernels.py [--root DIR] [--out FILE]``.  ``--root`` imports
``jlm_tpu_torch`` from DIR instead (another checkout of the repository, for
example a parent commit unpacked into a git-ignored directory), so that two
trees are timed in turns, each in its own process, on one card.

At the serving frame (S = 2,048 sentences of B = 10 beam rows, C1 = 65
candidate columns, E = 256, H = 512, bf16; ``chip_smoke.py``'s shapes) it
times ``cand_dot`` against ``torch.baddbmm``, ``lstm_cell_step`` against
``torch.lstm_cell``, ``cell_cand_step`` against the split pair
``lstm_cell_step`` + ``cand_dot`` and the library pair ``torch.lstm_cell`` +
``torch.baddbmm``, and the int8-MXU head (``project_lse``, R = 20,480) at
V = 50,000 on slices 512, 1,024, 1,536 and 2,048 wide and at BASELINE
config 5's D-softmax blocks.  Each is timed two ways (``chip_smoke``'s
helpers): ``one_ms``, the median of 10 calls each between two CUDA events
(the wrapper's Python before the launch counts), and ``row_ms``, the events
around 50 calls in a row divided by 50 (the device's time where the device
is the slower side) with ``host_ms``, the host's time a call.  A function
that the tree refuses is recorded as its error.  Prints one JSON line (the
card's name and power limit in it) and appends it to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

from chip_smoke import BLOCKS5, B, C1, E, H, R, S, V, cuda_ms, in_a_row, torch_gates


def cases(dev):
    """(name, call) pairs on inputs made on the card from one seed."""
    from jlm_tpu_torch.config import Config, DSoftmaxConfig
    from jlm_tpu_torch.ops.cand_dot import cand_dot
    from jlm_tpu_torch.ops.frame_step import cell_cand_step
    from jlm_tpu_torch.ops.lstm_cell import cell_weight_tiles, lstm_cell_step
    from jlm_tpu_torch.ops.project import project_lse

    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def t(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    x, h, c = t(R, E, scale=0.3), t(R, H, scale=0.5), t(R, H)
    W, b = t(E + H, 4 * H, scale=0.05), t(4 * H, scale=0.1, dtype=torch.float32)
    cell_weight_tiles(W, E, H)  # kept on W, as build_decode_head makes it
    h3 = t(S, B, H, scale=0.5)
    cols, cbias = t(S, C1, H, scale=0.05), t(S, C1, scale=0.1, dtype=torch.float32)
    w_ih, w_hh, b_ih = torch_gates(W, b)
    b_ih, b_hh = b_ih.to(bf), torch.zeros(4 * H, dtype=bf, device=dev)
    cbias_b, cols_t = cbias.to(bf)[:, None, :], cols.transpose(1, 2)

    def cell():
        return lstm_cell_step(x, h, c, W, b, 1.0, compute_dtype=bf, c_out_dtype=bf)

    def split_pair():
        c_n, h_n = cell()
        return c_n, cand_dot(h_n.reshape(S, B, H), cols, cbias)

    def library_pair():
        c_l, h_l = torch.lstm_cell(x, (h, c), w_ih, w_hh, b_ih, b_hh)
        return c_l, torch.baddbmm(cbias_b, h_l.reshape(S, B, H), cols_t)

    out = [
        ("cand_dot bf16", lambda: cand_dot(h3, cols, cbias)),
        ("torch.baddbmm", lambda: torch.baddbmm(cbias_b, h3, cols_t)),
        ("lstm_cell_step bf16", cell),
        ("torch.lstm_cell", lambda: torch.lstm_cell(x, (h, c), w_ih, w_hh, b_ih, b_hh)),
        ("cell_cand_step bf16",
         lambda: cell_cand_step(x, h, c, W, b, cols, cbias, B, 1.0, compute_dtype=bf)),
        ("lstm_cell_step + cand_dot", split_pair),
        ("torch.lstm_cell + torch.baddbmm", library_pair),
    ]

    def int8_head(d, n):
        q = torch.randint(-127, 128, (d, n), generator=g, device=dev, dtype=torch.int8)
        return {"W": {"q": q, "scale": t(n, scale=0.001, dtype=torch.float32).abs() + 1e-4},
                "b": t(n, scale=0.1, dtype=torch.float32), "WT": q.t().contiguous()}

    for d in (512, 1024, 1536, 2048):
        hd, head = t(R, d, scale=0.5), int8_head(d, V)
        out.append((f"project_lse int8 D{d}",
                    lambda hd=hd, head=head: project_lse(hd, head, None, compute_dtype=bf,
                                                         int8_mxu=True)))
    cfg5 = Config(vocab_size=sum(n for n, _ in BLOCKS5), hidden_size=H, head="dsoftmax",
                  dsoftmax=DSoftmaxConfig(block_sizes=tuple(n for n, _ in BLOCKS5),
                                          block_dims=tuple(d for _, d in BLOCKS5)))
    head5 = {"blocks": [int8_head(d, n) for n, d in BLOCKS5]}
    h5 = t(R, H, scale=0.5)
    out.append(("project_lse dsoftmax int8",
                lambda: project_lse(h5, head5, cfg5, compute_dtype=bf, int8_mxu=True)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=None, help="import jlm_tpu_torch from this checkout")
    ap.add_argument("--out", default="build/kernel_times.jsonl")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_kernels: needs a CUDA card", file=sys.stderr)
        return 1
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
    import jlm_tpu_torch

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    times = {}
    for name, fn in cases(dev):
        try:
            one = cuda_ms(fn)
            row, host = in_a_row(fn)
            times[name] = {"one_ms": one, "row_ms": row, "host_ms": host}
        except (RuntimeError, ValueError) as e:
            times[name] = {"error": str(e).splitlines()[0][:200]}
        print(f"{name}: {times[name]}", flush=True)
    line = json.dumps({"tree": os.path.dirname(jlm_tpu_torch.__file__), "card": card,
                       "times": times})
    print(line)
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "a") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
