#!/usr/bin/env python3
"""Device times of the decode frame's kernels and the LSTM scan, both ways.

Run from the repository root on a machine with one CUDA card:
``python3 time_kernels.py [--root DIR] [--only PARTS] [--out FILE]``.  ``--root`` imports
``jlm_tpu_torch`` from DIR instead (another checkout of the repository, for
example a parent commit unpacked into a git-ignored directory), so that two
trees are timed in turns, each in its own process, on one card.

At the serving frame (S = 2,048 sentences of B = 10 beam rows, C1 = 65
candidate columns, E = 256, H = 512, bf16; ``chip_smoke.py``'s shapes) it
times ``cand_dot`` against ``torch.baddbmm``, ``lstm_cell_step`` against
``torch.lstm_cell``, ``cell_cand_step`` against the split pair
``lstm_cell_step`` + ``cand_dot`` and the library pair ``torch.lstm_cell`` +
``torch.baddbmm``, the fp32 cell (the parity mode, R = 512 rows) against
``torch.lstm_cell`` in fp32, and the int8-MXU head (``project_lse``, R = 20,480) at
V = 50,000 on slices 512, 1,024, 1,536 and 2,048 wide and at BASELINE
config 5's D-softmax blocks.  At the training window (B = T = 32) it times
``lstm_scan_fwd`` and ``lstm_scan_bwd`` in fp32 and bf16 at H = E = 1,024
and in fp32 at H = 512, E = 256, each beside cuDNN's LSTM forward or
backward (``torch.nn.LSTM`` on the same weights, its backward alone on a
retained graph, TF32 off), and, where the tree has them, each direction's
kernels alone (``scan_xw``, ``scan_fwd_recur``, ``scan_gates``,
``scan_recur``, the recurrences with 4 and 8 units a block, ``scan_dx``)
with the fp32 GEMMs' ``torch.mm`` / ``torch.addmm`` beside them.  At the
training rows (N = 1,024, V = 50,000) it times the fused CE's three bf16
kernels through their wrappers, ``ce_fwd`` (with the step's W^T given, as
in training, and casting W itself), ``ce_bwd_dh`` and ``ce_bwd_dw`` (the
bf16 cast of h and W included), the cast alone and the ``torch.addmm`` +
``torch.logsumexp`` pair, and the fp32 backward (``precision="highest"``:
``ce_bwd_dh`` and ``ce_bwd_dw`` in fp32, the wrappers' transposed copy of h
included) and the fp32 forward (``ce_fwd`` in fp32) beside their plain
versions on the card (cuBLAS fp32 products and elementwise work) and the
forward beside ``cross_entropy(addmm)``, at D = 512 and 1,024 (``--only
ce_``), and the fp32 kernels alone at D = 2,048, where the backward's
output is cut into two slices, and the fp32 forward at a D-softmax
block's width, D = 128, a third of the targets -1 (``--only ce_fwd``:
the forwards alone).  Each is
timed two ways (``chip_smoke``'s helpers): ``one_ms``, the median of 10 calls each between two CUDA events
(the wrapper's Python before the launch counts), and ``row_ms``, the events
around 50 calls in a row divided by 50 (the device's time where the device
is the slower side) with ``host_ms``, the host's time a call.  A function
that the tree refuses is recorded as its error; ``--only`` times just the
cases whose names hold one of its comma-separated parts (``--only
H1024,H512``: the scan; ``--only f32``: the fp32 parity mode's fused frame,
head and candidate extraction, ``f32_cases``).  Prints one JSON line (the
card's name and power limit in it) and appends it to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

from chip_smoke import (BLOCKS5, N_CE, R32, R_CAND, S32, TB, TT, B, C1, C_CAND, E, H, R, S, V,
                        cuda_ms, in_a_row, torch_gates)


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
    f32 = torch.float32
    x32, h32 = t(R32, E, scale=0.3, dtype=f32), t(R32, H, scale=0.5, dtype=f32)
    c32 = t(R32, H, dtype=f32)
    W32 = t(E + H, 4 * H, scale=0.05, dtype=f32)
    w_ih32, w_hh32, b_ih32 = torch_gates(W32, b)
    out += [("lstm_cell_step fp32", lambda: lstm_cell_step(x32, h32, c32, W32, b, 1.0)),
            ("torch.lstm_cell fp32", lambda: torch.lstm_cell(
                x32, (h32, c32), w_ih32, w_hh32, b_ih32, torch.zeros_like(b_ih32)))]

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
    out += f32_cases(dev, g, cfg5)
    for hw, ew, cd in ((1024, 1024, torch.float32), (1024, 1024, bf), (512, 256, torch.float32)):
        out += scan_cases(dev, g, hw, ew, cd)
    for d in (512, 1024):
        out += ce_cases(dev, g, d)
    out += ce_cases(dev, g, 2048, parts=("fp32 fwd", "fp32 bwd"))
    out += ce_cases(dev, g, 128, parts=("fp32 fwd",), unowned_every=3)
    return out


def f32_cases(dev, g, cfg5):
    """The exact-fp32 parity mode's frame kernels (``--only f32``): the
    fused frame ``cell_cand_step`` at the fp32 parity run's frame (S = 64
    sentences of B = 8 rows, C1 = 65) and at E = 40, H = 24, beside the
    split pair it replaces (``lstm_cell_step`` + ``cand_dot`` in fp32) and
    the library pair ``torch.lstm_cell`` + ``torch.baddbmm`` (2 calls, not
    ranked); the fp32 head (``project_lse``) on config 5's D-softmax head
    and the 50k int8 head dequantized to fp32, at R = 512 rows; candidate
    extraction in fp32 and dequant fp32 at 50k and on config 5's head (R =
    800 rows, C = 65 ids; the wrappers transpose W per call, as
    ``chip_smoke.py`` times them), beside the fp32 50k head's lse alone at
    those rows (W^T made once)."""
    from jlm_tpu_torch.ops.cand_dot import cand_dot
    from jlm_tpu_torch.ops.frame_step import cell_cand_step
    from jlm_tpu_torch.ops.lstm_cell import lstm_cell_step
    from jlm_tpu_torch.ops.project import (project_candidates, project_candidates_dsoftmax,
                                           project_lse)

    f32 = torch.float32

    def t(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    out = []
    B32 = R32 // S32
    for e, hw in ((E, H), (40, 24)):
        x, h = t(R32, e, scale=0.3), t(R32, hw, scale=0.5)
        c, W, b = t(R32, hw), t(e + hw, 4 * hw, scale=0.05), t(4 * hw, scale=0.1)
        cols, cbias = t(S32, C1, hw, scale=0.05), t(S32, C1, scale=0.1)
        tag = "" if (e, hw) == (E, H) else f" E{e} H{hw}"
        out.append((f"cell_cand_step f32{tag}",
                    lambda x=x, h=h, c=c, W=W, b=b, cols=cols, cbias=cbias: cell_cand_step(
                        x, h, c, W, b, cols, cbias, B32, 1.0)))
        if tag:
            continue

        def split_pair(x=x, h=h, c=c, W=W, b=b, cols=cols, cbias=cbias, hw=hw):
            c_n, h_n = lstm_cell_step(x, h, c, W, b, 1.0)
            return c_n, cand_dot(h_n.reshape(S32, B32, hw), cols, cbias)

        w_ih, w_hh, b_ih = torch_gates(W, b)
        b_hh, cols_t, cb = torch.zeros_like(b_ih), cols.transpose(1, 2), cbias[:, None, :]

        def library_pair(x=x, h=h, c=c, hw=hw):
            c_l, h_l = torch.lstm_cell(x, (h, c), w_ih, w_hh, b_ih, b_hh)
            return c_l, torch.baddbmm(cb, h_l.reshape(S32, B32, hw), cols_t)

        out += [("lstm_cell_step f32 + cand_dot f32 (split pair)", split_pair),
                ("torch.lstm_cell + torch.baddbmm f32 (2 calls)", library_pair)]

    def with_wt(W, b):
        return {"W": W, "b": b, "WT": W.t().contiguous()}

    head5 = {"blocks": [with_wt(t(d, n, scale=0.5), t(n, scale=0.1)) for n, d in BLOCKS5]}
    q = torch.randint(-127, 128, (H, V), generator=g, device=dev, dtype=torch.int8)
    sq = t(V, scale=0.001).abs() + 1e-4
    head_d = {"W": {"q": q, "scale": sq}, "b": t(V, scale=0.1), "WT": q.t().contiguous()}
    h32 = t(R32, H, scale=0.5)
    out += [("project_lse f32 config 5",
             lambda: project_lse(h32, head5, cfg5, compute_dtype=f32)),
            ("project_lse dequant f32 50k", lambda: project_lse(h32, head_d, None,
                                                                 compute_dtype=f32))]
    hc = t(R_CAND, H, scale=0.3)
    Wf, bc = t(H, V, scale=0.5), t(V, scale=0.1)
    head_f = with_wt(Wf, bc)
    out.append(("project_lse f32 50k R800",
                lambda: project_lse(hc, head_f, None, compute_dtype=f32)))
    ids = torch.randint(0, V, (C_CAND,), generator=g, device=dev)
    ids5 = torch.randint(0, sum(n for n, _ in BLOCKS5), (C_CAND,), generator=g, device=dev)
    blocks5 = [{"W": blk["W"], "b": blk["b"]} for blk in head5["blocks"]]
    out += [("project_candidates f32",
             lambda: project_candidates(hc, Wf, None, bc, ids, compute_dtype=f32)),
            ("project_candidates dequant f32",
             lambda: project_candidates(hc, q, sq, bc, ids, compute_dtype=f32)),
            ("project_candidates dsoftmax f32",
             lambda: project_candidates_dsoftmax(hc, blocks5, cfg5, ids5, compute_dtype=f32))]
    return out


def ce_cases(dev, g, D, parts=("bf16", "fp32 fwd", "fp32 bwd"), unowned_every=0):
    """The fused CE's kernels through their wrappers at the training rows
    (N = 1,024, V = 50,000, fp32 master values), in ``parts``: "bf16", its
    three kernels: ``ce_fwd`` casting W itself (``cast_wt``) and, as the
    trainer's step calls it, with the step's W^T given (``wt``: the kernel
    alone; a tree whose forward takes no ``wt`` records the refusal); the
    cast alone; the yardstick pair ``torch.addmm`` bf16 +
    ``torch.logsumexp`` (2 calls, not ranked); and ``ce_bwd_dh`` and
    ``ce_bwd_dw`` with the mean loss's cotangent, casting W as before;
    "fp32 fwd", ``ce_fwd`` in fp32 beside its plain version, the fp32 GEMM
    loop alone on the same operands (``scan_xw``: h @ W by the scan's
    ``scan_gemm_kernel<KN>``, its [N, V] output written) and, where every
    target is owned, the yardstick ``cross_entropy(addmm)`` (2 calls, not
    ranked); "fp32 bwd", ``ce_bwd_dh`` and ``ce_bwd_dw`` in fp32 with the
    same cotangent, each beside its plain version.  ``unowned_every``: every
    so many targets -1 (owned by another D-softmax block)."""
    from jlm_tpu_torch.ops import lstm_scan as ls
    from jlm_tpu_torch.ops import softmax_ce as ce

    bf = torch.bfloat16
    h = torch.rand(N_CE, D, generator=g, device=dev) * 2 - 1
    W = torch.randn(D, V, generator=g, device=dev) * 0.05
    b = torch.randn(V, generator=g, device=dev) * 0.1
    y = torch.randint(0, V, (N_CE,), generator=g, device=dev)
    if unowned_every:
        y[::unowned_every] = -1
    m, s = ce.ce_fwd_raw_ref(h, W, b, y, bf)[:2]
    lse = m + torch.log(s)
    ga = torch.full((N_CE,), 1.0 / N_CE, device=dev)
    args = (h, W, b, y, lse, ga, -ga, bf)
    m32, s32 = ce.ce_fwd_raw_ref(h, W, b, y, torch.float32)[:2]
    args32 = (h, W, b, y, m32 + torch.log(s32), ga, -ga, torch.float32)
    wt = ce.cast_wt(W, D)
    hb, Wb, bb = h.to(bf), W.to(bf), b.to(bf)
    f32 = torch.float32
    out = []
    if "fp32 fwd" in parts:
        out += [(f"ce_fwd fp32 D{D}", lambda: ce.ce_fwd_raw(h, W, b, y, f32)),
                (f"ce_fwd fp32 plain D{D}", lambda: ce.ce_fwd_raw_ref(h, W, b, y, f32)),
                (f"ce_fwd fp32 loop alone scan_xw D{D}", lambda: ls.scan_xw(h, W))]
        if not unowned_every:
            out.append((f"ce_fwd fp32 yardstick cross_entropy(addmm) D{D} (2 calls)",
                        lambda: torch.nn.functional.cross_entropy(torch.addmm(b, h, W), y,
                                                                  reduction="none")))
    if "fp32 bwd" in parts:
        out += [(f"ce_bwd_dh fp32 D{D}", lambda: ce.ce_bwd_dh(*args32)),
                (f"ce_bwd_dh fp32 plain D{D}", lambda: ce.ce_bwd_dh_ref(*args32)),
                (f"ce_bwd_dw fp32 D{D}", lambda: ce.ce_bwd_dw(*args32)),
                (f"ce_bwd_dw fp32 plain D{D}", lambda: ce.ce_bwd_dw_ref(*args32))]
    if "bf16" not in parts:
        return out
    return [(f"ce_fwd bf16 D{D}", lambda: ce.ce_fwd_raw(h, W, b, y, bf)),
            (f"ce_fwd bf16 D{D} wt", lambda: ce.ce_fwd_raw(h, W, b, y, bf, wt=wt)),
            (f"ce_fwd's cast_wt D{D}", lambda: ce.cast_wt(W, D)),
            (f"ce_fwd yardstick torch.addmm + torch.logsumexp bf16 D{D} (2 calls)",
             lambda: torch.logsumexp(torch.addmm(bb, hb, Wb), dim=1)),
            (f"ce_bwd_dh bf16 D{D}", lambda: ce.ce_bwd_dh(*args)),
            (f"ce_bwd_dw bf16 D{D}", lambda: ce.ce_bwd_dw(*args))] + out


def scan_cases(dev, g, Hs, Es, cd):
    """The scan forward and backward at B = TB, T = TT (fp32 master values,
    ``cd`` compute), cuDNN's LSTM forward and backward in ``cd`` beside
    them, and each direction's kernels alone where the tree has them (with
    the fp32 GEMMs' library calls)."""
    from jlm_tpu_torch.ops import lstm_scan as ls

    def t(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    xs, W, b = t(TB, TT, Es, scale=0.3), t(Es + Hs, 4 * Hs, scale=0.05), t(4 * Hs, scale=0.1)
    c0, h0 = t(TB, Hs, scale=0.3), t(TB, Hs, scale=0.3)
    hs, cs = ls.lstm_scan_ref(xs, W, b, c0, h0, 1.0, cd)[:2]
    d_hs, d_cf, d_hf = t(TB, TT, Hs), t(TB, Hs), t(TB, Hs)
    saved = (xs, W, b, c0, h0, hs, cs, d_hs, d_cf, d_hf)
    name = f"{'bf16' if cd == torch.bfloat16 else 'fp32'} H{Hs}"
    lstm = torch.nn.LSTM(Es, Hs, batch_first=True).to(dev)
    with torch.no_grad():
        for p, v in zip((lstm.weight_ih_l0, lstm.weight_hh_l0, lstm.bias_ih_l0),
                        torch_gates(W, b)):
            p.copy_(v)
        lstm.bias_hh_l0.zero_()
    lstm = lstm.to(cd)
    leaves = [a.to(cd).clone().requires_grad_(True) for a in (xs, h0, c0)] + list(lstm.parameters())
    hs_l, (h_T, c_T) = lstm(leaves[0], (leaves[1][None], leaves[2][None]))
    d_out = (d_hs.to(cd), d_hf[None].to(cd), d_cf[None].to(cd))
    fwd_in = (xs, W, b, c0, h0)

    def cudnn_fwd():
        with torch.no_grad():
            return lstm(leaves[0], (leaves[1][None], leaves[2][None]))

    out = [(f"lstm_scan_fwd {name}", lambda: ls.lstm_scan_fwd(*fwd_in, 1.0, cd)),
           (f"cuDNN LSTM fwd {name}", cudnn_fwd),
           (f"lstm_scan_bwd {name}", lambda: ls.lstm_scan_bwd(*saved, 1.0, cd)),
           (f"cuDNN LSTM bwd {name}",
            lambda: torch.autograd.grad((hs_l, h_T, c_T), leaves, d_out, retain_graph=True))]
    fp32 = cd == torch.float32
    if hasattr(ls, "scan_xw"):
        Zx = ls.scan_xw_ref(xs, W[:Es], cd)
        out += [(f"scan_xw {name}", lambda: ls.scan_xw(xs, W[:Es], cd))]
        out += [(f"scan_fwd_recur {name} nu{nu}",
                 lambda nu=nu: ls.scan_fwd_recur(Zx, W[Es:], b, c0, h0, 1.0, cd, nu=nu))
                for nu in (4, 8)]
    if fp32:
        out += [(f"torch.mm xw {name}", lambda: torch.mm(xs.reshape(-1, Es), W[:Es]))]
    if hasattr(ls, "scan_recur"):
        xh = torch.cat([xs, torch.cat([h0[:, None], hs[:, :-1]], dim=1)], dim=2)
        Z = ls.scan_gates_ref(xh, W, b, cd)
        dz, buf = torch.empty_like(Z), torch.empty_like(Z)
        out += [(f"scan_gates {name}", lambda: ls.scan_gates(xh, W, b, cd))]
        out += [(f"scan_recur {name} nu{nu}",
                 lambda nu=nu: ls.scan_recur(Z, W[Es:], c0, cs, d_hs, d_cf, d_hf, 1.0, cd,
                                             out=buf, nu=nu)) for nu in (4, 8)]
        out += [(f"scan_dx {name}", lambda: ls.scan_dx(dz, W[:Es], cd))]
    if fp32:
        xh2 = torch.cat([xs, torch.cat([h0[:, None], hs[:, :-1]], dim=1)], dim=2)
        dz2 = torch.randn(TB * TT, 4 * Hs, generator=g, device=dev)
        out += [(f"torch.addmm gates {name}",
                 lambda: torch.addmm(b, xh2.reshape(-1, Es + Hs), W)),
                (f"torch.mm dx {name}", lambda: torch.mm(dz2, W[:Es].t()))]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=None, help="import jlm_tpu_torch from this checkout")
    ap.add_argument("--only", default="",
                    help="time only the cases whose names hold one of these comma-separated parts")
    ap.add_argument("--out", default="build/kernel_times.jsonl")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_kernels: needs a CUDA card", file=sys.stderr)
        return 1
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
    import jlm_tpu_torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    times = {}
    for name, fn in cases(dev):
        if not any(part in name for part in args.only.split(",")):
            continue
        try:
            one = cuda_ms(fn)
            row, host = in_a_row(fn)
            times[name] = {"one_ms": one, "row_ms": row, "host_ms": host}
        except (RuntimeError, ValueError, TypeError) as e:
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
