#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``jlm_tpu_torch``) on one GPU.

Run from the repository root on a machine with one Hopper card and the CUDA
toolkit:  ``python3 chip_smoke.py``.  Phases, none of them caught:

1. print the card, its power limit, the torch/CUDA versions, and build the
   kernels from ``jlm_tpu_torch/csrc`` with nvcc (sm_90a);
2. compare each kernel with its plain PyTorch version on the card at the
   shapes its path gives it, with a stated bound, and time both (CUDA
   events): the three decode kernels at the
   serving shapes (the int8 head's bound shown to catch its ragged last
   vocab tile left unmasked, the bf16 cell's two gates swapped), the head in
   its other modes (the 100k D-softmax head of BASELINE config 5 in int8
   and bf16 at the serving rows, the int8 dequant head at 50k in bf16 at
   the serving rows and in fp32 at the fp32 parity run's rows, fp32
   weights at the config-5 head) and the fp32 cell at the fp32 parity
   run's rows, the three fused-CE kernels, the LSTM scan's forward and
   backward, the forward's two kernels (``scan_xw``, ``scan_fwd_recur``)
   and the backward's three (``scan_gates``, ``scan_recur``, ``scan_dx``),
   each on its plain version's inputs, at the training shapes, and the D-softmax fused CE at the 100k D-softmax
   head; each backward bound is also shown to catch a deliberately wrong
   plain backward (a p-term off by ``P_SHIFT``, a forget gate off by
   ``F_SHIFT``; the CE backward's also by a trap of its design,
   ``ce_bwd_traps``: in bf16 dh without its second warpgroup's columns,
   dW without its last row tile; in fp32 (at D = 512 and 1,024) dh from
   logits without their last K chunk, dW without its last chunk of rows;
   the bf16 CE forward's, which reads the step's W^T,
   by its second warpgroup reading the first's rows and by the target
   logit without its bias, at the 50k head and at a D-softmax block's
   width, D = 128, with a third of the targets owned by no column), the
   int8 D-softmax bound one whose activation scale is
   taken over all H instead of each block's slice, the fp32 and fp32
   dequant bounds a plain version whose operands are rounded to TF32, and
   the bf16 dequant bound one that rescales the exact int8 product after
   it instead of rounding ``q * scale`` to bf16 before it (these four
   modes on weights of scale ``PEAKED``); cuDNN's LSTM is timed beside the
   scan kernels as a yardstick (the port never calls it); and the kernels
   that finish the table: the fp32 fused CE at the training shape (its
   forward also at a D-softmax block's width, D = 128, a third of the
   targets owned by no column; the forward's logits without their last K
   chunk of 16, a trap of its design, too),
   candidate extraction at ``scripts/bench_kernels.py``'s shape in five
   weight modes and on config 5's head, and the fused cell + candidate
   frame kernel in bf16 and fp32 (``port_cases``: TF32 operands, a
   p-term off, or a candidate read from its neighbouring column must read
   above the bounds; the fp32 frame's dots without the last 32-unit
   group's share, a trap of its design, too; so must the fp32 and dequant
   fp32 heads' lse without the last K chunk of 16); and the widths past 512 (``wide_cases``, H = E =
   1,024: the bf16 and dequant-bf16 heads on a 1,024-wide slice, the
   fused CE at D = 1,024 in bf16 and fp32, the scan in fp32 and bf16
   forward and backward and each direction's kernels, each with a wrong
   version, and the forward at a batch of 16,384); ``cand_dot`` in fp32
   and at a beam of 20 (wrong: beam rows 8 on read from rows 0 on) and
   the width repairs (``odd_width_cases``: the int8-MXU head on 1,536- and
   2,048-wide slices, wrong: K past 1,024 dropped; both cells at E = 30,
   H = 20 and the fused frame at E = 40, H = 24, wrong: W padded at its
   end instead of per gate); every case is timed one call at a time and 50
   calls in a row (``in_a_row``), the fused frame beside the split pair it
   replaces;
2b. candidate extraction through ``project_candidates`` and
   ``project_candidates_dsoftmax`` as ``scripts/bench_kernels.py`` drives
   them, one launch per block counted;
3. drive the serving path — streaming beam-10 conversion at V=50,000,
   E=256, H=512, one layer, int8 head, speed mode — over one 2,048-lattice
   chunk through ``BeamDecoder.decode_stream``, and check that every decode
   kernel was launched by it;
4. check top-1 path identity against the numpy oracle on the 50 test
   sentences: fp32 greedy, int8 beam-10, and bf16 beam-10 (50/50 each);
3c. drive the same chunk through ``make_fused_frame_forward`` (kernel 9:
   the fused cell + candidate dots, then ``project_lse``) for ``PASSES``
   passes in turns with the split forward: per forward one
   ``cell_cand_step`` and one ``project_lse``, no ``lstm_cell_step`` or
   ``cand_dot``; chars/s of both; 50/50 beam-10 parity vs the int8 oracle;
   and the fp32 fused frame greedy on the 50 sentences, 50/50 vs the fp32
   oracle with scores within 1e-3;
3b. drive BASELINE config 5 on one card — 2 layers, V=100,000, D-softmax
   prefix head (16,000 x 512, 34,000 x 256, 50,000 x 128), int8 weights,
   native int8 head, speed mode — over the same 2,048-lattice chunk for
   ``PASSES`` passes; the counting rule: every forward (the root forward
   and one per frame) launches the projection kernel once per block (3),
   the cell once per layer (2) and ``cand_dot`` once;
4b. 50/50 top-1 path identity on the 50 test sentences for config 5 with
   int8-MXU beam-10 (vs the int8 oracle), bf16 beam-10 (vs the fp32
   oracle) and the fp32 kernel forward greedy (vs the fp32 oracle, scores
   within 1e-3), and for the 50k int8 dequant head beam-10 (vs the int8
   oracle) and the 50k fp32 int8-dequant kernel forward greedy (vs the
   int8 oracle, scores within 1e-3); then the fp32 greedy runs again (50k
   and config-5 kernel forward, 50k dequant, 50k fused frame) on head
   weights of scale ``PEAKED``, where an operand rounded to TF32 would
   move a score; each run's launches are counted by the same rule;
3d. drive per-keystroke serving (BASELINE config 4: the 50k int8 weights,
   the int8-MXU head) through ``IncrementalDecoder``, ``SessionServer``
   and ``Suggester`` (``keystroke_run``): the 50 sentences typed one kana
   at a time in speed mode (final top-1 50/50 vs the int8 oracle), with
   ``speculate=4`` (the same n-best at every keystroke; hits and misses)
   and in the parity mode (every prefix's top-1 equal to the fp32
   ``BeamDecoder``'s, final scores within 1e-3 of the int8 oracle); the
   server at 64 sessions, probes on and off, every session equal to the
   single-session decoder's; config 5 typed (final top-1 50/50 vs its int8
   oracle) and served the same way; the suggester's top 5 vs the oracle;
   latency p50 / p99 a keystroke and a push, keystrokes/s; every push's
   ``project_lse`` launches counted by row count (one per head block, two
   with speculation); phase 2 holds ``project_lse`` to its plain version
   at these rows (``keystroke_cases``: R = 10, 40, 640 int8-MXU, R = 10
   dequant fp32, R = 10 and 640 config 5's D-softmax int8);
3e. drive ``decode_long`` (inputs past ``max_kana_len``: multi-root
   overlap-save chunks, ``long_run``) through ``BeamDecoder.decode`` on the
   50 sentences joined into three inputs of about 150 kana and on one with
   a word across the first cut: int8 speed mode on the random weights
   (each top-1 reads the input and is the uncapped int8 oracle's or a path
   within 1e-2 of it where paths tie); on weights where paths do not tie,
   the int8 speed mode and the exact-fp32 forward each with the same n-best
   chunked as in one scan (inputs of 42 to 62 kana) and every top-1 the
   oracle's, three planted chunking faults failing both gates; the fused
   frame equal to the split one, fp32 greedy and config 5 each equal to
   its uncapped oracle, one ``decode_batch`` of short and
   long inputs equal to each input's own call, launches counted for each
   input; ms per input, chars/s and an idle share; phase 2 holds the
   kernels at its shapes (``long_cases``: ``project_lse`` int8 and config
   5's D-softmax int8 at ``score_hidden``'s 50 rows, ``cand_dot`` bf16 at
   S = 1 and 5, ``lstm_cell_step`` bf16 at 10 rows);
3f. (run after phase 5, whose losses it reads) vocab and data
   parallelism with every rank a process on this one card over Gloo
   (``shard_run``): BASELINE config 3 (V 50,000, D-softmax 8,000 x 512,
   17,000 x 256, 25,000 x 128, int8-MXU) on a (1, 4) world and config 5 on
   (2, 4), the 2,048-lattice chunk through the sharded kernel forward:
   top-1 50/50 vs the int8 oracle, n-best equal to the one-card kernel
   forward's with scores within 1e-4, every rank the same batch, launches
   per rank (per forward one projection a block, one cell a layer, one
   ``cand_dot``); config 3's fp32 kernel forward greedy on ``PEAKED``
   heads 50/50 vs the fp32 oracle; ``Suggester(mesh=)``'s top 5 equal to
   one card's; ``sharded_topk`` on planted ties; ``all_reduce`` MAX on
   CUDA tensors equal to the gathered max; on the (2, 4) world five
   ``--fused-ce`` steps at phase 5's width through the CE kernels on
   vocab shards (losses within ``TRAIN_BOUNDS`` of phase 5's, one launch
   of each CE kernel a rank, block and step), a step's gradient and a
   clipped SGD step equal to one card's, and four planted faults
   (``SHARD_FAULTS``: dh summed twice, never; an owner map off by one
   block; the clip on a rank's own norm) each failing a gate; ms per chunk
   and per step, marked as ranks sharing one card; phase 2 holds the
   kernels at a rank's shapes (``shard_cases``);
3g. (after 3f) the time-block pipeline (``--mesh-seq``) with every rank a
   process on this card over Gloo (``seq_run``): phase 5's width and
   batch on a seq mesh of ``SEQ_P`` stages, ``SEQ_M`` microbatches, five
   ``--fused-ce`` Adam steps (losses within ``TRAIN_BOUNDS`` of phase
   5's, one launch of each bf16 CE kernel a rank and step, the final
   carries equal on every rank and, after the first window, to one
   card's), a step's gradient and a clipped SGD step equal to one card's,
   three planted faults (``SEQ_FAULTS``: the carry cotangent never passed
   left, the gradients averaged over the seq group, the halo read from
   the next slot) each failing a gate; then ``python -m
   jlm_tpu_torch.scripts.prepare_data --stream`` beside its in-memory
   path (vocab.tsv and ids bit-equal) and ``python -m jlm_tpu_torch.train
   --mesh-seq 4 --fused-ce`` for one epoch on the streamed data dir; ms a
   step, marked as ranks sharing one card; phase 2 holds the CE kernels at
   a stage's rows (``seq_qs_cases``: 256 x 50,000, D 512);
3h. (after 3g) ``python -m jlm_tpu_torch.scripts.quality_stats --fused-ce``
   at a reduced size (``QS_ARGS``): BASELINE config 5's shape trained,
   then decoded through ``BeamDecoder`` (launches counted); on the trained
   weights the fp32 greedy kernel forward path-identical to the fp32
   oracle on the first ``QS_GATED`` test sentences, bf16 and int8 beam-10
   against their oracles reported (paths that differ, score gaps); phase
   2 holds the kernels at its shapes (``seq_qs_cases``: the D-softmax CE
   per block at a step's rows, the bf16 D-softmax head, both layers'
   cells and ``cand_dot`` at its 256-sentence beam-10 chunk);
5. drive the training path — ``Trainer`` at the same width, batch 32, BPTT
   window 32, Adam, fused CE — for 20 steps over the synthetic corpus, once
   through the CE kernels and once with each swapped for its plain
   version: the loss falls, the two runs agree, every CE kernel was
   launched once per forward or backward, and dev perplexity agrees;
5b. the same 20 steps with ``use_pallas_scan=True`` (the ``--pallas-scan``
   path), once through the scan kernels and once with each swapped for its
   plain version: the loss falls, the two runs agree, step 1 agrees with
   phase 5's loop run, and the forward, the backward and each of their
   five kernels were launched once per layer per step;
5c. ``full_softmax_loss(..., precision="highest")`` with ``fused_ce``
   forward and backward through autograd on the 50k head and on config
   5's D-softmax head (the fp32 CE kernels, one launch of each per block)
   vs the plain fp32 log-softmax route;
5d. the paths at H = E = 1,024 (``wide_run``): ``WIDE_STEPS``
   ``--pallas-scan --fused-ce`` training steps against the loop path
   (launches counted), the fp32 fused CE, the bf16 scan through autograd
   and the 1,024-wide bf16 and dequant heads through their entry points;
5e. the width repairs through their entry points (``odd_width_run``):
   ``BeamDecoder`` at E = 30, H = 20 greedy fp32 (50/50 vs the oracle),
   beam-10 and beam-20 bf16; the fused frame at E = 40, H = 24 greedy
   fp32 (50/50) and beam-10 int8; ``BeamDecoder`` at H = 2,048 with an
   int8-MXU head; one ``project_lse`` on a 1,536-wide int8 slice;
6. save the trained weights, reload the checkpoint, and decode the 50
   sentences fp32 greedy: 50/50 top-1 identity with the oracle on them.

Weights are random (``init_params`` seed 0) before training.  Phases 3c,
3b, 4b, 3d and 3e are the serving path's other modes; they run after phase
4, 3d after 4b, 3e after 3d.  The line
before the card's is ``{"kernels": [...]}``: per kernel its launches on the
main path, its error against the plain version, its time (one call, and
50 calls in a row: ``row_ms``, ``row_host_ms``), the plain
version's and the library call's (``library_ms``, ``library_row_ms``)
where one PyTorch call computes the same function, its bound (the least time the card could take, from the bytes
and operations of this run's inputs and, for the head, its R x V
exponentials at 16 a clock per SM and the card's max SM clock) and the
CUDA function behind it.  The last line is
``{"ok": true, "device": {...}}``; any failure exits non-zero before it.
Nothing of JAX or of the JAX package is imported (the oracle is numpy).
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# main-path shapes (bench.py): 2,048 lattices per chunk, beam_pad 10
S, B, C1 = 2048, 10, 65
V, E, H = 50_000, 256, 512
R = S * B
PASSES = 3
# BASELINE config 5's D-softmax head (config.default_dsoftmax_blocks(100_000, 512))
V5 = 100_000
BLOCKS5 = ((16_000, 512), (34_000, 256), (50_000, 128))  # (words, dims) per block
HEAD5 = sum(n * d for n, d in BLOCKS5)  # weights of the head: 23,296,000
# the fp32 parity run: 50 sentences bucket to 64, greedy beam_pad 8
S32 = 64
R32 = S32 * 8
# candidate extraction (scripts/bench_kernels.py:48): 50 sentences x 16 beam
# rows, 65 candidates
R_CAND, C_CAND = 800, 65
# the head's rows on the per-keystroke paths (phase 3d): one keystroke's
# beam, speculate=4's four frames in one forward, the server at 64 events
KEY_ROWS = {"R10": B, "R40": 4 * B, "R640": 64 * B}
# config 5's D-softmax int8 head on the same paths: a keystroke, the server
KEY_ROWS5 = {"R10": B, "R640": 64 * B}
SESSIONS = 64  # the server's sessions in phase 3d
# decode_long (phase 3e): the 50 test sentences joined and cut at sentence
# boundaries into inputs of about LONG_LEN kana (each past T_c + (T_c - M) =
# 119: a first, a mid and a last chunk); a seeded chunk's score_hidden runs
# one project_lse over M x B rows (M = max_word_len = 5) and one cand_dot
# over M "sentences" of B beams; a chunk's frame runs at S = 1
LONG_LEN, SEED_M = 150, 5
LONG_ROWS = {"R50": SEED_M * B}
LONG_CANDS = {"S1": 1, "S5": SEED_M}
SPECULATE = 4
# weight scale of the fp32 and dequant cases: h in (-1, 1) then gives
# logits that spread over tens of units, so the largest few set the lse and
# an operand rounding moves it by about the rounding of one logit; at the
# serving weights' 0.05 the softmax is near uniform over the vocabulary and
# such roundings average away in the lse
PEAKED = 0.5
# training shapes: batch 32 x BPTT window 32 = 1,024 CE rows per step
TB, TT, TRAIN_STEPS = 32, 32, 20
N_CE = TB * TT
# a D-softmax block's hidden width (config 5's third block), for the forward
DS_D = 128
# the widest width the port trains and serves (python -m jlm_tpu_torch.train
# --hidden-size 1024; E = H), driven for WIDE_STEPS training steps
HW, WIDE_STEPS = 1024, 3
# the card's published dense peaks at 700 W (NVIDIA H100 SXM data sheet)
PEAK = {"int8": 1979e12, "bf16": 989e12, "fp32": 67e12, "bytes": 3.35e12}
BOUNDS = {  # kernel vs plain version, on the same inputs on the card
    "project_lse int8": 1e-4,   # abs, lse; the int32 product is exact
    "project_lse bf16": 1e-3,   # abs, lse; fp32 sums in another order
    "lstm_cell_step bf16": 2.0,  # bf16 ulps of c' and h' (see bf16_ulps)
    # the head's other modes: per block as above, merged in fp32
    "project_lse dsoftmax int8": 1e-4,  # abs, lse; exact int32 products
    "project_lse dsoftmax bf16": 1e-3,  # abs, lse; fp32 sums in another order
    # the next three on weights of scale PEAKED; each wrong call must read
    # above its bound
    "project_lse dequant bf16": 1e-3,   # abs, lse; bf16(q * scale) on both sides;
                                        # wrong: the int8 product rescaled after
    "project_lse fp32": 1e-4,           # abs, lse; exact fp32 products, sums in
                                        # another order; wrong: TF32 operands
    "project_lse dequant fp32": 1e-4,   # as fp32, q * scale rounded to fp32
    # abs, lse, rows whose largest |h| lies outside the narrower blocks; a
    # scale taken over all H must read above it
    "project_lse dsoftmax int8 slice scale": 1e-4,
    "lstm_cell_step fp32": 1e-5,  # abs, c' and h'; exact fp32 products
    "cand_dot bf16": 1e-3,      # abs error / max(1, max |plain|)
    "ce_fwd bf16": 1e-3,        # abs, per-row loss and lse; fp32 sums in another order;
                                # wrong: rows 64 on of each 128 from the 64 before,
                                # the target logit without its bias
    "ce_fwd bf16 D128": 1e-3,   # the same at a D-softmax block's width
    # backward: abs error / max |plain| (of dh; of dW and db).  Both sides
    # round gp to bf16, and a gp element on a rounding boundary may round
    # the other way.  Two cotangents: the mean loss's (ga = 1/N, gb = -ga),
    # where the one-hot term sets max |plain|, and the p-term alone (gb = 0,
    # random ga).  Each bound lies between the sound reading and that of a
    # p-term off by P_SHIFT, which phase 2 reads too and which must exceed
    # it; readings on an H100 (sound / p-term 26% low): 1.3e-5 / 4.0e-3,
    # 3.0e-6 / 4.3e-3, 3.8e-5 / 0.26, 2.6e-4 / 0.26.
    "ce_bwd_dh bf16": 1e-4,
    "ce_bwd_dw bf16": 1e-4,
    "ce_bwd_dh bf16 p-term": 1e-3,
    "ce_bwd_dw bf16 p-term": 2e-3,  # ~1,024-term sums of h * gp: flips weigh more
    "lstm_scan_fwd fp32": 1e-5,  # abs, hs, cs, c_T, h_T; exact fp32 products, sums
                                 # in another order
    "lstm_scan_fwd bf16": 2e-3,  # abs; a sum-order difference may flip one bf16
                                 # rounding of h_{t-1}, which later steps carry
    # backward: max over dz, dx, dc0, dh0 of |kernel - plain| / (2e-4 + 1e-4
    # |plain|), the reference tests' gradient bound as one number; the plain
    # version with its forget gate off by F_SHIFT must read above it
    "lstm_scan_bwd fp32": 1.0,
    # the backward's three kernels, each on its plain version's inputs: the
    # gate recompute Z and dx as abs error / max |plain| (the same rounded
    # operands on both sides, products exact in fp32, sums in another
    # order; wrong: h_t in place of h_{t-1}, Wh's rows in place of Wx's);
    # the recurrence by the scan criterion above (wrong: the forget gate off
    # by F_SHIFT)
    "scan_gates fp32": 1e-5,
    "scan_recur fp32": 1.0,
    "scan_dx fp32": 1e-5,
    # the forward's two kernels, each on its plain version's inputs: the
    # input product Zx as abs error / max |plain| (wrong: x_{t+1} in place
    # of x_t); the recurrence's hs, cs, c_T, h_T as lstm_scan_fwd's (wrong:
    # a forget bias off by F_SHIFT)
    "scan_xw fp32": 1e-5,
    "scan_fwd_recur fp32": 1e-5,
    # fp32 compute, weights of scale PEAKED; a plain version on operands
    # rounded to TF32 must read above each bound
    "ce_fwd fp32": 1e-4,        # abs, per-row loss and lse; exact fp32 products
    "ce_fwd fp32 D128": 1e-4,   # the same at a D-softmax block's width
    "ce_bwd_dh fp32": 1e-4,     # abs error / max |plain|, the mean loss's cotangent;
    "ce_bwd_dw fp32": 1e-4,     # gp is not rounded, so only the sum order differs
    "ce_bwd_dh fp32 p-term": 1e-4,  # the p-term alone; a p-term off by P_SHIFT
    "ce_bwd_dw fp32 p-term": 1e-4,  # must read above
    # abs, candidate log-probs [R, C]; each raw logit is the value the online
    # lse takes, so the error is the lse's; a candidate read from its
    # neighbouring column must read above each bound
    "project_candidates fp32": 1e-4,
    "project_candidates dequant fp32": 1e-4,
    "project_candidates dequant bf16": 1e-3,
    "project_candidates int8": 1e-4,
    "project_candidates dsoftmax int8": 1e-4,
    "project_candidates dsoftmax fp32": 1e-4,
    # the larger of lstm_cell_step bf16's reading over its bound 2.0 and
    # the candidate error, beyond what h' elements rounded the other way
    # explain, over 1e-4 of max(1, max |plain|) (see port_cases.frame_err);
    # the dots on h' before its bf16 rounding must read above
    "cell_cand_step bf16": 1.0,
    # abs, c', h' and the candidate logits; exact fp32 products; wrong: TF32
    # operands
    "cell_cand_step fp32": 1e-5,
    # the widths past 512 (H = E = 1,024), each with the bound and the reason
    # of its 512-wide counterpart above; the bf16 scan backward: abs error /
    # max |plain| over dz, dx, dc0, dh0 (dz rounded to bf16 on both sides; a
    # flipped bf16 rounding of h_{t-1} is carried back through the window)
    "project_lse bf16 D1024": 1e-3,
    "project_lse dequant bf16 D1024": 1e-3,
    "ce_fwd bf16 D1024": 1e-3,
    "ce_bwd_dh bf16 D1024": 1e-4,
    "ce_bwd_dw bf16 D1024": 1e-4,
    "ce_fwd fp32 D1024": 1e-4,
    "ce_bwd_dh fp32 D1024": 1e-4,
    "ce_bwd_dw fp32 D1024": 1e-4,
    "lstm_scan_fwd fp32 H1024": 1e-5,
    # abs: a flipped bf16 rounding of h_{t-1} (up to 2^-8 |h| = 3.9e-3 at
    # |h| < 1) is carried through the window, and at H = 1,024 each step
    # has twice the sums that can flip one; a forget bias off by F_SHIFT
    # reads ~0.17
    "lstm_scan_fwd bf16 H1024": 1e-2,
    "lstm_scan_bwd fp32 H1024": 1.0,
    "lstm_scan_bwd bf16 H1024": 1e-2,
    "scan_gates fp32 H1024": 1e-5,
    "scan_recur fp32 H1024": 1.0,
    "scan_dx fp32 H1024": 1e-5,
    "scan_gates bf16 H1024": 1e-5,
    "scan_recur bf16 H1024": 1e-2,  # as lstm_scan_bwd bf16 H1024
    "scan_dx bf16 H1024": 1e-5,
    "scan_xw fp32 H1024": 1e-5,
    "scan_fwd_recur fp32 H1024": 1e-5,
    "scan_xw bf16 H1024": 1e-5,
    "scan_fwd_recur bf16 H1024": 1e-2,  # as lstm_scan_fwd bf16 H1024
    # the forward at B = 16,384, T = 1, E = 16, H = 1,024 (a batch whose
    # carries once filled a block's shared memory): as lstm_scan_fwd fp32
    "lstm_scan_fwd fp32 B16384": 1e-5,
    # cand_dot's other modes: abs error / max(1, max |plain|); fp32: exact
    # fp32 FMAs, sums in another order; each wrong call (beam rows 8 on read
    # from rows 0 on) must read above
    "cand_dot fp32": 1e-5,
    "cand_dot bf16 B20": 1e-3,
    "cand_dot fp32 B20": 1e-5,
    # the width repairs, each with the bound and the reason of its aligned
    # counterpart above (the int8 head past 1,024: exact int32 products)
    "project_lse int8 D1536": 1e-4,
    "project_lse int8 D2048": 1e-4,
    "lstm_cell_step bf16 E30 H20": 2.0,
    "lstm_cell_step fp32 E30 H20": 1e-5,
    "cell_cand_step bf16 E40 H24": 1.0,
    "cell_cand_step fp32 E40 H24": 1e-5,
    # the head at the keystroke paths' rows, each a partial row block (as
    # project_lse int8 and dequant fp32 above; the dequant fp32 case on
    # weights of scale PEAKED); each wrong call must read above: beam rows
    # 8 on read from rows 0 on, the last row read as zeros (a row mask one
    # short)
    **{f"project_lse int8 {tag}": 1e-4 for tag in KEY_ROWS},
    "project_lse dequant fp32 R10": 1e-4,
    # config 5's three blocks at those rows, as project_lse dsoftmax int8;
    # a third wrong call: the last block's partials lost (a merge offset
    # one block short)
    **{f"project_lse dsoftmax int8 {tag}": 1e-4 for tag in KEY_ROWS5},
    # decode_long's shapes (long_cases), each with the bound and the wrong
    # calls of its serving-frame counterpart above
    **{f"project_lse int8 {tag}": 1e-4 for tag in LONG_ROWS},
    **{f"project_lse dsoftmax int8 {tag}": 1e-4 for tag in LONG_ROWS},
    **{f"cand_dot bf16 {tag}": 1e-3 for tag in LONG_CANDS},
    "lstm_cell_step bf16 R10": 2.0,
}
# phase 3e's gates (abs), the readings from long_witness.py on an H100.
# Where paths do not tie (weights long_peaked): "witness", each input's
# n-best chunked at WITNESS_CUTS vs one scan of the same forward (every
# sound reading 0.0; the planted faults 21.6..93 or an n-best entry lost);
# each top-1 the uncapped int8 oracle's (float64 sums), its score within
# "exact fp32 vs oracle" (the exact-fp32 kernel forward, read at most
# 1.5e-4) or "int8 vs oracle" (the speed mode's bf16 states, read at most
# 0.091; a wrong seed row's identical path reads 21.6).  On the random
# weights the 150-kana paths tie to 1e-5..4e-3 (homophones such as 橋/端),
# which bf16 or fp32 rounding decides: each int8 top-1 reads the input
# and is the oracle's, its score within "random int8 score" (read at most
# 2.0e-4), or a path the oracle's LM scores within "random int8 tie" of
# its best (read at most 3.73e-3; there a wrong seed row reads 9.4e-3 on
# one input, so this gate alone cannot tell it).  fp32 greedy vs the
# uncapped fp32 greedy oracle; a batched call vs each input's own call
LONG_BOUNDS = {"witness": 1e-3, "exact fp32 vs oracle": 1e-3, "int8 vs oracle": 0.15,
               "random int8 score": 1e-3, "random int8 tie": 1e-2,
               "fp32 vs oracle": 1e-3, "batch vs own call": 1e-3}
# decode_long's witness: inputs of WITNESS_LENS kana (one scan at 62 holds
# each) chunked at WITNESS_CUTS against that one scan, the same forward, on
# weights where paths do not tie (long_peaked: embedding and head standard
# deviations LONG_PEAK); and the deliberate faults (planted) it must catch
WITNESS_LENS = (62, 58, 54, 50, 46, 42)
WITNESS_CUTS = (41, 16)
LONG_PEAK = (1.0, 0.5)
LONG_FAULTS = ("seed rows shifted", "window one kana late", "overlap mask one frame long")
# phase 3d's gates beside the oracle's (abs): "speed" holds speculation
# against speculate 0 and the server against the single session, the same
# kernels at 10, 40 or 640 rows, whose fp32 sums run in another order (the
# sound runs read at most 1.5e-5; a row scattered to the wrong beam slot
# moves a score by far more); the parity mode's scores; suggest's logp
KEY_BOUNDS = {"speed": 1e-3, "parity vs oracle": 1e-3, "suggest logp": 1e-4}
# lse + P_SHIFT in the plain backward: a p-term exp(-0.3) = 0.74 of its value
P_SHIFT = 0.3
# forget_bias + F_SHIFT in the plain scan backward: the dc carry and df take
# sigmoid(f + 0.3) for sigmoid(f)
F_SHIFT = 0.3
DSOFTMAX_BOUNDS = {  # the D-softmax fused CE (bf16 compute) at the 100k head
    "loss vs fp32": 1e-3,    # abs, mean loss, vs fp32 plain CE over the logits
    "grads vs fp32": 1e-2,   # abs error / max |plain| of hs and every block's W
                             # and b: bf16 rounding; checks the block merge and
                             # the one-hot term, too loose for the p-term
    "grads vs plain": 1e-4,  # the same code through the plain versions: as
    "p-term grads vs plain": 2e-3,  # the ce_bwd_* cases (p-term: no block
                                    # owns a target, random row weights)
}
FP32_CE_BOUNDS = {  # the fp32 fused CE vs the plain fp32 log-softmax route
    "loss": 1e-5,    # abs, mean loss; exact fp32 products, sums in another order
    "grads": 1e-4,   # abs error / max |plain| of hs and every W and b
}
TRAIN_BOUNDS = {  # a kernels' run vs the plain versions' run (and, at step 1,
                  # the scan run vs the loop run)
    "step 1 loss": 1e-3,  # abs; the same arithmetic up to fp32 sum order
    "last loss": 1e-2,    # relative, after 20 Adam steps
    "dev ppl": 1e-3,      # relative
}


def log(*a):
    print(*a, flush=True)


def check(ok: bool, what: str) -> None:
    """Fail the run (unlike ``assert``, this survives ``python -O``)."""
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def cuda_ms(fn, reps: int = 10) -> float:
    """Median device time of one call, from CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def in_a_row(fn, n: int = 50):
    """(ms a call between two CUDA events around ``n`` calls in a row, host
    ms a call before the card is waited for): the first is the device's
    time where the device is the slower side, the second the caller's
    Python and launch time, which a one-call time (``cuda_ms``) adds in
    front of the device's."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    host = (time.perf_counter() - t0) / n * 1e3
    stop.synchronize()
    return start.elapsed_time(stop) / n, host


def bf16_ulps(a: torch.Tensor, ref: torch.Tensor) -> float:
    """Max |a - ref| in bf16 ulps (8-bit mantissa) at max(|ref|, 2**-8):
    below 2**-8 the fp32 sum-order noise (~1e-6 absolute) of a value that
    cancels to near zero would count as many ulps of a tiny number."""
    a, ref = a.float(), ref.float()
    mag = ref.abs().clamp(min=2.0 ** -8)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((a - ref).abs() / ulp).max())


@contextlib.contextmanager
def plain_ce(lse_shift: float = 0.0):
    """Swap the three CE kernel wrappers of ``jlm_tpu_torch.ops.softmax_ce``
    and the cast of W^T for their plain versions, where the fused CE's
    autograd Functions look them up.  With ``lse_shift`` the backward ones
    compute a wrong p-term, ``exp(l - lse - lse_shift)``, which a bound
    must catch."""
    from jlm_tpu_torch.ops import softmax_ce as ce

    kernels = ce.ce_fwd_raw, ce.ce_bwd_dh, ce.ce_bwd_dw, ce.cast_wt

    def shifted(ref):  # (the kernels' W^T, wt=, has no use in the plain versions)
        return lambda h, W, b, y, lse, *rest, wt=None: ref(h, W, b, y, lse + lse_shift, *rest)

    def fwd_ref(h, W, b, y, compute_dtype=torch.float32, wt=None):
        return ce.ce_fwd_raw_ref(h, W, b, y, compute_dtype)

    ce.ce_fwd_raw = fwd_ref
    ce.ce_bwd_dh, ce.ce_bwd_dw = shifted(ce.ce_bwd_dh_ref), shifted(ce.ce_bwd_dw_ref)
    ce.cast_wt = ce.cast_wt_ref
    try:
        yield
    finally:
        ce.ce_fwd_raw, ce.ce_bwd_dh, ce.ce_bwd_dw, ce.cast_wt = kernels


@contextlib.contextmanager
def plain_scan():
    """Swap the two scan kernel wrappers of ``jlm_tpu_torch.ops.lstm_scan``
    for their plain versions, where the scan's autograd Function looks them
    up."""
    from jlm_tpu_torch.ops import lstm_scan as ls

    kernels = ls.lstm_scan_fwd, ls.lstm_scan_bwd
    ls.lstm_scan_fwd, ls.lstm_scan_bwd = ls.lstm_scan_ref, ls.lstm_scan_bwd_ref
    try:
        yield
    finally:
        ls.lstm_scan_fwd, ls.lstm_scan_bwd = kernels


def rel_err(got, want):
    """Max over the tensor pairs of max |got - want| / max |want|."""
    return max(float((a.float() - w.float()).abs().max()) / float(w.abs().max())
               for a, w in zip(got, want))


def abs_err(k, p):
    return float((k.float() - p.float()).abs().max())


def abs_errs(k, p):
    """(max absolute error, the same) over a tensor or a tuple of tensors."""
    k, p = (k, p) if isinstance(k, tuple) else ((k,), (p,))
    err = max(abs_err(a, b) for a, b in zip(k, p))
    return err, err


def scan_bwd_err(k, p):
    """The allclose criterion of the reference's tests as one number: max
    over the tensors of |kernel - plain| / (2e-4 + 1e-4 |plain|)."""
    return (max(float(((a - w).abs() / (2e-4 + 1e-4 * w.abs())).max()) for a, w in zip(k, p)),
            max(abs_err(a, w) for a, w in zip(k, p)))


def second_half_fault(h, block_rows):
    """Rows of every second group of ``block_rows`` replaced by the group
    before it: what the bf16 head gives if its second consumer warpgroup
    (rows 64 .. 127 of a 128-row block) read the first's rows."""
    rows = torch.arange(h.shape[0], device=h.device)
    second = (rows // block_rows) % 2 == 1
    return h[torch.where(second, rows - block_rows, rows)]


def ce_fwd_err(k, p):
    """Of two ``(m, s, t)`` triples: the larger error of loss and lse."""
    (mk, sk, tk), (mp, sp, tp) = k, p
    lse_k, lse_p = mk + torch.log(sk), mp + torch.log(sp)
    err = max(abs_err(lse_k - tk, lse_p - tp), abs_err(lse_k, lse_p))
    return err, err


def bwd_err(k, p):
    """Error relative to max |plain| over a gradient or a tuple of them,
    and the max absolute error."""
    k, p = (k, p) if isinstance(k, tuple) else ((k,), (p,))
    return rel_err(k, p), max(abs_err(a, b) for a, b in zip(k, p))


def frame_err_of(cols):
    """The fused frame's error fn for candidate columns ``cols [S, C1,
    H]``: the larger of c' and h' error in bf16 ulps over its bound 2.0 and
    the candidate error beyond what h' elements rounded the other way
    explain (sum of |h'_k - h'_p| |cols|), relative to max(1, max |plain|),
    over its bound 1e-4 (what is left is fp32 sum order): at most 1.0."""
    S_, _, H_ = cols.shape

    def frame_err(k, p):
        slack = torch.einsum("sbh,sch->sbc",
                             (k[1].float() - p[1].float()).abs().reshape(S_, -1, H_),
                             cols.float().abs())
        cand = float(((k[2] - p[2]).abs() - slack).max()) / max(1.0, float(p[2].abs().max()))
        state = max(bf16_ulps(k[0], p[0]), bf16_ulps(k[1], p[1]))
        return max(state / 2.0, cand / 1e-4), max(abs_err(a, b) for a, b in zip(k, p))

    return frame_err


def gates_padded_at_the_end(x, h, c, W, b, m):
    """The cell's padding done wrong, for widths off the kernel's multiple
    ``m``: W's 4H gate columns and its E + H rows, and b, padded at their
    ends instead of per gate and per operand, then the plain cell on the
    padded operands, sliced back: the gates and the h rows fall out of
    place."""
    from jlm_tpu_torch.ops.lstm_cell import lstm_cell_ref

    E_, H_ = x.shape[1], h.shape[1]
    Ep, Hp = -(-E_ // m) * m, -(-H_ // m) * m
    pad = torch.nn.functional.pad
    Wn = pad(W.float(), (0, 4 * (Hp - H_), 0, Ep + Hp - E_ - H_))
    c_n, h_n = lstm_cell_ref(pad(x, (0, Ep - E_)), pad(h, (0, Hp - H_)), pad(c, (0, Hp - H_)),
                             Wn, pad(b, (0, 4 * (Hp - H_))), 1.0)
    return c_n[:, :H_], h_n[:, :H_]


def torch_gates(W, b):
    """(w_ih, w_hh, b_ih) of PyTorch's LSTM for fused ``W``, ``b``: gate
    order i, j, f, o -> PyTorch's i, f, g(= j), o, the forget bias folded
    into the bias."""
    H_ = b.shape[0] // 4
    perm = torch.cat([torch.arange(g * H_, (g + 1) * H_) for g in (0, 2, 1, 3)]).to(W.device)
    b = b.clone()
    b[2 * H_:3 * H_] += 1.0  # forget_bias
    return W[:-H_, perm].t().contiguous(), W[-H_:, perm].t().contiguous(), b[perm]


def swap_jf(t):
    """Gates i, j, f, o -> i, f, j, o: a gate-tile mapping fault."""
    i, j, f, o = t.chunk(4, dim=-1)
    return torch.cat([i, f, j, o], dim=-1)


def cell_err(k, p):
    """(bf16 ulps, max abs error) of a cell's (c', h') against its plain."""
    return (max(bf16_ulps(k[0], p[0]), bf16_ulps(k[1], p[1])),
            max(abs_err(k[0], p[0]), abs_err(k[1], p[1])))


def cand_err(k, p):
    return abs_err(k, p) / max(1.0, float(p.abs().max())), abs_err(k, p)


def second_half_rows(hh):
    """Beam rows 8 on read from rows 0 on: what the dot gives if its m16
    tile's second half took the first half's rows."""
    hw = hh.clone()
    hw[:, 8:] = hh[:, :hh.shape[1] - 8]
    return hw


def scan_stage_cases(suffix, scan_in, hs, cs, grads, cd):
    """The backward's three kernels as phase-2 cases (``kernel_cases``'
    form) on the saved values of one window: ``scan_gates`` (wrong: h_t in
    place of h_{t-1}; library: ``torch.addmm`` in fp32), ``scan_recur`` on
    the plain gates, writing into its own buffer (wrong: the forget gate off
    by F_SHIFT) and ``scan_dx`` on the plain dz (wrong: Wh's rows in place
    of Wx's; library: ``torch.mm`` in fp32)."""
    from jlm_tpu_torch.ops.lstm_scan import (
        scan_dx, scan_dx_ref, scan_gates, scan_gates_ref, scan_recur, scan_recur_ref)

    xs, W, b, c0, h0 = scan_in
    E = xs.shape[-1]
    fp32 = cd == torch.float32
    xh = torch.cat([xs, torch.cat([h0[:, None], hs[:, :-1]], dim=1)], dim=2)
    xh_t = torch.cat([xs, hs], dim=2)
    Z = scan_gates_ref(xh, W, b, cd)
    out = torch.empty_like(Z)
    rec = (Z, W[E:], c0, cs) + grads
    dz = scan_recur_ref(*rec, 1.0, cd)[0]
    Wx = W[:E]
    return [
        (f"scan_gates {suffix}", lambda: scan_gates(xh, W, b, cd),
         lambda: scan_gates_ref(xh, W, b, cd), bwd_err,
         {"h_t in place of h_{t-1}": lambda: scan_gates_ref(xh_t, W, b, cd)},
         (lambda: torch.addmm(b, xh.reshape(-1, xh.shape[-1]), W)) if fp32 else None),
        (f"scan_recur {suffix}", lambda: scan_recur(*rec, 1.0, cd, out=out),
         lambda: scan_recur_ref(*rec, 1.0, cd), scan_bwd_err if fp32 else bwd_err,
         {f"a forget gate sigmoid(f + {F_SHIFT:g})":
          lambda: scan_recur_ref(*rec, 1.0 + F_SHIFT, cd)}, None),
        (f"scan_dx {suffix}", lambda: scan_dx(dz, Wx, cd), lambda: scan_dx_ref(dz, Wx, cd),
         bwd_err, {"Wh's rows in place of Wx's": lambda: scan_dx_ref(dz, W[E:2 * E], cd)},
         (lambda: torch.mm(dz.reshape(-1, dz.shape[-1]), Wx.t())) if fp32 else None),
    ]


def scan_fwd_stage_cases(suffix, scan_in, cd):
    """The forward's two kernels as phase-2 cases on one window's inputs:
    ``scan_xw`` (wrong: x_{t+1} in place of x_t; library: ``torch.mm`` in
    fp32) and ``scan_fwd_recur`` on the plain Zx (wrong: a forget bias off
    by F_SHIFT)."""
    from jlm_tpu_torch.ops.lstm_scan import (
        scan_fwd_recur, scan_fwd_recur_ref, scan_xw, scan_xw_ref)

    xs, W, b, c0, h0 = scan_in
    E = xs.shape[-1]
    Wx, Wh = W[:E], W[E:]
    xs_next = torch.roll(xs, -1, dims=1)
    Zx = scan_xw_ref(xs, Wx, cd)
    rec = (Zx, Wh, b, c0, h0)
    return [
        (f"scan_xw {suffix}", lambda: scan_xw(xs, Wx, cd), lambda: scan_xw_ref(xs, Wx, cd),
         bwd_err, {"x_{t+1} in place of x_t": lambda: scan_xw_ref(xs_next, Wx, cd)},
         (lambda: torch.mm(xs.reshape(-1, E), Wx)) if cd == torch.float32 else None),
        (f"scan_fwd_recur {suffix}", lambda: scan_fwd_recur(*rec, 1.0, cd),
         lambda: scan_fwd_recur_ref(*rec, 1.0, cd), abs_errs,
         {f"a forget bias off by {F_SHIFT:g}":
          lambda: scan_fwd_recur_ref(*rec, 1.0 + F_SHIFT, cd)}, None),
    ]


def ce_bwd_traps(name, args):
    """Wrong versions of the backward kernels, each a trap of their design
    (csrc/softmax_ce.cu), as ``{what: call}`` of the plain version on
    ``args``.  bf16: for ce_bwd_dh the second consumer warpgroup's columns
    of every slice left out (zero); for ce_bwd_dw the last 64-row tile of
    the rows that every vocab block walks dropped, from dW and db.  fp32:
    for ce_bwd_dh the logits without their last K chunk (h's last
    ``F32_BK`` columns); for ce_bwd_dw the last output chunk (the last
    ``F32_BV`` rows of h) left out of dW, db whole."""
    from jlm_tpu_torch.ops.softmax_ce import (
        F32_BK, F32_BV, bwd_plan, ce_bwd_dh_ref, ce_bwd_dw_ref)

    h, W, b, y, lse, g_a, g_b, cd = args
    if cd == torch.float32:
        if name == "ce_bwd_dh":
            def last_k_chunk_dropped():
                hk = h.clone()
                hk[:, -F32_BK:] = 0.0
                return ce_bwd_dh_ref(hk, W, b, y, lse, g_a, g_b, cd)

            return {f"the logits without their last {F32_BK} of K": last_k_chunk_dropped}

        def last_row_chunk_dropped():
            dW, db = ce_bwd_dw_ref(*args)
            r = slice(h.shape[0] - F32_BV, None)
            return dW - ce_bwd_dw_ref(h[r], W, b, y[r], lse[r], g_a[r], g_b[r], cd)[0], db

        return {f"dW without its last {F32_BV} rows": last_row_chunk_dropped}
    if name == "ce_bwd_dh":
        def second_half_out():
            dh = ce_bwd_dh_ref(*args)
            sw = bwd_plan("dh", h.shape[0], -(-h.shape[1] // 128) * 128, b.shape[0], 132)["sw"]
            cols = torch.arange(dh.shape[1], device=dh.device)
            return torch.where((cols % sw) >= sw // 2, torch.zeros_like(dh), dh)

        return {"the second warpgroup's half of each slice's columns left out":
                second_half_out}

    def last_tile_dropped():
        keep = (h.shape[0] - 1) // 64 * 64
        return ce_bwd_dw_ref(h[:keep], W, b, y[:keep], lse[:keep], g_a[:keep], g_b[:keep],
                             cd)

    return {"the last row tile dropped": last_tile_dropped}


def kernel_cases(dev, rng):
    """Returns the cases and the yardstick runs.  A case is (name, kernel
    call, plain call, error fn, wrong call or None, library call or None);
    the error fn returns (the bounded metric, the max absolute error); the
    wrong call is the plain version with a p-term off by ``P_SHIFT`` (CE)
    or a forget gate off by ``F_SHIFT`` (scan); the library call is one
    PyTorch call computing the same function on the same inputs (gates
    reordered to PyTorch's i, f, g, o and the forget bias folded into its
    bias), timed as a yardstick only.  The yardstick runs time cuDNN's LSTM
    and the scan's autograd Function, each forward plus backward."""
    from jlm_tpu_torch.ops.quant import quantize_weight
    from jlm_tpu_torch.ops.cand_dot import cand_dot, cand_dot_ref
    from jlm_tpu_torch.ops.lstm_cell import cell_weight_tiles, lstm_cell_ref, lstm_cell_step
    from jlm_tpu_torch.ops.lstm_scan import (
        lstm_scan, lstm_scan_bwd, lstm_scan_bwd_ref, lstm_scan_fwd, lstm_scan_ref)
    from jlm_tpu_torch.ops.project import project_lse, project_lse_ref, quantize_rows
    from jlm_tpu_torch.ops.softmax_ce import (
        cast_wt, ce_bwd_dh, ce_bwd_dh_ref, ce_bwd_dw, ce_bwd_dw_ref, ce_fwd_raw, ce_fwd_raw_ref)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev).to(dtype)

    bf = torch.bfloat16
    h = t(rng.uniform(-1, 1, (R, H)), bf)
    w = rng.normal(0, 0.05, (H, V)).astype(np.float32)
    bias = t(rng.normal(0, 0.1, V))
    q = quantize_weight(w, axis=0)
    Wq = torch.from_numpy(q["q"]).to(dev)
    head_q = {"W": {"q": Wq, "scale": t(q["scale"])}, "b": bias,
              "WT": Wq.t().contiguous()}
    Wb = t(w, bf)
    head_b = {"W": Wb, "b": bias, "WT": Wb.t().contiguous()}

    x = t(rng.normal(0, 0.3, (R, E)), bf)
    c = t(rng.normal(0, 1.0, (R, H)), bf)
    Wc = t(rng.normal(0, 0.05, (E + H, 4 * H)), bf)
    bc = t(rng.normal(0, 0.1, 4 * H))

    h3 = t(rng.uniform(-1, 1, (S, B, H)), bf)
    h3_20 = t(rng.uniform(-1, 1, (S, 20, H)), bf)  # a beam of 20: two groups of rows
    cols = t(rng.normal(0, 0.05, (S, C1, H)), bf)
    cbias = t(rng.normal(0, 0.1, (S, C1)))

    # training shapes: fp32 hidden rows and master weights, cast per call
    h_ce = t(rng.uniform(-1, 1, (N_CE, H)))
    W_ce = t(rng.normal(0, 0.05, (H, V)))
    b_ce = t(rng.normal(0, 0.1, V))
    y_ce = torch.from_numpy(rng.integers(0, V, N_CE)).to(dev)
    m, s = ce_fwd_raw_ref(h_ce, W_ce, b_ce, y_ce, bf)[:2]
    lse_ce = m + torch.log(s)
    ga = torch.full((N_CE,), 1.0 / N_CE, device=dev)  # the mean loss's cotangent
    ga_p = t(rng.uniform(0.5, 1.5, N_CE) / N_CE)     # with gb = 0: the p-term alone
    cotangents = {"": (ga, -ga), " p-term": (ga_p, torch.zeros_like(ga_p))}
    # the forward's cases read the step's W^T as the trainer's forward does
    # (made once a step, outside the timed call); at a D-softmax block's
    # width (D = 128, a third of the targets owned by another block) too
    wt_ce = cast_wt(W_ce, H)
    rng_ds = np.random.default_rng(DS_D)  # its own: the later cases' draws do not move
    h_ds = t(rng_ds.uniform(-1, 1, (N_CE, DS_D)))
    W_ds = t(rng_ds.normal(0, 0.05, (DS_D, V)))
    y_ds = y_ce.clone()
    y_ds[::3] = -1
    wt_ds = cast_wt(W_ds, DS_D)

    def fwd_case(name, hh, W, yy, wt):
        """The bf16 forward and its two wrong versions: the second consumer
        warpgroup reading the first's rows, the target logit stored without
        its bias."""
        def no_bias_t():
            m, s, t_ = ce_fwd_raw_ref(hh, W, b_ce, yy, bf)
            own = (yy >= 0) & (yy < V)
            return m, s, t_ - torch.where(own, b_ce[yy.clamp(0, V - 1)], 0.0)

        return (name, lambda: ce_fwd_raw(hh, W, b_ce, yy, bf, wt=wt),
                lambda: ce_fwd_raw_ref(hh, W, b_ce, yy, bf), ce_fwd_err,
                {"the second warpgroup's rows from the first's":
                 lambda: ce_fwd_raw_ref(second_half_fault(hh, 64), W, b_ce, yy, bf),
                 "the target logit without its bias": no_bias_t}, None)

    cell_weight_tiles(Wc, E, H)  # made once and kept on Wc, as build_decode_head makes it

    def cell_plain(W=Wc, b=bc):
        c_new, h_new = lstm_cell_ref(x, h, c, W, b, 1.0)
        return c_new.to(bf), h_new.to(bf)

    def unmasked_edge():
        """The int8 head's ragged last vocab tile left unmasked: its columns
        past V, which TMA fills with zeros, enter the lse as logits of 0."""
        q, s = quantize_rows(h)
        logits = (q.float() @ Wq.float()) * s * head_q["W"]["scale"][None, :] + bias[None, :]
        pad = -V % 64
        return torch.logsumexp(torch.nn.functional.pad(logits, (0, pad)), dim=1, keepdim=True)

    def cand_case(name, hh, cc):
        return (name, lambda: cand_dot(hh, cc, cbias), lambda: cand_dot_ref(hh, cc, cbias),
                cand_err, lambda: cand_dot_ref(second_half_rows(hh), cc, cbias),
                lambda: torch.baddbmm(cbias.to(hh.dtype)[:, None, :], hh, cc.transpose(1, 2)))

    w_ih, w_hh, b_ih = torch_gates(Wc, bc)
    b_ih, b_hh = b_ih.to(bf), torch.zeros_like(b_ih, dtype=bf)

    xs = t(rng.normal(0, 0.3, (TB, TT, E)))
    Ws = t(rng.normal(0, 0.05, (E + H, 4 * H)))
    bs = t(rng.normal(0, 0.1, 4 * H))
    c0, h0 = t(rng.normal(0, 0.3, (TB, H))), t(rng.normal(0, 0.3, (TB, H)))
    hs, cs = lstm_scan_ref(xs, Ws, bs, c0, h0, 1.0)[:2]
    grads = (t(rng.normal(0, 1, (TB, TT, H))), t(rng.normal(0, 1, (TB, H))),
             t(rng.normal(0, 1, (TB, H))))
    scan_in = (xs, Ws, bs, c0, h0)
    saved = scan_in + (hs, cs) + grads

    # cuDNN's LSTM on the same weights (fp32, TF32 off), and a retained
    # graph for its backward alone
    lstm = torch.nn.LSTM(E, H, batch_first=True).to(dev)
    with torch.no_grad():
        for param, value in zip((lstm.weight_ih_l0, lstm.weight_hh_l0, lstm.bias_ih_l0),
                                torch_gates(Ws, bs)):
            param.copy_(value)
        lstm.bias_hh_l0.zero_()
    state0 = (h0[None].contiguous(), c0[None].contiguous())

    def cudnn_fwd():
        with torch.no_grad():
            return lstm(xs, state0)

    leaves = [a.clone().requires_grad_(True) for a in (xs, h0, c0)] + list(lstm.parameters())
    d_out = (grads[0], grads[2][None], grads[1][None])  # hs, h_T, c_T

    def cudnn_graph():
        hs_l, (h_T, c_T) = lstm(leaves[0], (leaves[1][None], leaves[2][None]))
        return hs_l, h_T, c_T

    graph = cudnn_graph()

    def cudnn_bwd():
        return torch.autograd.grad(graph, leaves, d_out, retain_graph=True)

    def cudnn_fwd_bwd():
        return torch.autograd.grad(cudnn_graph(), leaves, d_out)

    scan_leaves = [a.clone().requires_grad_(True) for a in scan_in]

    def scan_fwd_bwd():
        hs_s, c_T, h_T = lstm_scan(*scan_leaves, 1.0)
        return torch.autograd.grad((hs_s, c_T, h_T), scan_leaves, grads)

    log(f"cuDNN LSTM (yardstick) vs the plain fp32 scan: hs max abs "
        f"{abs_err(cudnn_fwd()[0], hs):.3e}")
    yardsticks = {"cuDNN LSTM fwd+bwd": cudnn_fwd_bwd, "lstm_scan fwd+bwd": scan_fwd_bwd}

    scan_cases = [
        (f"lstm_scan_fwd {name}",
         lambda cd=cd: lstm_scan_fwd(*scan_in, 1.0, cd),
         lambda cd=cd: lstm_scan_ref(*scan_in, 1.0, cd), abs_errs, None,
         cudnn_fwd if cd == torch.float32 else None)
        for name, cd in (("fp32", torch.float32), ("bf16", bf))
    ] + [("lstm_scan_bwd fp32",
          lambda: lstm_scan_bwd(*saved, 1.0),
          lambda: lstm_scan_bwd_ref(*saved, 1.0), scan_bwd_err,
          lambda: lstm_scan_bwd_ref(*saved, 1.0 + F_SHIFT), cudnn_bwd)]
    scan_cases += scan_fwd_stage_cases("fp32", scan_in, torch.float32)
    scan_cases += scan_stage_cases("fp32", scan_in, hs, cs, grads, torch.float32)

    bwd_cases = []
    for suffix, (g_a, g_b) in cotangents.items():
        args = (h_ce, W_ce, b_ce, y_ce, lse_ce, g_a, g_b, bf)
        wrong = (h_ce, W_ce, b_ce, y_ce, lse_ce + P_SHIFT, g_a, g_b, bf)
        for name, kernel, ref in (("ce_bwd_dh", ce_bwd_dh, ce_bwd_dh_ref),
                                  ("ce_bwd_dw", ce_bwd_dw, ce_bwd_dw_ref)):
            wrongs = {f"a p-term {1 - math.exp(-P_SHIFT):.0%} low":
                      lambda r=ref, a=wrong: r(*a)}
            if not suffix:  # the design's traps, on the mean loss's cotangent
                wrongs.update(ce_bwd_traps(name, args))
            bwd_cases.append((f"{name} bf16{suffix}", lambda k=kernel, a=args: k(*a),
                              lambda r=ref, a=args: r(*a), bwd_err, wrongs, None))

    return [
        ("project_lse int8",
         lambda: project_lse(h, head_q, None, compute_dtype=bf, int8_mxu=True),
         lambda: project_lse_ref(h, head_q, compute_dtype=bf, int8_mxu=True),
         abs_errs, unmasked_edge, None),
        ("project_lse bf16",
         lambda: project_lse(h, head_b, None, compute_dtype=bf),
         lambda: project_lse_ref(h, head_b, compute_dtype=bf),
         abs_errs,
         lambda: project_lse_ref(second_half_fault(h, 64), head_b, compute_dtype=bf), None),
        ("lstm_cell_step bf16",
         lambda: lstm_cell_step(x, h, c, Wc, bc, 1.0, compute_dtype=bf,
                                c_out_dtype=bf),
         cell_plain, cell_err, lambda: cell_plain(swap_jf(Wc), swap_jf(bc)),
         lambda: torch.lstm_cell(x, (h, c), w_ih, w_hh, b_ih, b_hh)),
        cand_case("cand_dot bf16", h3, cols),
        cand_case("cand_dot fp32", h3.float(), cols.float()),
        cand_case("cand_dot bf16 B20", h3_20, cols),
        cand_case("cand_dot fp32 B20", h3_20.float(), cols.float()),
        fwd_case("ce_fwd bf16", h_ce, W_ce, y_ce, wt_ce),
        fwd_case(f"ce_fwd bf16 D{DS_D}", h_ds, W_ds, y_ds, wt_ds),
    ] + bwd_cases + scan_cases, yardsticks


def config5():
    """BASELINE config 5 on one card (scripts/bench_all.py:244-252): 2
    layers, V = 100,000, the D-softmax prefix head; no mesh."""
    from jlm_tpu_torch.config import Config, default_dsoftmax_blocks

    cfg = Config(vocab_size=V5, num_layers=2, hidden_size=H, embed_size=E,
                 head="dsoftmax", dsoftmax=default_dsoftmax_blocks(V5, H),
                 beam_width=10, n_best_max=1, seed=0)
    check(tuple(zip(cfg.dsoftmax.block_sizes, cfg.dsoftmax.block_dims)) == BLOCKS5,
          f"config 5's blocks {cfg.dsoftmax}")
    return cfg


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32's 10-bit mantissa (to nearest, ties to even)."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF).view(torch.float32)


def head_mode_cases(dev, rng):
    """The head kernel's other modes and the fp32 cell, as kernel_cases'
    cases: the config-5 D-softmax head (int8-MXU and bf16 at the serving
    rows, fp32 at the fp32 parity run's rows), the int8 dequant head at
    50k (bf16 at the serving rows, fp32 at the fp32 rows), the fp32 cell,
    and the per-slice activation scale: rows whose largest |h| (8x the
    rest) lies in a column outside the 256- and 128-wide prefixes, checked
    against a plain version that takes the int8 row scale over all H
    (block 0's weights are zeroed in that column, so that its logits do
    not swamp the lse).  The fp32 and dequant heads have weights of scale
    ``PEAKED``; their wrong calls are the plain fp32 version on operands
    rounded to TF32, and, for bf16 dequant, the exact int8 product
    rescaled after it."""
    from jlm_tpu_torch.ops.quant import quantize_weight
    from jlm_tpu_torch.ops.lstm_cell import lstm_cell_ref, lstm_cell_step
    from jlm_tpu_torch.ops.project import (
        merge_ms, project_lse, project_lse_ref, quantize_rows)

    cfg = config5()
    bf = torch.bfloat16

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev).to(dtype)

    def with_wt(blk, wt):
        return {**blk, "WT": wt.t().contiguous()}

    ws = [rng.normal(0, 0.05, (d, n)).astype(np.float32) for n, d in BLOCKS5]
    bs = [t(rng.normal(0, 0.1, n)) for n, _ in BLOCKS5]
    quant = [quantize_weight(w, axis=0) for w in ws]
    head_q = {"blocks": [with_wt({"W": {"q": torch.from_numpy(q["q"]).to(dev),
                                        "scale": t(q["scale"])}, "b": b},
                                 torch.from_numpy(q["q"]).to(dev))
                         for q, b in zip(quant, bs)]}
    head_b = {"blocks": [with_wt({"W": t(w, bf), "b": b}, t(w, bf)) for w, b in zip(ws, bs)]}
    wf = [t(rng.normal(0, PEAKED, (d, n))) for n, d in BLOCKS5]
    head_f = {"blocks": [with_wt({"W": w, "b": b}, w) for w, b in zip(wf, bs)]}
    h = t(rng.uniform(-1, 1, (R, H)), bf)
    h32 = t(rng.uniform(-1, 1, (R32, H)))

    w = rng.normal(0, PEAKED, (H, V)).astype(np.float32)
    q = quantize_weight(w, axis=0)
    Wq = torch.from_numpy(q["q"]).to(dev)
    head_d = {"W": {"q": Wq, "scale": t(q["scale"])}, "b": t(rng.normal(0, 0.1, V)),
              "WT": Wq.t().contiguous()}

    # per-slice scale: column 300 lies in block 0's 512 only
    h_out = t(rng.uniform(-3, 3, (R, H)), bf)
    h_out[:, 300] = 24.0
    q0 = head_q["blocks"][0]["W"]["q"].clone()
    q0[300] = 0
    head_s = {"blocks": [with_wt({**head_q["blocks"][0], "W": {**head_q["blocks"][0]["W"],
                                                               "q": q0}}, q0)]
              + head_q["blocks"][1:]}

    def tf32_plain(hh, head):
        """The plain fp32 version with its operands (h and the weights,
        dequantized first) rounded to TF32."""
        def rounded(blk):
            W = blk["W"]
            W = W["q"].float() * W["scale"][None, :] if isinstance(W, dict) else W
            return {"W": tf32(W), "b": blk["b"]}

        head_r = ({"blocks": [rounded(blk) for blk in head["blocks"]]}
                  if "blocks" in head else rounded(head))
        return project_lse_ref(tf32(hh), head_r, cfg, compute_dtype=torch.float32)

    def last_chunk_dropped(hh, head):
        """The lse without the last K chunk of 16 (the fp32 kernel's
        chunk): rows [d - 16, d) of each block's weights zeroed."""
        def cut(blk):
            W = blk["W"]
            if isinstance(W, dict):
                q = W["q"].clone()
                q[-16:] = 0
                return {"W": {"q": q, "scale": W["scale"]}, "b": blk["b"]}
            W = W.clone()
            W[-16:] = 0
            return {"W": W, "b": blk["b"]}

        head_c = {"blocks": [cut(blk) for blk in head["blocks"]]} if "blocks" in head else cut(head)
        return project_lse_ref(hh, head_c, cfg, compute_dtype=torch.float32)

    def f32_traps(hh, head):
        return {"operands rounded to TF32": lambda: tf32_plain(hh, head),
                "the lse without the last K chunk of 16": lambda: last_chunk_dropped(hh, head)}

    def rescaled_after():
        """The dequant done wrong: the exact product with int8 weights,
        rescaled by the column scale after it."""
        acc = h.float() @ head_d["W"]["q"].float()
        return torch.logsumexp(acc * head_d["W"]["scale"][None, :] + head_d["b"][None, :],
                               dim=1, keepdim=True)

    def global_scale():
        """The wrong rule: one int8 row scale over all of h."""
        _, s_all = quantize_rows(h_out)
        ms, ss = [], []
        for blk, (_, d) in zip(head_s["blocks"], BLOCKS5):
            acc = torch.round(h_out[:, :d].float() / s_all) @ blk["W"]["q"].float()
            logits = acc * s_all * blk["W"]["scale"][None, :] + blk["b"][None, :]
            ms.append(logits.amax(dim=1, keepdim=True))
            ss.append(torch.exp(logits - ms[-1]).sum(dim=1, keepdim=True))
        m, s = merge_ms(ms, ss)
        return m + torch.log(s)

    xc = t(rng.normal(0, 0.3, (R32, E)))
    hc = t(rng.uniform(-1, 1, (R32, H)))
    cc = t(rng.normal(0, 1.0, (R32, H)))
    Wc = t(rng.normal(0, 0.05, (E + H, 4 * H)))
    bc = t(rng.normal(0, 0.1, 4 * H))
    w_ih, w_hh, b_ih = torch_gates(Wc, bc)

    def lse_case(name, hh, head, cd, mxu, wrong=None):
        return (name,
                lambda: project_lse(hh, head, cfg, compute_dtype=cd, int8_mxu=mxu),
                lambda: project_lse_ref(hh, head, cfg, compute_dtype=cd, int8_mxu=mxu),
                abs_errs, wrong, None)

    return [
        lse_case("project_lse dsoftmax int8", h, head_q, bf, True),
        lse_case("project_lse dsoftmax bf16", h, head_b, bf, False),
        lse_case("project_lse dequant bf16", h, head_d, bf, False, rescaled_after),
        lse_case("project_lse fp32", h32, head_f, torch.float32, False,
                 f32_traps(h32, head_f)),
        lse_case("project_lse dequant fp32", h32, head_d, torch.float32, False,
                 f32_traps(h32, head_d)),
        lse_case("project_lse dsoftmax int8 slice scale", h_out, head_s, bf, True,
                 global_scale),
        ("lstm_cell_step fp32",
         lambda: lstm_cell_step(xc, hc, cc, Wc, bc, 1.0),
         lambda: lstm_cell_ref(xc, hc, cc, Wc, bc, 1.0), abs_errs,
         lambda: lstm_cell_ref(tf32(xc), tf32(hc), cc, tf32(Wc), bc, 1.0),
         lambda: torch.lstm_cell(xc, (hc, cc), w_ih, w_hh, b_ih, torch.zeros_like(b_ih))),
    ]


# case name -> the split pair (lstm_cell_step + cand_dot) its fused kernel
# replaces, timed beside it in phase 2
SPLIT_PAIRS = {}


def cand_ids(rng, sizes, n=C_CAND):
    """``n`` candidate ids over a vocabulary of blocks ``sizes``, spread
    over every block, with each block's first and last id among them."""
    edges = np.cumsum((0,) + tuple(sizes))
    ids = np.concatenate([[lo, hi - 1] for lo, hi in zip(edges[:-1], edges[1:])])
    return np.concatenate([ids, rng.integers(0, edges[-1], n - len(ids))]).astype(np.int32)


def port_cases(dev, rng):
    """The kernels that finish the table, as kernel_cases' cases: the fp32
    fused CE at the training shape (``precision="highest"``), candidate
    extraction at ``scripts/bench_kernels.py``'s shape (R = 800, C = 65) in
    fp32, dequant fp32, dequant bf16 and int8-MXU on the 50k head and in
    int8-MXU and fp32 on config 5's D-softmax head, and the fused cell +
    candidate frame kernel in bf16 at the serving frame and in fp32 at the
    fp32 parity run's frame.  The CE and candidate
    weights have scale ``PEAKED``.  Wrong calls: the plain version on
    operands rounded to TF32 (fp32 modes), a p-term off by ``P_SHIFT``
    (CE backward, the p-term alone), and every candidate read from its
    neighbouring column, and the frame's dots on h' before its bf16
    rounding.  Library calls (yardsticks only):
    ``cross_entropy`` over ``h @ W + b`` for ce_fwd, and ``torch.lstm_cell``
    followed by ``torch.baddbmm`` for the frame kernel (both dtypes)."""
    from jlm_tpu_torch.ops.cand_dot import cand_dot
    from jlm_tpu_torch.ops.frame_step import cell_cand_ref, cell_cand_step
    from jlm_tpu_torch.ops.lstm_cell import cell_weight_tiles, lstm_cell_ref, lstm_cell_step
    from jlm_tpu_torch.ops.project import (
        project_candidates, project_candidates_dsoftmax, project_candidates_dsoftmax_ref,
        project_candidates_ref)
    from jlm_tpu_torch.ops.quant import quantize_weight
    from jlm_tpu_torch.ops.softmax_ce import (
        ce_bwd_dh, ce_bwd_dh_ref, ce_bwd_dw, ce_bwd_dw_ref, ce_fwd_raw, ce_fwd_raw_ref)

    f32, bf = torch.float32, torch.bfloat16

    def t(a, dtype=f32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev).to(dtype)

    # fp32 fused CE at the training shape
    h_ce = t(rng.uniform(-1, 1, (N_CE, H)))
    W_ce = t(rng.normal(0, PEAKED, (H, V)))
    b_ce = t(rng.normal(0, 0.1, V))
    y_ce = torch.from_numpy(rng.integers(0, V, N_CE)).to(dev)
    m, s = ce_fwd_raw_ref(h_ce, W_ce, b_ce, y_ce, f32)[:2]
    lse_ce = m + torch.log(s)
    ga = torch.full((N_CE,), 1.0 / N_CE, device=dev)
    ga_p = t(rng.uniform(0.5, 1.5, N_CE) / N_CE)
    h_r, W_r = tf32(h_ce), tf32(W_ce)

    def fwd_wrong(hh, W, yy):
        """The fp32 forward's wrong versions: TF32 operands, and the logits
        without their last K chunk of 16 (the kernel's chunk loop)."""
        return {"operands rounded to TF32": lambda: ce_fwd_raw_ref(tf32(hh), tf32(W), b_ce, yy,
                                                                   f32),
                "the logits without their last K chunk of 16":
                lambda: ce_fwd_raw_ref(hh[:, :-16], W[:-16], b_ce, yy, f32)}

    # config 5's 50,000 x 128 block: a D-softmax block's width, a third of the
    # targets owned by another block; its own draws, so the later cases' do
    # not move
    rng_ds = np.random.default_rng(DS_D)
    h_ds = t(rng_ds.uniform(-1, 1, (N_CE, DS_D)))
    W_ds = t(rng_ds.normal(0, PEAKED, (DS_D, V)))
    y_ds = y_ce.clone()
    y_ds[::3] = -1
    cases = [("ce_fwd fp32",
              lambda: ce_fwd_raw(h_ce, W_ce, b_ce, y_ce, f32),
              lambda: ce_fwd_raw_ref(h_ce, W_ce, b_ce, y_ce, f32), ce_fwd_err,
              fwd_wrong(h_ce, W_ce, y_ce),
              lambda: torch.nn.functional.cross_entropy(torch.addmm(b_ce, h_ce, W_ce), y_ce,
                                                        reduction="none")),
             (f"ce_fwd fp32 D{DS_D}",
              lambda: ce_fwd_raw(h_ds, W_ds, b_ce, y_ds, f32),
              lambda: ce_fwd_raw_ref(h_ds, W_ds, b_ce, y_ds, f32), ce_fwd_err,
              fwd_wrong(h_ds, W_ds, y_ds), None)]
    for name, kernel, ref in (("ce_bwd_dh", ce_bwd_dh, ce_bwd_dh_ref),
                              ("ce_bwd_dw", ce_bwd_dw, ce_bwd_dw_ref)):
        args = (h_ce, W_ce, b_ce, y_ce, lse_ce, ga, -ga, f32)
        cases.append((f"{name} fp32", lambda k=kernel, a=args: k(*a),
                      lambda r=ref, a=args: r(*a), bwd_err,
                      {"operands rounded to TF32":
                       lambda r=ref: r(h_r, W_r, b_ce, y_ce, lse_ce, ga, -ga, f32),
                       **ce_bwd_traps(name, args)}, None))
        args = (h_ce, W_ce, b_ce, y_ce, lse_ce, ga_p, torch.zeros_like(ga_p), f32)
        wrong = (h_ce, W_ce, b_ce, y_ce, lse_ce + P_SHIFT, ga_p, torch.zeros_like(ga_p), f32)
        cases.append((f"{name} fp32 p-term", lambda k=kernel, a=args: k(*a),
                      lambda r=ref, a=args: r(*a), bwd_err, lambda r=ref, a=wrong: r(*a),
                      None))

    # candidate extraction: bench_kernels.py's R, C; the 50k head and config 5's
    cfg = config5()
    h_c = t(rng.normal(0, 0.3, (R_CAND, H)))
    h_cb = h_c.to(bf)
    w = rng.normal(0, PEAKED, (H, V)).astype(np.float32)
    q = quantize_weight(w, axis=0)
    Wf, Wq, sq = t(w), torch.from_numpy(q["q"]).to(dev), t(q["scale"])
    b_c = t(rng.normal(0, 0.1, V))
    ids = torch.from_numpy(cand_ids(rng, (V,))).to(dev)
    ws = [rng.normal(0, PEAKED, (d, n)).astype(np.float32) for n, d in BLOCKS5]
    b5 = [t(rng.normal(0, 0.1, n)) for n, _ in BLOCKS5]
    blocks_f = [{"W": t(w_k), "b": b_k} for w_k, b_k in zip(ws, b5)]
    blocks_q = []
    for w_k, b_k in zip(ws, b5):
        q_k = quantize_weight(w_k, axis=0)
        blocks_q.append({"W": {"q": torch.from_numpy(q_k["q"]).to(dev), "scale": t(q_k["scale"])},
                         "b": b_k})
    ids5 = torch.from_numpy(cand_ids(rng, [n for n, _ in BLOCKS5])).to(dev)

    def neighbour(i, V_):
        return torch.where(i >= 0, (i + 1) % V_, i)

    def full(name, hh, W, scale, cd, mxu):
        def run(fn, i):
            return fn(hh, W, scale, b_c, i, compute_dtype=cd, int8_mxu=mxu)

        wrong = {"the neighbouring column": lambda: run(project_candidates_ref, neighbour(ids, V))}
        if cd == f32:  # int8 weights: the dequantized weights, rounded
            Wd = W if scale is None else W.float() * scale[None, :]
            wrong["operands rounded to TF32"] = lambda: project_candidates_ref(
                tf32(hh), tf32(Wd), None, b_c, ids, compute_dtype=f32)
        return (name, lambda: run(project_candidates, ids), lambda: run(project_candidates_ref, ids),
                abs_errs, wrong, None)

    def dsoftmax(name, hh, blocks, cd, mxu):
        def run(fn, i, hh=hh, blocks=blocks):
            return fn(hh, blocks, cfg, i, compute_dtype=cd, int8_mxu=mxu)

        wrong = {"the neighbouring column":
                 lambda: run(project_candidates_dsoftmax_ref, neighbour(ids5, V5))}
        if cd == f32:
            wrong["operands rounded to TF32"] = lambda: run(
                project_candidates_dsoftmax_ref, ids5, tf32(hh),
                [{"W": tf32(blk["W"]), "b": blk["b"]} for blk in blocks])
        return (name, lambda: run(project_candidates_dsoftmax, ids5),
                lambda: run(project_candidates_dsoftmax_ref, ids5), abs_errs, wrong, None)

    cases += [
        full("project_candidates fp32", h_c, Wf, None, f32, False),
        full("project_candidates dequant fp32", h_c, Wq, sq, f32, False),
        full("project_candidates dequant bf16", h_cb, Wq, sq, bf, False),
        full("project_candidates int8", h_cb, Wq, sq, bf, True),
        dsoftmax("project_candidates dsoftmax int8", h_cb, blocks_q, bf, True),
        dsoftmax("project_candidates dsoftmax fp32", h_c, blocks_f, f32, False),
    ]

    # the fused cell + candidate frame kernel at the serving frame
    x = t(rng.normal(0, 0.3, (R, E)), bf)
    hf = t(rng.uniform(-1, 1, (R, H)), bf)
    c = t(rng.normal(0, 1.0, (R, H)), bf)
    Wc = t(rng.normal(0, 0.05, (E + H, 4 * H)), bf)
    bc = t(rng.normal(0, 0.1, 4 * H))
    cols = t(rng.normal(0, 0.05, (S, C1, H)), bf)
    cbias = t(rng.normal(0, 0.1, (S, C1)))
    w_ih, w_hh, b_ih = torch_gates(Wc, bc)
    b_ih, b_hh = b_ih.to(bf), torch.zeros_like(b_ih, dtype=bf)
    cbias_b, cols_t = cbias.to(bf)[:, None, :], cols.transpose(1, 2)

    frame_err = frame_err_of(cols)
    def library_frame():
        c_l, h_l = torch.lstm_cell(x, (hf, c), w_ih, w_hh, b_ih, b_hh)
        return c_l, torch.baddbmm(cbias_b, h_l.reshape(S, B, H), cols_t)

    def unrounded_dots():
        """The dots on h' before its rounding to bf16."""
        c_n, h_n = lstm_cell_ref(x, hf, c, Wc, bc, 1.0)
        return c_n, h_n.to(bf), (torch.einsum("sbh,sch->sbc", h_n.reshape(S, B, H),
                                              cols.float()) + cbias[:, None, :])

    def split_pair():
        c_n, h_n = lstm_cell_step(x, hf, c, Wc, bc, 1.0, compute_dtype=bf, c_out_dtype=bf)
        return c_n, cand_dot(h_n.reshape(S, B, H), cols, cbias)

    cell_weight_tiles(Wc, E, H)  # kept on Wc, as build_decode_head makes it
    SPLIT_PAIRS["cell_cand_step bf16"] = split_pair
    cases.append(("cell_cand_step bf16",
                  lambda: cell_cand_step(x, hf, c, Wc, bc, cols, cbias, B, 1.0, compute_dtype=bf),
                  lambda: cell_cand_ref(x, hf, c, Wc, bc, cols, cbias, B, 1.0, compute_dtype=bf),
                  frame_err, {"the dots on h' before its bf16 rounding": unrounded_dots},
                  library_frame))

    # the same kernel in fp32 at the fp32 parity run's frame (greedy, beam pad 8)
    B32 = R32 // S32
    x32, h32 = t(rng.normal(0, 0.3, (R32, E))), t(rng.uniform(-1, 1, (R32, H)))
    c32, W32 = t(rng.normal(0, 1.0, (R32, H))), t(rng.normal(0, 0.05, (E + H, 4 * H)))
    b32 = t(rng.normal(0, 0.1, 4 * H))
    cols32, cbias32 = t(rng.normal(0, 0.05, (S32, C1, H))), t(rng.normal(0, 0.1, (S32, C1)))
    w_ih32, w_hh32, b_ih32 = torch_gates(W32, b32)

    def library32():
        c_l, h_l = torch.lstm_cell(x32, (h32, c32), w_ih32, w_hh32, b_ih32,
                                   torch.zeros_like(b_ih32))
        return c_l, torch.baddbmm(cbias32[:, None, :], h_l.reshape(S32, B32, H),
                                  cols32.transpose(1, 2))

    def last_group_dropped():
        """The dots without the last unit group's share: h' units [H - 32,
        H) zeroed in the dots only."""
        c_n, h_n = lstm_cell_ref(x32, h32, c32, W32, b32, 1.0)
        h_d = h_n.clone()
        h_d[:, H - 32:] = 0
        return c_n, h_n, (torch.einsum("sbh,sch->sbc", h_d.reshape(S32, B32, H), cols32)
                          + cbias32[:, None, :])

    def split_pair32():
        c_n, h_n = lstm_cell_step(x32, h32, c32, W32, b32, 1.0)
        return c_n, cand_dot(h_n.reshape(S32, B32, H), cols32, cbias32)

    SPLIT_PAIRS["cell_cand_step fp32"] = split_pair32
    cases.append((
        "cell_cand_step fp32",
        lambda: cell_cand_step(x32, h32, c32, W32, b32, cols32, cbias32, B32, 1.0),
        lambda: cell_cand_ref(x32, h32, c32, W32, b32, cols32, cbias32, B32, 1.0),
        abs_errs,
        {"operands rounded to TF32": lambda: cell_cand_ref(
            tf32(x32), tf32(h32), c32, tf32(W32), b32, tf32(cols32), cbias32, B32, 1.0),
         "the dots without the last unit group's share": last_group_dropped},
        library32))
    return cases


def wide_cases(dev, rng):
    """The widths past 512 (H = E = HW = 1,024), as kernel_cases' cases: the
    bf16 and dequant-bf16 heads on a 1,024-wide slice at the serving rows
    (50k), the fused CE at N = 1,024, D = 1,024, V = 50,000 in bf16 and fp32
    (the mean loss's cotangent), and the scan at B = T = 32 in fp32 and
    bf16, forward and backward.  Wrong calls: the rows of each block's
    second warpgroup taken from the first's (bf16 head); the exact int8 product rescaled after it (dequant, weights of
    scale PEAKED); the logits of the first 512 of K alone (bf16 CE
    forward); operands rounded to TF32 (fp32 CE, weights of scale PEAKED);
    a p-term off by P_SHIFT (bf16 CE backward); a forget bias off by
    F_SHIFT (scan)."""
    from jlm_tpu_torch.ops.lstm_scan import (
        lstm_scan_bwd, lstm_scan_bwd_ref, lstm_scan_fwd, lstm_scan_ref)
    from jlm_tpu_torch.ops.project import project_lse, project_lse_ref
    from jlm_tpu_torch.ops.quant import quantize_weight
    from jlm_tpu_torch.ops.softmax_ce import (
        cast_wt, ce_bwd_dh, ce_bwd_dh_ref, ce_bwd_dw, ce_bwd_dw_ref, ce_fwd_raw, ce_fwd_raw_ref)

    f32, bf = torch.float32, torch.bfloat16

    def t(a, dtype=f32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev).to(dtype)

    # the heads at the serving rows
    h = t(rng.uniform(-1, 1, (R, HW)), bf)
    bias = t(rng.normal(0, 0.1, V))
    Wb = t(rng.normal(0, 0.05, (HW, V)), bf)
    head_b = {"W": Wb, "b": bias, "WT": Wb.t().contiguous()}
    q = quantize_weight(rng.normal(0, PEAKED, (HW, V)).astype(np.float32), axis=0)
    Wq, sq = torch.from_numpy(q["q"]).to(dev), t(q["scale"])
    head_d = {"W": {"q": Wq, "scale": sq}, "b": bias, "WT": Wq.t().contiguous()}

    def rescaled_after():
        acc = h.float() @ Wq.float()
        return torch.logsumexp(acc * sq[None, :] + bias[None, :], dim=1, keepdim=True)

    def head_case(name, head, wrong):
        return (name, lambda: project_lse(h, head, None, compute_dtype=bf),
                lambda: project_lse_ref(h, head, compute_dtype=bf), abs_errs, wrong, None)

    cases = [
        head_case("project_lse bf16 D1024", head_b,
                  lambda: project_lse_ref(second_half_fault(h, 64), head_b, compute_dtype=bf)),
        head_case("project_lse dequant bf16 D1024", head_d, rescaled_after),
    ]

    # the fused CE at the training rows
    hc = t(rng.uniform(-1, 1, (N_CE, HW)))
    yc = torch.from_numpy(rng.integers(0, V, N_CE)).to(dev)
    bc = t(rng.normal(0, 0.1, V))
    ga = torch.full((N_CE,), 1.0 / N_CE, device=dev)
    for cd, scale in ((bf, 0.05), (f32, PEAKED)):
        Wc = t(rng.normal(0, scale, (HW, V)))
        m, s_ = ce_fwd_raw_ref(hc, Wc, bc, yc, cd)[:2]
        lse = m + torch.log(s_)
        name = "bf16" if cd == bf else "fp32"
        if cd == bf:
            wrong_fwd = {"the logits of the first 512 of K alone":
                         lambda Wc=Wc: ce_fwd_raw_ref(hc[:, :512], Wc[:512], bc, yc, bf)}
        else:
            wrong_fwd = {"operands rounded to TF32":
                         lambda Wc=Wc: ce_fwd_raw_ref(tf32(hc), tf32(Wc), bc, yc, f32)}
        wt = cast_wt(Wc, HW) if cd == bf else None  # the step's W^T, made outside the call
        cases.append((f"ce_fwd {name} D1024",
                      lambda Wc=Wc, cd=cd, wt=wt: ce_fwd_raw(hc, Wc, bc, yc, cd, wt=wt),
                      lambda Wc=Wc, cd=cd: ce_fwd_raw_ref(hc, Wc, bc, yc, cd), ce_fwd_err,
                      wrong_fwd, None))
        for kname, kernel, ref in (("ce_bwd_dh", ce_bwd_dh, ce_bwd_dh_ref),
                                   ("ce_bwd_dw", ce_bwd_dw, ce_bwd_dw_ref)):
            args = (hc, Wc, bc, yc, lse, ga, -ga, cd)
            if cd == bf:
                wrong = {f"a p-term {1 - math.exp(-P_SHIFT):.0%} low":
                         lambda r=ref, Wc=Wc, lse=lse:
                         r(hc, Wc, bc, yc, lse + P_SHIFT, ga, -ga, bf),
                         **ce_bwd_traps(kname, args)}
            else:
                wrong = {"operands rounded to TF32": lambda r=ref, Wc=Wc, lse=lse:
                         r(tf32(hc), tf32(Wc), bc, yc, lse, ga, -ga, f32),
                         f"a p-term {1 - math.exp(-P_SHIFT):.0%} low":
                         lambda r=ref, Wc=Wc, lse=lse:
                         r(hc, Wc, bc, yc, lse + P_SHIFT, ga, -ga, f32),
                         **ce_bwd_traps(kname, args)}
            cases.append((f"{kname} {name} D1024", lambda k=kernel, a=args: k(*a),
                          lambda r=ref, a=args: r(*a), bwd_err, wrong, None))

    # the scan at the training batch and window
    xs = t(rng.normal(0, 0.3, (TB, TT, HW)))
    Ws = t(rng.normal(0, 0.05, (2 * HW, 4 * HW)))
    bs = t(rng.normal(0, 0.1, 4 * HW))
    c0, h0 = t(rng.normal(0, 0.3, (TB, HW))), t(rng.normal(0, 0.3, (TB, HW)))
    scan_in = (xs, Ws, bs, c0, h0)
    grads = (t(rng.normal(0, 1, (TB, TT, HW))), t(rng.normal(0, 1, (TB, HW))),
             t(rng.normal(0, 1, (TB, HW))))
    def cudnn(cd):
        """cuDNN's LSTM (``torch.nn.LSTM``) on the same weights in ``cd``
        (TF32 off): its forward, and its backward alone on a retained
        graph, as the yardsticks of the scan kernels."""
        lstm = torch.nn.LSTM(HW, HW, batch_first=True).to(dev)
        with torch.no_grad():
            for param, value in zip((lstm.weight_ih_l0, lstm.weight_hh_l0, lstm.bias_ih_l0),
                                    torch_gates(Ws, bs)):
                param.copy_(value)
            lstm.bias_hh_l0.zero_()
        lstm = lstm.to(cd)
        leaves = ([a.to(cd).clone().requires_grad_(True) for a in (xs, h0, c0)]
                  + list(lstm.parameters()))

        def fwd():
            with torch.no_grad():
                return lstm(leaves[0], (leaves[1][None], leaves[2][None]))

        hs_l, (h_T, c_T) = lstm(leaves[0], (leaves[1][None], leaves[2][None]))
        d_out = (grads[0].to(cd), grads[2][None].to(cd), grads[1][None].to(cd))
        return fwd, lambda: torch.autograd.grad((hs_l, h_T, c_T), leaves, d_out,
                                                retain_graph=True)

    for cd in (f32, bf):
        name = "bf16" if cd == bf else "fp32"
        hs, cs = lstm_scan_ref(*scan_in, 1.0, cd)[:2]
        saved = scan_in + (hs, cs) + grads
        cudnn_fwd, cudnn_bwd = cudnn(cd)
        cases += [
            (f"lstm_scan_fwd {name} H1024", lambda cd=cd: lstm_scan_fwd(*scan_in, 1.0, cd),
             lambda cd=cd: lstm_scan_ref(*scan_in, 1.0, cd), abs_errs,
             {f"a forget bias off by {F_SHIFT:g}":
              lambda cd=cd: lstm_scan_ref(*scan_in, 1.0 + F_SHIFT, cd)}, cudnn_fwd),
            (f"lstm_scan_bwd {name} H1024", lambda a=saved, cd=cd: lstm_scan_bwd(*a, 1.0, cd),
             lambda a=saved, cd=cd: lstm_scan_bwd_ref(*a, 1.0, cd),
             scan_bwd_err if cd == f32 else bwd_err,
             {f"a forget gate sigmoid(f + {F_SHIFT:g}) in the backward":
              lambda a=saved, cd=cd: lstm_scan_bwd_ref(*a, 1.0 + F_SHIFT, cd)}, cudnn_bwd),
        ] + scan_fwd_stage_cases(f"{name} H1024", scan_in, cd)
        cases += scan_stage_cases(f"{name} H1024", scan_in, hs, cs, grads, cd)
    # the forward at a batch whose carries once filled a block's shared memory
    xb = t(rng.normal(0, 0.3, (16384, 1, 16)))
    big = (xb, t(rng.normal(0, 0.05, (16 + HW, 4 * HW))), t(rng.normal(0, 0.1, 4 * HW)),
           t(rng.normal(0, 0.3, (16384, HW))), t(rng.normal(0, 0.3, (16384, HW))))
    cases.append(("lstm_scan_fwd fp32 B16384", lambda: lstm_scan_fwd(*big, 1.0),
                  lambda: lstm_scan_ref(*big, 1.0), abs_errs,
                  {f"a forget bias off by {F_SHIFT:g}":
                   lambda: lstm_scan_ref(*big, 1.0 + F_SHIFT)}, None))
    return cases


def wide_run(dev, rng, config, vocab, dev_ids):
    """The paths at H = E = HW = 1,024 through their entry points, each
    counter set to 0 just before: WIDE_STEPS training steps with
    ``--pallas-scan --fused-ce`` (the scan kernels in fp32, the CE kernels
    in bf16) against the same steps through the loop path (plain cell steps,
    the same CE kernels): step-1 loss and last loss within TRAIN_BOUNDS,
    every counter of the scan run above 0; then the fp32 fused CE through
    autograd (``precision="highest"``, vs the plain fp32 route within
    FP32_CE_BOUNDS), the bf16 scan through autograd, and one call of the
    bf16 and dequant-bf16 heads on a 1,024-wide slice (finite, of shape
    [R, 1]).  Returns the launches by kernels-line name."""
    from jlm_tpu_torch.models.heads import full_softmax_loss
    from jlm_tpu_torch.models.params import init_params
    from jlm_tpu_torch.ops import lstm_scan as ls
    from jlm_tpu_torch.ops import softmax_ce as ce
    from jlm_tpu_torch.ops.project import project_lse
    from jlm_tpu_torch.ops.quant import quantize_weight

    wcfg = config.replace(hidden_size=HW, embed_size=HW, batch_size=TB, num_steps=TT,
                          fused_ce=True)
    params = init_params(wcfg)
    train_ids = training_corpus(vocab)[0][:N_CE * WIDE_STEPS + 1]
    _, loss_l, ms_l, launches_l, _ = training_run(dev, wcfg, params, train_ids, dev_ids,
                                                  f"H = E = {HW}, loop path")
    _, loss_s, ms_s, launches_s, _ = training_run(
        dev, wcfg.replace(use_pallas_scan=True), params, train_ids, dev_ids,
        f"H = E = {HW}, --pallas-scan")
    step1, last = abs(loss_s[0] - loss_l[0]), abs(loss_s[-1] / loss_l[-1] - 1)
    log(f"H = E = {HW} training, scan vs loop path: step 1 loss diff {step1:.3e} (bound "
        f"{TRAIN_BOUNDS['step 1 loss']:g}), last loss rel diff {last:.3e} (bound "
        f"{TRAIN_BOUNDS['last loss']:g}); {ms_l:.3f} / {ms_s:.3f} ms/step")
    check(np.isfinite(loss_s).all() and np.isfinite(loss_l).all(), "H = 1024 loss finite")
    check(step1 <= TRAIN_BOUNDS["step 1 loss"], "H = 1024 step 1 loss: scan vs loop")
    check(last <= TRAIN_BOUNDS["last loss"], "H = 1024 last loss: scan vs loop")
    want = {**dict.fromkeys(STEP_COUNTERS, WIDE_STEPS),
            **dict.fromkeys(SCAN_COUNTERS, WIDE_STEPS * wcfg.num_layers)}
    check(launches_s == want, f"H = 1024 scan run launches {launches_s}, expected {want}")
    check(launches_l == {**want, **dict.fromkeys(SCAN_COUNTERS, 0)},
          f"H = 1024 loop run launches {launches_l}")
    launches = {f"{k} D1024": launches_s[k] for k in CE_COUNTERS}
    launches.update({f"{k} H1024": launches_s[k] for k in SCAN_COUNTERS})
    del params
    torch.cuda.empty_cache()

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    counters = (ce.ce_fwd_raw, ce.ce_bwd_dh, ce.ce_bwd_dw) + scan_counters() + (project_lse,)
    for fn in counters:
        fn.launches = 0
    head = {"W": t(rng.normal(0, 0.05, (HW, V))), "b": t(rng.normal(0, 0.1, V))}
    hs = t(rng.uniform(-1, 1, (TB, TT, HW)))
    y = torch.from_numpy(rng.integers(0, V, (TB, TT))).to(dev)
    leaves = [hs, head["W"], head["b"]]
    for leaf in leaves:
        leaf.requires_grad_(True)
    def fp32_loss(c):
        loss = full_softmax_loss({"head": head}, c, hs, y, precision="highest")
        return (loss, *torch.autograd.grad(loss, leaves))

    got = fp32_loss(wcfg)
    ce_counts = {f"{k} fp32 D1024": fn.launches for k, fn in zip(CE_COUNTERS, counters[:3])}
    want_ = fp32_loss(wcfg.replace(fused_ce=False))
    loss_err, grad_err = abs(got[0].item() - want_[0].item()), rel_err(got[1:], want_[1:])
    log(f"fp32 fused CE at D = {HW}: loss diff {loss_err:.3e} (bound "
        f"{FP32_CE_BOUNDS['loss']:g}), grads rel err {grad_err:.3e} (bound "
        f"{FP32_CE_BOUNDS['grads']:g}); launches {ce_counts}")
    check(loss_err <= FP32_CE_BOUNDS["loss"] and grad_err <= FP32_CE_BOUNDS["grads"],
          f"fp32 fused CE at D = {HW}")
    launches.update(ce_counts)
    xs = t(rng.normal(0, 0.3, (TB, TT, HW)))
    scan_leaves = [a.requires_grad_(True) for a in (
        xs, t(rng.normal(0, 0.05, (2 * HW, 4 * HW))), t(rng.normal(0, 0.1, 4 * HW)),
        t(rng.normal(0, 0.3, (TB, HW))), t(rng.normal(0, 0.3, (TB, HW))))]
    outs = ls.lstm_scan(*scan_leaves, 1.0, torch.bfloat16)
    scan_grads = torch.autograd.grad(sum(o.sum() for o in outs), scan_leaves)
    check(all(bool(torch.isfinite(g).all()) for g in scan_grads), "bf16 scan grads finite")
    launches.update({f"{k} bf16 H1024": fn.launches
                     for k, fn in zip(SCAN_COUNTERS, counters[3:3 + len(SCAN_COUNTERS)])})
    del scan_leaves, outs, scan_grads
    bf = torch.bfloat16
    h = t(rng.uniform(-1, 1, (R, HW))).to(bf)
    q = quantize_weight(rng.normal(0, 0.05, (HW, V)).astype(np.float32), axis=0)
    head_q = {"W": {"q": torch.from_numpy(q["q"]).to(dev), "scale": t(q["scale"])},
              "b": head["b"].detach()}
    for name, hd in (("project_lse bf16 D1024", {"W": head["W"].detach().to(bf),
                                                  "b": head["b"].detach()}),
                     ("project_lse dequant bf16 D1024", head_q)):
        project_lse.launches = 0
        lse = project_lse(h, hd, None, compute_dtype=bf)
        check(lse.shape == (R, 1) and bool(torch.isfinite(lse).all()), f"{name}: finite [R, 1]")
        launches[name] = project_lse.launches
    log(f"H = {HW} paths' launches: {launches}")
    return launches


# widths the kernels take only padded: the cells at E = 30, H = 20 (off the
# fp32 kernel's 32 and the bf16 kernel's 8), the fused frame at E = 40,
# H = 24 (off the fp32 kernel's 32 / 64), and int8-MXU head slices past the
# 1,024 its resident kernel holds (python -m jlm_tpu_torch.train
# --hidden-size 2048 checkpoints served int8)
ODD_CELL, ODD_FRAME, INT8_WIDE = (30, 20), (40, 24), (1536, 2048)


def odd_width_cases(dev, rng):
    """The width repairs, as kernel_cases' cases: the int8-MXU head at
    INT8_WIDE slices (R = 20,480, V = 50,000; wrong: the slice's K past
    1,024 dropped, a streamed kernel stopping at the resident width), the
    bf16 cell at the serving rows and the fp32 cell at the fp32 parity
    run's rows at ODD_CELL, and the fused frame at ODD_FRAME in bf16 (the
    serving frame) and fp32 (the parity run's frame); the wrong version
    pads W and b at their ends instead of per gate
    (``gates_padded_at_the_end``): to the kernel's multiple for the cells,
    to the 64 units of a gate tile for the frames.  Library calls as for the 512-wide
    cases."""
    from jlm_tpu_torch.ops.frame_step import cell_cand_ref, cell_cand_step
    from jlm_tpu_torch.ops.lstm_cell import lstm_cell_ref, lstm_cell_step
    from jlm_tpu_torch.ops.project import project_lse, project_lse_ref, quantize_rows
    from jlm_tpu_torch.ops.quant import quantize_weight

    f32, bf = torch.float32, torch.bfloat16

    def t(a, dtype=f32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev).to(dtype)

    cases = []
    bias = t(rng.normal(0, 0.1, V))
    for d in INT8_WIDE:
        h = t(rng.uniform(-1, 1, (R, d)), bf)
        q = quantize_weight(rng.normal(0, 0.05, (d, V)).astype(np.float32), axis=0)
        Wq, sq = torch.from_numpy(q["q"]).to(dev), t(q["scale"])
        head = {"W": {"q": Wq, "scale": sq}, "b": bias, "WT": Wq.t().contiguous()}

        def first_1024(h=h, Wq=Wq, sq=sq):
            qh, s_ = quantize_rows(h)
            acc = qh[:, :1024].double() @ Wq[:1024].double()
            return torch.logsumexp(acc.float() * s_ * sq[None, :] + bias[None, :], dim=1,
                                   keepdim=True)

        cases.append((f"project_lse int8 D{d}",
                      lambda h=h, head=head: project_lse(h, head, None, compute_dtype=bf,
                                                         int8_mxu=True),
                      lambda h=h, head=head: project_lse_ref(h, head, compute_dtype=bf,
                                                             int8_mxu=True),
                      abs_errs, {"the slice's K past 1,024 dropped": first_1024}, None))

    Eo, Ho = ODD_CELL
    for cd, rows in ((bf, R), (f32, R32)):
        x, h, c = (t(rng.normal(0, 0.3, (rows, Eo)), cd), t(rng.uniform(-1, 1, (rows, Ho)), cd),
                   t(rng.normal(0, 1.0, (rows, Ho)), cd))
        W, b = t(rng.normal(0, 0.05, (Eo + Ho, 4 * Ho)), cd), t(rng.normal(0, 0.1, 4 * Ho))
        w_ih, w_hh, b_ih = torch_gates(W, b)
        b_ih, b_hh = b_ih.to(cd), torch.zeros_like(b_ih, dtype=cd)
        if cd == bf:
            cases.append((f"lstm_cell_step bf16 E{Eo} H{Ho}",
                          lambda x=x, h=h, c=c, W=W, b=b: lstm_cell_step(
                              x, h, c, W, b, 1.0, compute_dtype=bf, c_out_dtype=bf),
                          lambda x=x, h=h, c=c, W=W, b=b: tuple(
                              a.to(bf) for a in lstm_cell_ref(x, h, c, W, b, 1.0)),
                          cell_err,
                          {"W and b padded at their ends, not per gate":
                           lambda x=x, h=h, c=c, W=W, b=b: tuple(
                               a.to(bf) for a in gates_padded_at_the_end(x, h, c, W, b, 8))},
                          lambda x=x, h=h, c=c, w_ih=w_ih, w_hh=w_hh, b_ih=b_ih, b_hh=b_hh:
                          torch.lstm_cell(x, (h, c), w_ih, w_hh, b_ih, b_hh)))
        else:
            cases.append((f"lstm_cell_step fp32 E{Eo} H{Ho}",
                          lambda x=x, h=h, c=c, W=W, b=b: lstm_cell_step(x, h, c, W, b, 1.0),
                          lambda x=x, h=h, c=c, W=W, b=b: lstm_cell_ref(x, h, c, W, b, 1.0),
                          abs_errs,
                          {"W and b padded at their ends, not per gate":
                           lambda x=x, h=h, c=c, W=W, b=b: gates_padded_at_the_end(
                               x, h, c, W, b, 32)},
                          lambda x=x, h=h, c=c, w_ih=w_ih, w_hh=w_hh, b_ih=b_ih, b_hh=b_hh:
                          torch.lstm_cell(x, (h, c), w_ih, w_hh, b_ih, b_hh)))

    Eo, Ho = ODD_FRAME
    for cd, nsent, beam in ((bf, S, B), (f32, S32, R32 // S32)):
        rows = nsent * beam
        x, h = t(rng.normal(0, 0.3, (rows, Eo)), cd), t(rng.uniform(-1, 1, (rows, Ho)), cd)
        c = t(rng.normal(0, 1.0, (rows, Ho)), cd)
        W, b = t(rng.normal(0, 0.05, (Eo + Ho, 4 * Ho)), cd), t(rng.normal(0, 0.1, 4 * Ho))
        cols, cbias = t(rng.normal(0, 0.05, (nsent, C1, Ho)), cd), t(rng.normal(0, 0.1, (nsent, C1)))
        w_ih, w_hh, b_ih = torch_gates(W, b)
        b_ih, b_hh = b_ih.to(cd), torch.zeros_like(b_ih, dtype=cd)

        def wrong(x=x, h=h, c=c, W=W, b=b, cols=cols, cbias=cbias, cd=cd, nsent=nsent):
            c_n, h_n = gates_padded_at_the_end(x, h, c, W, b, 64)
            hc = h_n.to(cd)
            return c_n, hc, (torch.einsum("sbh,sch->sbc", hc.float().reshape(nsent, -1, Ho),
                                          cols.float()) + cbias[:, None, :])

        def library(x=x, h=h, c=c, cols=cols, cbias=cbias, w_ih=w_ih, w_hh=w_hh, b_ih=b_ih,
                    b_hh=b_hh, nsent=nsent, cd=cd):
            c_l, h_l = torch.lstm_cell(x, (h, c), w_ih, w_hh, b_ih, b_hh)
            return c_l, torch.baddbmm(cbias.to(cd)[:, None, :], h_l.reshape(nsent, -1, Ho),
                                      cols.transpose(1, 2))

        name = "bf16" if cd == bf else "fp32"
        cases.append((f"cell_cand_step {name} E{Eo} H{Ho}",
                      lambda x=x, h=h, c=c, W=W, b=b, cols=cols, cbias=cbias, beam=beam, cd=cd:
                      cell_cand_step(x, h, c, W, b, cols, cbias, beam, 1.0, compute_dtype=cd),
                      lambda x=x, h=h, c=c, W=W, b=b, cols=cols, cbias=cbias, beam=beam, cd=cd:
                      cell_cand_ref(x, h, c, W, b, cols, cbias, beam, 1.0, compute_dtype=cd),
                      frame_err_of(cols) if cd == bf else abs_errs,
                      {"W and b padded at their ends, not per gate": wrong}, library))
    return cases


def odd_width_run(dev, vocab, lexicon, kanas):
    """The width repairs through their entry points, each counter set to 0
    just before each run: ``BeamDecoder`` at E, H = ODD_CELL (50k, 1 layer)
    greedy through the fp32 kernel forward against the numpy oracle (50/50,
    scores within 1e-3),
    beam-10 in bf16 and beam-20 in bf16 (two groups of beam rows: finite
    results); the fused frame at ODD_FRAME greedy in fp32 against the
    oracle (50/50, 1e-3) and beam-10 int8 (finite); ``BeamDecoder`` at
    H = 2,048 (E = 256) with an int8-MXU head, beam-10 (finite; every
    forward one launch of each split-frame kernel); and one ``project_lse``
    call on a 1,536-wide int8 slice at the serving rows (finite, [R, 1]).
    Returns the launches by kernels-line name."""
    from jlm_tpu_torch.config import Config
    from jlm_tpu_torch.decoder.engine import (
        BeamDecoder, make_fused_frame_forward, make_kernel_forward)
    from jlm_tpu_torch.models.params import init_params
    from jlm_tpu_torch.oracle import OracleDecoder, OracleLM
    from jlm_tpu_torch.ops.cand_dot import cand_dot
    from jlm_tpu_torch.ops.frame_step import cell_cand_step
    from jlm_tpu_torch.ops.lstm_cell import lstm_cell_step
    from jlm_tpu_torch.ops.project import project_lse
    from jlm_tpu_torch.ops.quant import quantize_params, quantize_weight

    counters = (project_lse, lstm_cell_step, cand_dot, cell_cand_step)

    def counted(run):
        for fn in counters:
            fn.launches = 0
        out = run()
        return out, {fn.__name__: fn.launches for fn in counters}

    def finite(res, label):
        check(len(res) == len(kanas) and all(len(r) >= 1 and np.isfinite(r[0].score)
                                            for r in res), f"{label}: finite top-1 results")

    def greedy_parity(params_, cfg_, label, **kw):
        eng = BeamDecoder(params_, lexicon, vocab, cfg_, device=dev, **kw)
        t0 = time.perf_counter()
        res, counts = counted(lambda: eng.decode_batch(kanas))
        wall = time.perf_counter() - t0
        oracle = OracleDecoder(OracleLM(params_, cfg_), lexicon, vocab, cfg_)
        want = [oracle.decode(k)[0] for k in kanas]
        n = identical(res, want)
        worst = max(abs(r[0].score - o.score) for r, o in zip(res, want))
        log(f"{label}: parity {n}/{len(kanas)} (vs fp32 oracle), max |score - oracle| "
            f"{worst:.3e}; launches {counts}; wall {wall:.4f} s")
        check(n == len(kanas) and worst <= 1e-3, f"{label}: greedy fp32 parity")
        return counts

    def beam_run(params_, cfg_, label, **kw):
        eng = BeamDecoder(params_, lexicon, vocab, cfg_, device=dev, **kw)
        res, counts = counted(lambda: eng.decode_batch(kanas))
        finite(res, label)
        log(f"{label}: launches {counts}")
        return counts

    launches = {}
    Eo, Ho = ODD_CELL
    cfg = Config(vocab_size=V, embed_size=Eo, hidden_size=Ho, num_layers=1, beam_width=10,
                 n_best_max=1, seed=0)
    params = init_params(cfg)
    greedy = cfg.replace(beam_width=1)
    counts = greedy_parity(params, greedy, f"E = {Eo}, H = {Ho} greedy fp32 kernel forward",
                           forward_fn=make_kernel_forward(greedy, torch.float32))
    launches[f"lstm_cell_step fp32 E{Eo} H{Ho}"] = counts["lstm_cell_step"]
    counts = beam_run(params, cfg, f"E = {Eo}, H = {Ho} beam-10 bf16", precision="default")
    launches[f"lstm_cell_step E{Eo} H{Ho}"] = counts["lstm_cell_step"]
    counts = beam_run(params, cfg.replace(beam_width=20), f"E = {Eo}, H = {Ho} beam-20 bf16",
                      precision="default")
    check(counts["cand_dot"] == 2 * counts["project_lse"],
          f"beam-20: two cand_dot launches a forward, got {counts}")
    launches["cand_dot B20"] = counts["cand_dot"]

    Eo, Ho = ODD_FRAME
    cfg = cfg.replace(embed_size=Eo, hidden_size=Ho)
    params = init_params(cfg)
    greedy = cfg.replace(beam_width=1)
    counts = greedy_parity(params, greedy, f"E = {Eo}, H = {Ho} fused frame greedy fp32",
                           forward_fn=make_fused_frame_forward(greedy, torch.float32))
    launches[f"cell_cand_step fp32 E{Eo} H{Ho}"] = counts["cell_cand_step"]
    counts = beam_run(quantize_params(params), cfg,
                      f"E = {Eo}, H = {Ho} fused frame beam-10 int8",
                      forward_fn=make_fused_frame_forward(cfg))
    check(counts["cell_cand_step"] == counts["project_lse"] > 0
          and counts["lstm_cell_step"] == counts["cand_dot"] == 0,
          f"fused frame at E = {Eo}, H = {Ho}: launches {counts}")
    launches[f"cell_cand_step E{Eo} H{Ho}"] = counts["cell_cand_step"]
    del params

    wide = Config(vocab_size=V, embed_size=E, hidden_size=INT8_WIDE[1], num_layers=1,
                  beam_width=10, n_best_max=1, seed=0)
    qp = quantize_params(init_params(wide))
    counts = beam_run(qp, wide, f"H = {INT8_WIDE[1]} beam-10 int8-MXU", precision="default")
    check(counts["project_lse"] == counts["lstm_cell_step"] == counts["cand_dot"] > 0,
          f"H = {INT8_WIDE[1]}: launches {counts}")
    launches[f"project_lse D{INT8_WIDE[1]}"] = counts["project_lse"]
    del qp
    torch.cuda.empty_cache()
    rng = np.random.default_rng(8)
    d = INT8_WIDE[0]
    q = quantize_weight(rng.normal(0, 0.05, (d, V)).astype(np.float32), axis=0)
    head = {"W": {"q": torch.from_numpy(q["q"]).to(dev),
                  "scale": torch.from_numpy(q["scale"]).to(dev)},
            "b": torch.zeros(V, device=dev)}
    h = torch.from_numpy(rng.uniform(-1, 1, (R, d)).astype(np.float32)).to(dev)
    lse, counts = counted(lambda: project_lse(h.to(torch.bfloat16), head, None,
                                              compute_dtype=torch.bfloat16, int8_mxu=True))
    check(lse.shape == (R, 1) and bool(torch.isfinite(lse).all()), f"D{d} int8: finite [R, 1]")
    launches[f"project_lse D{d}"] = counts["project_lse"]
    log(f"width repairs' launches: {launches}")
    return launches


def keystroke_cases(dev, rng, rows=KEY_ROWS, rows5=KEY_ROWS5, parity=True):
    """``project_lse`` at the keystroke paths' rows (``rows``): the 50k
    int8 head, int8 x int8, bf16 activations; with ``parity`` the parity
    mode's dequant fp32 head at one keystroke's rows on weights of scale
    ``PEAKED``; and config 5's D-softmax int8 head (three blocks, one launch
    and one split plan each) at ``rows5``.  Each a partial row block;
    wrong: beam rows 8 on read from rows 0 on, the last row read as zeros,
    and for the D-softmax head the last block's partials lost."""
    from jlm_tpu_torch.ops.project import project_lse, project_lse_ref
    from jlm_tpu_torch.ops.quant import quantize_weight

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev).to(dtype)

    def head(w):
        q = quantize_weight(w, axis=0)
        Wq = torch.from_numpy(q["q"]).to(dev)
        return {"W": {"q": Wq, "scale": t(q["scale"])}, "b": bias, "WT": Wq.t().contiguous()}

    def rows8(hh):
        hw = hh.clone()
        hw[8:] = hh[:hh.shape[0] - 8]
        return hw

    def last_zero(hh):
        hw = hh.clone()
        hw[-1] = 0
        return hw

    w = rng.normal(0, 0.05, (H, V)).astype(np.float32)
    bias = t(rng.normal(0, 0.1, V))
    heads = {torch.bfloat16: head(w), torch.float32: head(w * np.float32(PEAKED / w.std()))}
    cfg5 = config5()
    head5 = {"blocks": []}
    for n, d in BLOCKS5:
        q = quantize_weight(rng.normal(0, 0.05, (d, n)).astype(np.float32), axis=0)
        Wq = torch.from_numpy(q["q"]).to(dev)
        head5["blocks"].append({"W": {"q": Wq, "scale": t(q["scale"])},
                                "b": t(rng.normal(0, 0.1, n)), "WT": Wq.t().contiguous()})
    lost5 = {"blocks": head5["blocks"][:-1]}
    cases = []
    for name, rows, cd, hd, cfg in (
            [(f"project_lse int8 {tag}", r, torch.bfloat16, heads[torch.bfloat16], None)
             for tag, r in rows.items()]
            + [("project_lse dequant fp32 R10", KEY_ROWS["R10"], torch.float32,
                heads[torch.float32], None)] * parity
            + [(f"project_lse dsoftmax int8 {tag}", r, torch.bfloat16, head5, cfg5)
               for tag, r in rows5.items()]):
        h = t(rng.uniform(-1, 1, (rows, H)), cd)
        kw = dict(compute_dtype=cd, int8_mxu=cd == torch.bfloat16)
        wrong = {"beam rows 8 on read from rows 0 on":
                 lambda h=h, hd=hd, cfg=cfg, kw=kw: project_lse_ref(rows8(h), hd, cfg, **kw),
                 "the last row read as zeros":
                 lambda h=h, hd=hd, cfg=cfg, kw=kw: project_lse_ref(last_zero(h), hd, cfg, **kw)}
        if cfg is not None:
            wrong["the last block's partials lost"] = (
                lambda h=h, cfg=cfg, kw=kw: project_lse_ref(h, lost5, cfg, **kw))
        cases.append((name, lambda h=h, hd=hd, cfg=cfg, kw=kw: project_lse(h, hd, cfg, **kw),
                      lambda h=h, hd=hd, cfg=cfg, kw=kw: project_lse_ref(h, hd, cfg, **kw),
                      abs_errs, wrong, None))
    return cases


# the keystroke cases, whose calls are host-bound (row_ms ~ row_host_ms):
# phase 2 also reads their device time from the profiler
KEY_CASES = tuple(f"project_lse int8 {tag}" for tag in KEY_ROWS) + (
    "project_lse dequant fp32 R10",) + tuple(f"project_lse dsoftmax int8 {tag}"
                                             for tag in KEY_ROWS5)


def long_cases(dev):
    """decode_long's shapes (phase 3e), on their own draws: ``project_lse``
    at a seeded chunk's ``score_hidden`` rows (``LONG_ROWS``: M x B = 50),
    on the 50k int8 head and config 5's D-softmax int8 head, as
    ``keystroke_cases`` builds them; ``cand_dot`` bf16 at a chunk frame's
    one sentence and at ``score_hidden``'s M = 5 (``LONG_CANDS``), wrong:
    beam rows 8 on read from rows 0 on; and ``lstm_cell_step`` bf16 at a
    frame's 10 rows, wrong: gates j and f swapped."""
    from jlm_tpu_torch.ops.cand_dot import cand_dot, cand_dot_ref
    from jlm_tpu_torch.ops.lstm_cell import cell_weight_tiles, lstm_cell_ref, lstm_cell_step

    rng = np.random.default_rng(LONG_LEN)
    cases = keystroke_cases(dev, rng, rows=LONG_ROWS, rows5=LONG_ROWS, parity=False)

    def t(a, dtype=torch.bfloat16):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev).to(dtype)

    for tag, n in LONG_CANDS.items():
        h3 = t(rng.uniform(-1, 1, (n, B, H)))
        cols = t(rng.normal(0, 0.05, (n, C1, H)))
        cb = t(rng.normal(0, 0.1, (n, C1)), torch.float32)
        cases.append((f"cand_dot bf16 {tag}",
                      lambda h3=h3, cols=cols, cb=cb: cand_dot(h3, cols, cb),
                      lambda h3=h3, cols=cols, cb=cb: cand_dot_ref(h3, cols, cb), cand_err,
                      {"beam rows 8 on read from rows 0 on":
                       lambda h3=h3, cols=cols, cb=cb: cand_dot_ref(second_half_rows(h3), cols,
                                                                    cb)},
                      lambda h3=h3, cols=cols, cb=cb: torch.baddbmm(
                          cb.to(h3.dtype)[:, None, :], h3, cols.transpose(1, 2))))
    x, h, c = (t(rng.normal(0, s_, (B, d))) for s_, d in ((0.3, E), (0.3, H), (1.0, H)))
    W = t(rng.normal(0, 0.05, (E + H, 4 * H)))
    b = t(rng.normal(0, 0.1, 4 * H), torch.float32)
    cell_weight_tiles(W, E, H)  # as build_decode_head makes it

    def plain(W=W, b=b):
        c_new, h_new = lstm_cell_ref(x, h, c, W, b, 1.0)
        return c_new.to(torch.bfloat16), h_new.to(torch.bfloat16)

    w_ih, w_hh, b_ih = torch_gates(W, b)
    cases.append(("lstm_cell_step bf16 R10",
                  lambda: lstm_cell_step(x, h, c, W, b, 1.0, compute_dtype=torch.bfloat16,
                                         c_out_dtype=torch.bfloat16),
                  plain, cell_err, {"gates j and f swapped": lambda: plain(swap_jf(W), swap_jf(b))},
                  lambda: torch.lstm_cell(x, (h, c), w_ih, w_hh, b_ih.to(torch.bfloat16),
                                          torch.zeros_like(b_ih, dtype=torch.bfloat16))))
    return cases


# decode_long's cases: host-bound as the keystroke cases (device time from
# the profiler too)
LONG_CASES = (tuple(f"project_lse int8 {tag}" for tag in LONG_ROWS)
              + tuple(f"project_lse dsoftmax int8 {tag}" for tag in LONG_ROWS)
              + tuple(f"cand_dot bf16 {tag}" for tag in LONG_CANDS)
              + ("lstm_cell_step bf16 R10",))


def profiled(fn, n: int = 50):
    """``(device ms, device ms by kernel name, wall ms)`` a call of ``fn``
    over ``n`` calls: the CUDA kernels and copies that ``torch.profiler``
    records, summed; the wall time on the host clock under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n * 1e3
    by = {}
    for e in prof.key_averages():
        if e.device_type.name == "CUDA":
            us = getattr(e, "device_time_total", None) or e.cuda_time_total
            by[e.key] = by.get(e.key, 0.0) + us / n / 1e3
    return sum(by.values()), by, wall


def pct(secs, q):
    """The ``q``-th percentile of a list of seconds, in ms."""
    return float(np.percentile(np.asarray(secs) * 1e3, q))


def same_nbest(got, want, tol):
    """(every n-best's segments equal, max |score difference|)."""
    same = all([r.segments for r in g] == [r.segments for r in w] for g, w in zip(got, want))
    worst = max((abs(a.score - b.score) for g, w in zip(got, want) for a, b in zip(g, w)),
                default=0.0)
    return same and len(got) == len(want) and worst <= tol, worst


def keystroke_run(dev, card, config, vocab, lexicon, qp, kanas, oracle_q_results, data5):
    """Phase 3d: per-keystroke serving at BASELINE config 4's widths (int8
    weights, the int8-MXU head) through the entry points a user calls.
    ``IncrementalDecoder`` types each sentence one kana at a time (reset
    between): speed mode (final top-1 vs the int8 oracle, 50/50), with
    ``speculate=SPECULATE`` (the same n-best at every keystroke), and the
    parity mode (``precision="highest"``, kernel on: every prefix's top-1
    equals the fp32 ``BeamDecoder``'s, final scores within 1e-3 of the int8
    oracle); ``SessionServer`` at ``SESSIONS`` sessions (each types sentence
    i mod 50), probes on and off, at 50k and at config 5 (``data5``): every
    session equals the single-session decoder's; ``Suggester`` on the typed
    contexts against the numpy oracle; config 5's typing also against its
    int8 oracle, 50/50.  ``project_lse``'s launches are counted by row
    count (``project_lse.rows``, set to 0 before each run): every push
    launches once per head block at its rows, twice with speculation (the
    typed frame, then the speculated frames as one call).  Returns the
    launches by kernels-line name, each the count measured at its rows."""
    from jlm_tpu_torch.config import EOS_ID
    from jlm_tpu_torch.decoder import IncrementalDecoder, SessionServer, Suggester
    from jlm_tpu_torch.decoder.engine import BeamDecoder
    from jlm_tpu_torch.oracle import OracleLM
    from jlm_tpu_torch.ops.project import project_lse

    def rows_of(run):
        """``run(push)`` with ``project_lse.rows`` set to 0 just before;
        ``push(call, want)`` checks the call's launches by row count against
        ``want``.  Returns (``run``'s result, its launches by row count,
        pushes and resets)."""
        project_lse.rows = {}
        off = []

        def push(call, want):
            before = dict(project_lse.rows)
            out = call()
            got = {r: n - before.get(r, 0) for r, n in project_lse.rows.items()
                   if n != before.get(r, 0)}
            if got != want:
                off.append((got, want))
            return out

        out = run(push)
        check(not off, f"launches by rows a push {off[:3]}")
        return out, dict(project_lse.rows)

    def typed(dec, sentences, per_push, n_best=1):
        """Each sentence typed from a reset; (n-best after every keystroke
        by sentence, seconds a push, launches by rows).  ``per_push``: each
        push's launches by row count."""
        dec.reset()
        for ch in sentences[0]:  # warm-up
            dec.push(ch)
        dec.spec_hits = dec.spec_misses = 0
        secs = []

        def run(push):
            out = []
            for kana in sentences:
                dec.reset()
                res = []
                for ch in kana:
                    t0 = time.perf_counter()
                    res.append(push(lambda: dec.push(ch, n_best=n_best), per_push))
                    secs.append(time.perf_counter() - t0)
                out.append(res)
            return out

        out, rows = rows_of(run)
        return out, secs, rows

    def latency(label, secs):
        log(f"{label}: {len(secs)} keystrokes, per keystroke p50 {pct(secs, 50):.4f} ms, "
            f"p99 {pct(secs, 99):.4f} ms, mean {1e3 * sum(secs) / len(secs):.4f} ms "
            f"(host clock) on {card}")

    def serve(srv, sentences, blocks):
        """SESSIONS sessions typing in one interleaved stream; (final
        n-best per session, seconds a push, launches by rows, events)."""
        warm = srv.open()
        for ch in sentences[0]:
            srv.push([(warm, ch)])
        srv.close(warm)
        texts = [sentences[i % len(sentences)] for i in range(SESSIONS)]
        sids = [srv.open() for _ in texts]
        secs, n_events = [], 0

        def run(push):
            nonlocal n_events
            for t in range(max(len(x) for x in texts)):
                events = [(sid, x[t]) for sid, x in zip(sids, texts) if t < len(x)]
                t0 = time.perf_counter()
                push(lambda: srv.push(events), {srv._bucket(len(events)) * B_: blocks})
                secs.append(time.perf_counter() - t0)
                n_events += len(events)

        _, by_rows = rows_of(run)
        res = [srv.results(sid, 3) for sid in sids]
        for sid in sids:
            srv.close(sid)
        return res, secs, by_rows, n_events

    def server_run(label, srv, sentences, blocks, single):
        res, secs, by_rows, n_events = serve(srv, sentences, blocks)
        ok, worst = same_nbest(res, [single[i % len(single)][-1] for i in range(SESSIONS)],
                               KEY_BOUNDS["speed"])
        log(f"{label}: {n_events} keystrokes in {len(secs)} pushes, push p50 "
            f"{pct(secs, 50):.4f} ms, p99 {pct(secs, 99):.4f} ms, {n_events / sum(secs):.1f} "
            f"keystrokes/s (host clock) on {card}; launches by rows {by_rows}; vs the "
            f"single-session decoder: n-best equal {ok}, max |score diff| {worst:.3e}")
        check(ok, f"{label}: sessions differ from the single-session decoder")
        return by_rows

    B_ = config.beam_pad
    launches = {}
    speed = IncrementalDecoder(qp, lexicon, vocab, config, precision="default", device=dev)
    res0, secs0, rows0 = typed(speed, kanas, {B_: 1}, n_best=3)
    latency("keystroke, speed mode, speculate 0", secs0)
    n = identical([r[-1] for r in res0], oracle_q_results)
    log(f"keystroke speed mode int8 parity {n}/{len(kanas)} (final top-1 vs int8 oracle)")
    check(n == len(kanas), "keystroke speed mode int8 parity")
    log(f"speculate 0: launches by rows {rows0}")

    spec = IncrementalDecoder(qp, lexicon, vocab, config, precision="default",
                              speculate=SPECULATE, device=dev)
    res4, secs4, rows4 = typed(spec, kanas, {B_: 1, SPECULATE * B_: 1}, n_best=3)
    latency(f"keystroke, speed mode, speculate {SPECULATE}", secs4)
    ok, worst = same_nbest([r for s in res4 for r in s], [r for s in res0 for r in s],
                           KEY_BOUNDS["speed"])
    log(f"speculate {SPECULATE}: hits {spec.spec_hits}, misses {spec.spec_misses}; the same "
        f"n-best as speculate 0 at every keystroke {ok}, max |score diff| {worst:.3e}; "
        f"launches by rows {rows4} ({len(secs4)} pushes, each one at {B_} and one at "
        f"{SPECULATE * B_} rows; the rest at {SPECULATE * B_} primed resets)")
    check(ok, "speculation changed a keystroke's n-best")
    launches["project_lse R10"] = rows0[B_] + rows4[B_]
    launches["project_lse R40"] = rows4[SPECULATE * B_]
    del spec

    parity = IncrementalDecoder(qp, lexicon, vocab, config, precision="highest",
                                use_kernel=True, device=dev)
    resp, secsp, rowsp = typed(parity, kanas, {B_: 1})
    latency("keystroke, parity mode (dequant fp32 head)", secsp)
    prefixes = [k[:i] for k in kanas for i in range(1, len(k) + 1)]
    batch = BeamDecoder(qp, lexicon, vocab, config, precision="highest",
                        device=dev).decode_batch(prefixes)
    n = identical([r for s in resp for r in s], [b[0] for b in batch])
    worst = max(abs(s[-1][0].score - o.score) for s, o in zip(resp, oracle_q_results))
    log(f"keystroke parity mode: {n}/{len(prefixes)} prefixes' top-1 equal the fp32 "
        f"BeamDecoder's; final scores max |score - int8 oracle| {worst:.3e}")
    check(n == len(prefixes), "keystroke parity mode vs BeamDecoder")
    check(worst <= KEY_BOUNDS["parity vs oracle"], f"keystroke parity scores off by {worst}")
    launches["project_lse dequant fp32 R10"] = rowsp[B_]
    del parity, batch

    rows640 = 0
    for probes in (True, False):
        srv = SessionServer(qp, lexicon, vocab, config, max_sessions=SESSIONS,
                            precision="default", probes=probes, device=dev)
        by_rows = server_run(f"server 50k, {SESSIONS} sessions, probes "
                             f"{'on' if probes else 'off'}", srv, kanas, 1, res0)
        rows640 += by_rows.get(SESSIONS * B_, 0)
        del srv
    launches["project_lse R640"] = rows640
    check(rows640 > 0, "no push of 64 events")

    cfg5, vocab5, lexicon5, qp5, oracle5_q_results = data5
    blocks5 = len(cfg5.dsoftmax.block_sizes)
    inc5 = IncrementalDecoder(qp5, lexicon5, vocab5, cfg5, precision="default", device=dev)
    res5, secs5, rows5 = typed(inc5, kanas, {B_: blocks5}, n_best=3)
    latency("keystroke, config 5, speed mode", secs5)
    n = identical([r[-1] for r in res5], oracle5_q_results)
    log(f"keystroke config 5 int8 parity {n}/{len(kanas)} (final top-1 vs int8 oracle); "
        f"launches by rows {rows5}")
    check(n == len(kanas), "keystroke config 5 int8 parity")
    launches["project_lse dsoftmax int8 R10"] = rows5[B_]
    del inc5
    srv5 = SessionServer(qp5, lexicon5, vocab5, cfg5, max_sessions=SESSIONS,
                         precision="default", device=dev)
    by_rows = server_run(f"server config 5, {SESSIONS} sessions, probes on", srv5, kanas,
                         blocks5, res5)
    launches["project_lse dsoftmax int8 R640"] = by_rows.get(SESSIONS * B_, 0)
    check(launches["project_lse dsoftmax int8 R640"] > 0, "config 5: no push of 64 events")
    del srv5

    sugg = Suggester(qp, vocab, config, device=dev)
    lm = OracleLM(qp, config)
    secs, worst, bad = [], 0.0, 0
    for s in res0[:10]:
        context = [w for _, w in s[-1][0].segments]
        t0 = time.perf_counter()
        ids, vals = sugg.top_k(context, k=5)
        secs.append(time.perf_counter() - t0)
        state = lm.initial_state(1)
        for w in [EOS_ID] + context:
            logp, state = lm.step(np.asarray([w]), state)
        logp = logp[0]
        worst = max(worst, float(np.abs(np.asarray(vals) - logp[ids]).max()))
        # the oracle's top 5 (up to ties within the bound)
        bad += int(min(vals) < np.sort(logp)[-5] - KEY_BOUNDS["suggest logp"])
    log(f"suggest (top 5 of {V}, fp32): {len(secs)} contexts, p50 {pct(secs, 50):.4f} ms "
        f"on {card}; vs the numpy oracle max |logp diff| {worst:.3e} (bound "
        f"{KEY_BOUNDS['suggest logp']:g}), outside its top 5: {bad}")
    check(worst <= KEY_BOUNDS["suggest logp"] and bad == 0, "suggest vs the oracle")
    return launches


def long_inputs(kanas, lexicon, T_c):
    """Phase 3e's inputs: the 50 test sentences joined in order and cut at
    sentence boundaries into three of about ``LONG_LEN`` kana (the third
    takes the rest), then an adversarial one: T_c - 1 kana, a lexicon
    reading of 3 or more kana across the cut at T_c, then 2 kana."""
    inputs, cur = [], ""
    for k in kanas:
        cur += k
        if len(cur) >= LONG_LEN and len(inputs) < 2:
            inputs.append(cur)
            cur = ""
    inputs.append(cur)
    span = next(r for r in sorted(lexicon.by_reading) if len(r) >= 3)
    return inputs + ["".join(kanas)[:T_c - 1] + span + "のは"]


def lm_score(lm, words):
    """The oracle LM's score of a word path, summed as the engine sums it:
    ``<eos>``, then each word from a zero state, then ``<eos>`` again."""
    from jlm_tpu_torch.config import EOS_ID

    state = lm.initial_state(1)
    ids = [EOS_ID] + list(words)
    total = 0.0
    for t in range(len(ids) - 1):
        logp, state = lm.step(np.asarray(ids[t:t + 1]), state)
        total += float(logp[0, ids[t + 1]])
    logp, _ = lm.step(np.asarray(ids[-1:]), state)
    return total + float(logp[0, EOS_ID])


def reads_input(res, kana, vocab) -> bool:
    """Whether a path's words read the input: each word's reading (an
    unknown word's kana as they stand), in order."""
    from jlm_tpu_torch.config import UNK_ID

    return "".join(d if w == UNK_ID else vocab.reading(w) for d, w in res.segments) == kana


def witness_inputs(kanas):
    """The witness's inputs: the 50 test sentences joined, then consecutive
    pieces of ``WITNESS_LENS`` kana (each fits one scan at 62)."""
    joined, out, at = "".join(kanas), [], 0
    for n in WITNESS_LENS:
        out.append(joined[at:at + n])
        at += n
    return out


def long_peaked(params):
    """``params`` with the embedding scaled to standard deviation
    ``LONG_PEAK[0]`` and every head weight to ``LONG_PEAK[1]`` (the LSTM as
    it is): the words move the states and the head's log-probs spread by
    nats, so paths do not tie, while the recurrence stays contracting, so
    rounding does not grow along a sentence."""
    def scale(w, std):
        w = np.asarray(w, np.float32)
        return w * np.float32(std / w.std())

    head = params["head"]
    head = ({"blocks": [{**b, "W": scale(b["W"], LONG_PEAK[1])} for b in head["blocks"]]}
            if "blocks" in head else {**head, "W": scale(head["W"], LONG_PEAK[1])})
    return {**params, "embedding": scale(params["embedding"], LONG_PEAK[0]), "head": head}


@contextlib.contextmanager
def planted(fault):
    """``decode_long`` with one deliberate fault of ``LONG_FAULTS``, to
    read what the long-input gates read on a wrong chunking: the seeds'
    position rows rolled by one (a seeded row from its neighbour), each
    seeded chunk's lattice from a window one kana late, or one frame past
    the overlap cleared (words ending just after it lost)."""
    from jlm_tpu_torch.decoder import engine as eng

    scan, pack = eng._decode_scan, eng.BeamDecoder._pack_window
    if fault == "seed rows shifted":
        def wrong_scan(*a, seed=None, **kw):
            if seed is not None:
                seed = {k: v.roll(1, dims=1) for k, v in seed.items()}
            return scan(*a, seed=seed, **kw)
        eng._decode_scan = wrong_scan
    elif fault == "window one kana late":
        eng.BeamDecoder._pack_window = lambda self, w, m: pack(
            self, w[1:] + w[-1] if m else w, m)
    elif fault == "overlap mask one frame long":
        eng.BeamDecoder._pack_window = lambda self, w, m: pack(self, w, m + 1 if m else 0)
    else:
        raise ValueError(fault)
    try:
        yield
    finally:
        eng._decode_scan, eng.BeamDecoder._pack_window = scan, pack


def long_readings(dev, config, vocab, lexicon, weights, shorts, longs, faults=True):
    """What separates chunking from arithmetic in ``decode_long`` on the
    int8 quantization of ``weights``, for two forwards with the same
    weights: the int8 speed mode and the exact-fp32 kernel forward.

    - ``witness``: each of ``shorts`` (at most 62 kana) searched in one
      scan at ``max_kana_len`` 62 and chunked at each of ``WITNESS_CUTS``,
      the same forward: (inputs whose n-best (3) are equal, max |score
      difference|) a cut;
    - ``short``, ``long``: the top-1 of ``shorts`` (one scan) and of
      ``longs`` (chunked at 62) against the uncapped int8 oracle (float64
      sums): inputs equal to it, the paths that read the input, how far the
      oracle's LM scores each other path below the oracle's best, and max
      |score - oracle| where the path is the oracle's;
    - ``faults`` (the speed mode): under each of ``LONG_FAULTS``, the
      witness at the shortest cut and the ``long`` reading."""
    from jlm_tpu_torch.decoder.engine import BeamDecoder, make_kernel_forward
    from jlm_tpu_torch.oracle import OracleDecoder, OracleLM
    from jlm_tpu_torch.ops.quant import quantize_params

    qw = quantize_params(weights)
    cfg = config.replace(n_best_max=3)
    lm = OracleLM(qw, cfg)
    oracle = OracleDecoder(lm, lexicon, vocab, cfg.replace(max_kana_len=256))
    refs = {"short": [oracle.decode(k)[0] for k in shorts],
            "long": [oracle.decode(k)[0] for k in longs]}

    def engine(mode, T_c):
        c = cfg.replace(max_kana_len=T_c)
        if mode == "int8":
            return BeamDecoder(qw, lexicon, vocab, c, precision="default", device=dev)
        return BeamDecoder(qw, lexicon, vocab, c, device=dev,
                           forward_fn=make_kernel_forward(c, torch.float32, int8_mxu=False))

    def witness(one, cut):
        got = [cut.decode(k, n_best=3) for k in shorts]
        same = sum([r.segments for r in g] == [r.segments for r in w] for g, w in zip(got, one))
        worst = max((math.inf if len(g) != len(w) else  # an n-best entry lost
                     max((abs(a.score - b.score) for a, b in zip(g, w)), default=0.0)
                     for g, w in zip(got, one)), default=0.0)
        return [same, len(shorts), worst]

    def top1(eng, ins):
        return [(eng.decode(k) or [None])[0] for k in ins]  # None: no live path

    def vs_oracle(res, ins, key):
        pairs = [(r, o) for r, o in zip(res, refs[key]) if r is not None]
        gaps = [math.inf if r is None else 0.0 if r.segments == o.segments else
                o.score - lm_score(lm, [w for _, w in r.segments]) for r, o in zip(res, refs[key])]
        same = [abs(r.score - o.score) for r, o in pairs if r.segments == o.segments]
        return {"equal": len(same), "of": len(ins),
                "reads": sum(r is not None and reads_input(r, k, vocab) for r, k in zip(res, ins)),
                "gaps": gaps, "score_diff": max(same, default=None)}

    T_c = config.max_kana_len
    out = {}
    for mode in ("int8", "exact fp32"):
        whole = engine(mode, T_c)
        one = [whole.decode(k, n_best=3) for k in shorts]
        out[mode] = {
            "witness": {cut: witness(one, engine(mode, cut)) for cut in WITNESS_CUTS},
            "short": vs_oracle([r[0] for r in one], shorts, "short"),
            "long": vs_oracle(top1(whole, longs), longs, "long")}
        if mode == "int8" and faults:
            cut = engine(mode, min(WITNESS_CUTS))
            out["faults"] = {}
            for fault in LONG_FAULTS:
                with planted(fault):
                    out["faults"][fault] = {
                        "witness": witness(one, cut),
                        "long": vs_oracle(top1(whole, longs), longs, "long")}
    out["oracle scores"] = [o.score for o in refs["long"]]
    return out


def n_chunks(G, T_c, M):
    """Chunks of a G-kana input: cuts at T_c, then every T_c - M."""
    return 1 + -(-(G - T_c) // (T_c - M))


def long_run(dev, card, config, vocab, lexicon, params, qp, kanas, data5):
    """Phase 3e: ``decode_long`` (multi-root overlap-save) at the bench's
    width through ``BeamDecoder.decode`` on three inputs of about 150 kana
    and one with a word across the first cut (``long_inputs``).  On the
    bench's random weights, int8 speed mode: each top-1 reads the input and
    is the uncapped int8 oracle's or, where homophone paths tie, a path the
    oracle's LM scores within ``LONG_BOUNDS`` of its best.  On weights
    where paths do not tie (``long_peaked``, ``long_readings``), for the
    int8 speed mode and the exact-fp32 kernel forward: the witness (inputs
    of 42 to 62 kana chunked at ``WITNESS_CUTS``, the same n-best as one
    scan) and every top-1 the uncapped int8 oracle's, short and long; each
    of ``LONG_FAULTS`` (``planted``) must fail both.  fp32 greedy equal to
    the uncapped fp32 greedy oracle's, scores within ``LONG_BOUNDS``; the
    fused frame forward's paths equal to the split one's; config 5 equal
    to its uncapped int8 oracle on the first input;
    one ``decode_batch`` of 8 short sentences and the long inputs equal to
    each input's own call.  Launches are counted for each input: over G
    kana in n chunks, ``project_lse`` and ``cand_dot`` launch G + 1 + (n -
    1) times (the root and G frames at R = 10 / S = 1, a seeded chunk's
    ``score_hidden`` at R = 50 / S = 5; config 5 three a forward), the cell
    (G + 1) x L.  Logs ms per input (host clock, ending in the fetch),
    chars/s and, from one profiled input, the device's idle share.  Returns
    the launches of the kernels line's decode_long rows."""
    from jlm_tpu_torch.decoder.engine import BeamDecoder, make_fused_frame_forward
    from jlm_tpu_torch.oracle import OracleDecoder, OracleLM
    from jlm_tpu_torch.ops.cand_dot import cand_dot
    from jlm_tpu_torch.ops.frame_step import cell_cand_step
    from jlm_tpu_torch.ops.lstm_cell import lstm_cell_step
    from jlm_tpu_torch.ops.project import project_lse

    T_c, M = config.max_kana_len, config.max_word_len
    check(M == SEED_M, f"max_word_len {M} != {SEED_M}")
    inputs = long_inputs(kanas, lexicon, T_c)
    chunks = [n_chunks(len(k), T_c, M) for k in inputs]
    log(f"decode_long inputs: {[len(k) for k in inputs]} kana, {chunks} chunks")
    check(all(len(k) > 2 * T_c - M for k in inputs[:3]) and chunks[3] == 2,
          "decode_long inputs: three of 3+ chunks and the adversarial one of 2")
    counters = (project_lse, cand_dot, lstm_cell_step, cell_cand_step)

    def counted(run):
        """``run()`` with every counter set to 0 just before; returns its
        result, the launches, ``project_lse``'s by rows and ``cand_dot``'s
        by (sentences, beam rows)."""
        for fn in counters:
            fn.launches = 0
        project_lse.rows, cand_dot.shapes = {}, {}
        out = run()
        return (out, {fn.__name__: fn.launches for fn in counters}, dict(project_lse.rows),
                dict(cand_dot.shapes))

    def expect(G, n, layers=1, blocks=1, fused=False):
        """(launches, project_lse by rows, cand_dot by (sentences, beam rows)) of one
        input: G + 1 forwards (the root and a frame a kana), n - 1
        ``score_hidden`` calls."""
        fwd, seeded = G + 1, n - 1
        return ({"project_lse": (fwd + seeded) * blocks,
                 "cand_dot": seeded + (0 if fused else fwd),
                 "lstm_cell_step": 0 if fused else fwd * layers,
                 "cell_cand_step": fwd if fused else 0},
                {B: fwd * blocks, SEED_M * B: seeded * blocks},
                {(SEED_M, B): seeded, **({} if fused else {(1, B): fwd})})

    def run_inputs(label, engine, ins, **kw):
        """Each input through ``engine.decode``, counted and checked;
        returns the results, host seconds and summed counts."""
        results, secs, total = [], [], [{}, {}, {}]
        for kana, n in zip(ins, chunks):
            t0 = time.perf_counter()
            res, *counts = counted(lambda: engine.decode(kana))
            secs.append(time.perf_counter() - t0)
            want = expect(len(kana), n, **kw)
            check(tuple(counts) == want, f"{label}, {len(kana)} kana: launches {counts}, "
                                          f"expected {want}")
            for acc, got in zip(total, counts):
                for k, v in got.items():
                    acc[k] = acc.get(k, 0) + v
            results.append(res)
        n_chars = sum(len(k) for k in ins)
        log(f"{label}: ms per input {[round(t * 1e3, 3) for t in secs]} (host clock, ending "
            f"in the fetch), {n_chars / sum(secs):.1f} chars/s on {card}; launches {total}")
        return results, secs, total

    t_phase = time.perf_counter()
    engine = BeamDecoder(qp, lexicon, vocab, config, precision="default", device=dev)
    engine.decode(inputs[0])  # warm-up
    results, secs, total = run_inputs("decode_long int8 split", engine, inputs)
    lm_q = OracleLM(qp, config)
    oracle = OracleDecoder(lm_q, lexicon, vocab, config.replace(max_kana_len=256))
    refs = [oracle.decode(k)[0] for k in inputs]
    n = identical(results, refs)
    gaps = [0.0 if r[0].segments == o.segments else
            o.score - lm_score(lm_q, [w for _, w in r[0].segments]) for r, o in zip(results, refs)]
    diff = max((abs(r[0].score - o.score) for r, o in zip(results, refs)
                if r[0].segments == o.segments), default=0.0)
    reads = sum(reads_input(r[0], k, vocab) for r, k in zip(results, inputs))
    log(f"decode_long int8, random weights: {n}/{len(inputs)} the uncapped int8 oracle's, max "
        f"|score - oracle| {diff:.3e} there (bound {LONG_BOUNDS['random int8 score']:g}); "
        f"{reads}/{len(inputs)} read the input; the oracle's LM scores each other path below "
        f"its own by {[round(g, 6) for g in gaps]} (bound {LONG_BOUNDS['random int8 tie']:g})"
        + "".join(f"; input {i}: {r[0].segments[d:d + 2]} for {o.segments[d:d + 2]}"
                  for i, (r, o) in enumerate(zip(results, refs)) if r[0].segments != o.segments
                  for d in [next(j for j, (a, b) in enumerate(zip(r[0].segments, o.segments))
                                 if a != b)]))
    check(reads == len(inputs) and diff <= LONG_BOUNDS["random int8 score"]
          and max(gaps) <= LONG_BOUNDS["random int8 tie"], "decode_long int8 vs the oracle")

    # where paths do not tie: chunking alone (the witness) and each forward
    # vs the oracle, exact; the planted faults must fail both
    t_w = time.perf_counter()
    got = long_readings(dev, config, vocab, lexicon, long_peaked(params), witness_inputs(kanas),
                        inputs)
    for mode, bound in (("int8", "int8 vs oracle"), ("exact fp32", "exact fp32 vs oracle")):
        r = got[mode]
        log(f"decode_long {mode}, weights {LONG_PEAK} (long_peaked): witness (one scan at "
            f"{T_c} vs chunked at each cut: inputs with equal n-best, of, max |score diff|) "
            f"{r['witness']} (bound {LONG_BOUNDS['witness']:g}); vs the uncapped int8 oracle "
            f"{len(WITNESS_LENS)} inputs of {WITNESS_LENS} kana {r['short']}, the long inputs "
            f"{r['long']} (bound {LONG_BOUNDS[bound]:g})")
        check(all(w[0] == w[1] and w[2] <= LONG_BOUNDS["witness"]
                  for w in r["witness"].values()), f"decode_long {mode}: the witness")
        check(all(r[k]["equal"] == r[k]["reads"] == r[k]["of"]
                  and r[k]["score_diff"] <= LONG_BOUNDS[bound] for k in ("short", "long")),
              f"decode_long {mode} vs the oracle, weights where paths do not tie")
    for fault, r in got["faults"].items():
        lo = r["long"]
        caught = (r["witness"][0] < r["witness"][1],
                  not (lo["equal"] == lo["reads"] == lo["of"]
                       and lo["score_diff"] <= LONG_BOUNDS["int8 vs oracle"]))
        log(f"decode_long planted fault '{fault}': witness {r['witness']}, vs the oracle {lo}; "
            f"caught by the witness {caught[0]}, by the oracle gate {caught[1]}")
        check(all(caught), f"decode_long: the planted fault '{fault}' passed a gate")
    log(f"decode_long witness and oracle gates: {time.perf_counter() - t_w:.1f} s")
    fused = BeamDecoder(qp, lexicon, vocab, config, device=dev,
                        forward_fn=make_fused_frame_forward(config))
    fused.decode(inputs[0])  # warm-up
    res_f, _, _ = run_inputs("decode_long int8 fused frame", fused, inputs, fused=True)
    same = sum(a[0].segments == b[0].segments for a, b in zip(res_f, results))
    log(f"decode_long fused frame: {same}/{len(inputs)} paths equal to the split frame's")
    check(same == len(inputs), "decode_long fused frame paths")
    del fused

    greedy_cfg = config.replace(beam_width=1)
    greedy = BeamDecoder(params, lexicon, vocab, greedy_cfg, precision="highest", device=dev)
    res_g = [greedy.decode(k) for k in inputs]
    oracle_g = OracleDecoder(OracleLM(params, greedy_cfg), lexicon, vocab,
                             greedy_cfg.replace(max_kana_len=256))
    ref_g = [oracle_g.decode(k)[0] for k in inputs]
    n = identical(res_g, ref_g)
    worst = max(abs(r[0].score - o.score) for r, o in zip(res_g, ref_g))
    log(f"decode_long greedy fp32 parity {n}/{len(inputs)} (vs the uncapped fp32 oracle); max "
        f"|score - oracle| {worst:.3e} (bound {LONG_BOUNDS['fp32 vs oracle']:g})")
    check(n == len(inputs) and worst <= LONG_BOUNDS["fp32 vs oracle"], "decode_long fp32 parity")
    del greedy

    cfg5, vocab5, lexicon5, qp5 = data5
    engine5 = BeamDecoder(qp5, lexicon5, vocab5, cfg5, precision="default", device=dev)
    engine5.decode(inputs[0])  # warm-up
    res5, _, total5 = run_inputs("decode_long config 5 int8", engine5, inputs[:1],
                                 layers=cfg5.num_layers, blocks=len(cfg5.dsoftmax.block_sizes))
    oracle5 = OracleDecoder(OracleLM(qp5, cfg5), lexicon5, vocab5, cfg5.replace(max_kana_len=256))
    n = identical(res5, [oracle5.decode(inputs[0])[0]])
    log(f"decode_long config 5 int8 parity {n}/1 (vs its uncapped int8 oracle)")
    check(n == 1, "decode_long config 5 parity")
    del engine5

    batch = kanas[:8] + inputs
    t0 = time.perf_counter()
    res_b = engine.decode_batch(batch)
    wall_b = time.perf_counter() - t0
    own = [engine.decode(k) for k in kanas[:8]] + results
    ok, worst = same_nbest(res_b, own, LONG_BOUNDS["batch vs own call"])
    log(f"decode_batch of 8 short and {len(inputs)} long inputs: each equal to its own call "
        f"{ok}, max |score diff| {worst:.3e}; wall {wall_b * 1e3:.3f} ms")
    check(ok, "decode_batch with long inputs vs each input's own call")

    dev_ms, by, wall = profiled(lambda: engine.decode(inputs[0]), n=3)
    top = sorted(by.items(), key=lambda kv: -kv[1])[:6]
    log(f"decode_long profiled ({len(inputs[0])} kana): device busy {dev_ms:.4f} ms of "
        f"{wall:.4f} ms wall, idle share {1 - dev_ms / wall:.4f}; by kernel "
        + ", ".join(f"{k[:40]} {v:.4f}" for k, v in top))
    log(f"phase 3e: {time.perf_counter() - t_phase:.1f} s")
    return {"project_lse R50": total[1][SEED_M * B], "cand_dot S1": total[2][1, B],
            "cand_dot S5": total[2][SEED_M, B], "lstm_cell_step R10": total[0]["lstm_cell_step"],
            "project_lse dsoftmax int8 R50": total5[1][SEED_M * B]}


# exponentials of each head case: one per logit (R x V)
EXPS = {
    "project_lse": R * V, "project_lse bf16": R * V, "project_lse bf16 D1024": R * V,
    "project_lse dequant bf16 D1024": R * V, "project_lse dsoftmax int8": R * V5,
    "project_lse dsoftmax bf16": R * V5, "project_lse dequant bf16": R * V,
    "project_lse fp32": R32 * V5, "project_lse dequant fp32": R32 * V,
    "project_candidates fp32": R_CAND * V, "project_candidates dequant fp32": R_CAND * V,
    "project_candidates dequant bf16": R_CAND * V, "project_candidates int8": R_CAND * V,
    "project_candidates dsoftmax int8": R_CAND * V5,
    "project_candidates dsoftmax fp32": R_CAND * V5,
    **{f"project_lse D{d}": R * V for d in INT8_WIDE},
    # the bf16 CE forward: one per logit of the training rows
    "ce_fwd": N_CE * V, "ce_fwd D1024": N_CE * V, f"ce_fwd bf16 D{DS_D}": N_CE * V,
    # the keystroke paths' rows
    **{f"project_lse {tag}": r * V for tag, r in KEY_ROWS.items()},
    "project_lse dequant fp32 R10": KEY_ROWS["R10"] * V,
    **{f"project_lse dsoftmax int8 {tag}": r * V5 for tag, r in KEY_ROWS5.items()},
    # decode_long's score_hidden rows
    **{f"project_lse {tag}": r * V for tag, r in LONG_ROWS.items()},
    **{f"project_lse dsoftmax int8 {tag}": r * V5 for tag, r in LONG_ROWS.items()},
}
SFU_PER_CLOCK = 16  # exponentials a clock per SM (the special-function units)
# exponentials per second of the card: set in main from the SM count and
# nvidia-smi's clocks.max.sm
SFU_RATE = {"exp": None}


def scan_stage_work(E_, H_):
    """(bytes, operations) of the scan's five kernels at B = TB, T = TT.
    Forward: the input product reads xs and Wx and writes Zx; the
    recurrence reads Zx, Wh, b, c0, h0 and writes hs, cs, c_T, h_T; their
    operations, 2 M E 4H + 2 M H 4H (M = TB TT rows), sum to
    lstm_scan_fwd's.  Backward: the gate recompute reads [x; h_prev], W, b
    and writes Z; the recurrence reads Z, Wh, cs, c0, d_hs, d_cf, d_hf and
    writes dz, dc0, dh0; dx reads dz and Wx and writes dx.  Their
    operations, 2 M (E+H) 4H + 2 M 4H H + 2 M 4H E, sum to lstm_scan_bwd's
    4 M (E+H) 4H."""
    M, H4 = TB * TT, 4 * H_
    return {
        "scan_xw": (4 * (M * E_ + E_ * H4 + M * H4), 2 * M * E_ * H4),
        "scan_fwd_recur": (4 * (M * H4 + H_ * H4 + H4 + 2 * TB * H_ + 2 * M * H_ + 2 * TB * H_),
                           2 * M * H_ * H4),
        "scan_gates": (4 * (M * (E_ + H_) + (E_ + H_) * H4 + H4 + M * H4),
                       2 * M * (E_ + H_) * H4),
        "scan_recur": (4 * (M * H4 + H_ * H4 + 2 * M * H_ + TB * H_ + 2 * TB * H_
                            + M * H4 + 2 * TB * H_), 2 * M * H4 * H_),
        "scan_dx": (4 * (M * H4 + E_ * H4 + M * E_), 2 * M * H4 * E_),
    }


def ce_work(N, D, Vb, cd):
    """(bytes, operations, type) of the three CE kernels at N rows, width D
    and Vb columns, computing in ``cd``: h and W read in the type the
    kernel reads (bf16: h cast and the step's W^T), b, y int64 and three
    fp32 row terms (the backward's lse, ga, gb; the forward's m, s, t
    out); dh, or dW and db, written in fp32.  Each backward makes two
    products (the logits again, then dh or dW)."""
    e = 2 if cd == "bf16" else 4
    io = N * D * e + D * Vb * e + Vb * 4 + N * 8 + 3 * N * 4
    return {"ce_fwd": (io, 2 * N * D * Vb, cd),
            "ce_bwd_dh": (io + N * D * 4, 4 * N * D * Vb, cd),
            "ce_bwd_dw": (io + D * Vb * 4 + Vb * 4, 4 * N * D * Vb, cd)}


def work():
    """(bytes, operations, type) of each kernel's function on its phase-2
    inputs: every input read once and every output written once, and the
    products' operations (2 per multiply-add) at the peak of their type."""
    scan_in = 4 * (TB * TT * E + (E + H) * 4 * H + 4 * H + 2 * TB * H)  # xs W b c0 h0
    scan_in_w = 4 * (TB * TT * HW + 2 * HW * 4 * HW + 4 * HW + 2 * TB * HW)
    scan_w = {  # the scan kernels at H = E = HW: fp32 products, or (bf16) products
        # of bf16-rounded x, h, W and dz summed in fp32, at the bf16 peak
        "lstm_scan_fwd": (scan_in_w + 4 * (2 * TB * TT * HW + 2 * TB * HW),
                          2 * TB * TT * 2 * HW * 4 * HW),
        "lstm_scan_bwd": (scan_in_w + 4 * (3 * TB * TT * HW + 2 * TB * HW + TB * TT * 4 * HW
                                           + TB * TT * HW + 2 * TB * HW),
                          4 * TB * TT * 2 * HW * 4 * HW),
        **scan_stage_work(HW, HW)}
    cand_io = C_CAND * 4 + R_CAND * C_CAND * 4  # ids in, log-probs out
    (eo, ho), (fe, fh) = ODD_CELL, ODD_FRAME
    return {
        # h bf16, W int8 (one layout), scale, bias -> lse
        "project_lse": (R * H * 2 + H * V + V * 8 + R * 4, 2 * R * H * V, "int8"),
        # h bf16, W bf16, bias -> lse
        "project_lse bf16": (R * H * 2 + H * V * 2 + V * 4 + R * 4, 2 * R * H * V, "bf16"),
        "project_lse bf16 D1024": (R * HW * 2 + HW * V * 2 + V * 4 + R * 4, 2 * R * HW * V,
                                   "bf16"),
        "project_lse dequant bf16 D1024": (R * HW * 2 + HW * V + V * 8 + R * 4,
                                           2 * R * HW * V, "bf16"),
        **{f"{k} D1024": v for k, v in ce_work(N_CE, HW, V, "bf16").items()},
        **{f"{k} fp32 D1024": v for k, v in ce_work(N_CE, HW, V, "fp32").items()},
        **{f"{k} H1024": (*scan_w[k], "fp32") for k in scan_w},
        **{f"{k} bf16 H1024": (*scan_w[k], "bf16") for k in scan_w},
        # x, h, c bf16, W bf16, b -> c', h' bf16
        "lstm_cell_step": (R * (E + 4 * H) * 2 + (E + H) * 4 * H * 2 + 4 * H * 4,
                           2 * R * (E + H) * 4 * H, "bf16"),
        "cand_dot": (S * B * H * 2 + S * C1 * H * 2 + S * C1 * 4 + S * B * C1 * 4,
                     2 * S * B * C1 * H, "bf16"),
        # the head's other modes: h (each block reads its slice), the blocks'
        # weights (int8, bf16 or fp32), scales and biases -> lse
        "project_lse dsoftmax int8": (R * H * 2 + HEAD5 + V5 * 8 + R * 4,
                                      2 * R * HEAD5, "int8"),
        "project_lse dsoftmax bf16": (R * H * 2 + HEAD5 * 2 + V5 * 4 + R * 4,
                                      2 * R * HEAD5, "bf16"),
        # int8 weights dequantized to bf16 operands: the product at the bf16 peak
        "project_lse dequant bf16": (R * H * 2 + H * V + V * 8 + R * 4,
                                     2 * R * H * V, "bf16"),
        "project_lse fp32": (R32 * H * 4 + HEAD5 * 4 + V5 * 4 + R32 * 4,
                             2 * R32 * HEAD5, "fp32"),
        # int8 weights dequantized to fp32 operands: exact fp32 FMAs
        "project_lse dequant fp32": (R32 * H * 4 + H * V + V * 8 + R32 * 4,
                                     2 * R32 * H * V, "fp32"),
        # x, h, c fp32, W fp32, b -> c', h' fp32
        "lstm_cell_step fp32": (R32 * (E + 4 * H) * 4 + (E + H) * 4 * H * 4 + 4 * H * 4,
                                2 * R32 * (E + H) * 4 * H, "fp32"),
        **ce_work(N_CE, H, V, "bf16"),
        f"ce_fwd bf16 D{DS_D}": ce_work(N_CE, DS_D, V, "bf16")["ce_fwd"],
        # -> hs, cs [B,T,H], c_T, h_T
        "lstm_scan_fwd": (scan_in + 4 * (2 * TB * TT * H + 2 * TB * H),
                          2 * TB * TT * (E + H) * 4 * H, "fp32"),
        # + hs, cs, d_hs, d_cf, d_hf -> dz, dx, dc0, dh0; recompute, dx and dh
        "lstm_scan_bwd": (scan_in + 4 * (3 * TB * TT * H + 2 * TB * H + TB * TT * 4 * H
                                         + TB * TT * E + 2 * TB * H),
                          4 * TB * TT * (E + H) * 4 * H, "fp32"),
        # the scan's five kernels: each direction's operations sum to its whole's
        **{k: (*v, "fp32") for k, v in scan_stage_work(E, H).items()},
        # fp32 compute: h and W read in fp32, the products at the fp32 peak
        **{f"{k} fp32": v for k, v in ce_work(N_CE, H, V, "fp32").items()},
        f"ce_fwd fp32 D{DS_D}": ce_work(N_CE, DS_D, V, "fp32")["ce_fwd"],
        # h (fp32, or bf16 where the product is), the head, scales, biases, ids
        # -> [R, C] log-probs
        "project_candidates fp32": (R_CAND * H * 4 + H * V * 4 + V * 4 + cand_io,
                                    2 * R_CAND * H * V, "fp32"),
        "project_candidates dequant fp32": (R_CAND * H * 4 + H * V + V * 8 + cand_io,
                                            2 * R_CAND * H * V, "fp32"),
        "project_candidates dequant bf16": (R_CAND * H * 2 + H * V + V * 8 + cand_io,
                                            2 * R_CAND * H * V, "bf16"),
        "project_candidates int8": (R_CAND * H * 2 + H * V + V * 8 + cand_io,
                                    2 * R_CAND * H * V, "int8"),
        "project_candidates dsoftmax int8": (R_CAND * H * 2 + HEAD5 + V5 * 8 + cand_io,
                                             2 * R_CAND * HEAD5, "int8"),
        "project_candidates dsoftmax fp32": (R_CAND * H * 4 + HEAD5 * 4 + V5 * 4 + cand_io,
                                             2 * R_CAND * HEAD5, "fp32"),
        # x, h, c bf16, W bf16, b, cols bf16, cbias -> c' fp32, h' bf16, cand fp32
        "cell_cand_step": (R * (E + 2 * H) * 2 + (E + H) * 4 * H * 2 + 4 * H * 4
                           + S * C1 * (H * 2 + 4) + R * H * (4 + 2) + R * C1 * 4,
                           2 * R * (E + H) * 4 * H + 2 * R * C1 * H, "bf16"),
        # the same in fp32 at the fp32 parity run's frame (R32 rows, S32 sentences)
        "cell_cand_step fp32": (R32 * (E + 2 * H) * 4 + (E + H) * 4 * H * 4 + 4 * H * 4
                                + S32 * C1 * (H * 4 + 4) + R32 * H * 8 + R32 * C1 * 4,
                                2 * R32 * (E + H) * 4 * H + 2 * R32 * C1 * H, "fp32"),
        # cand_dot's other modes: fp32 at the serving frame; a beam of 20
        "cand_dot fp32": (S * B * H * 4 + S * C1 * H * 4 + S * C1 * 4 + S * B * C1 * 4,
                          2 * S * B * C1 * H, "fp32"),
        "cand_dot B20": (S * 20 * H * 2 + S * C1 * H * 2 + S * C1 * 4 + S * 20 * C1 * 4,
                         2 * S * 20 * C1 * H, "bf16"),
        # the width repairs (odd_width_cases' shapes)
        **{f"project_lse D{d}": (R * d * 2 + d * V + V * 8 + R * 4, 2 * R * d * V, "int8")
           for d in INT8_WIDE},
        # the keystroke paths' rows: as project_lse and project_lse dequant
        # fp32 (h fp32 there) at r rows
        **{f"project_lse {tag}": (r * H * 2 + H * V + V * 8 + r * 4, 2 * r * H * V, "int8")
           for tag, r in KEY_ROWS.items()},
        "project_lse dequant fp32 R10": (B * H * 4 + H * V + V * 8 + B * 4, 2 * B * H * V,
                                         "fp32"),
        **{f"project_lse dsoftmax int8 {tag}": (r * H * 2 + HEAD5 + V5 * 8 + r * 4,
                                                2 * r * HEAD5, "int8")
           for tag, r in KEY_ROWS5.items()},
        # decode_long's shapes (long_cases): the head at score_hidden's rows,
        # cand_dot at S sentences of B beams, the cell at a frame's B rows
        **{f"project_lse {tag}": (r * H * 2 + H * V + V * 8 + r * 4, 2 * r * H * V, "int8")
           for tag, r in LONG_ROWS.items()},
        **{f"project_lse dsoftmax int8 {tag}": (r * H * 2 + HEAD5 + V5 * 8 + r * 4,
                                                2 * r * HEAD5, "int8")
           for tag, r in LONG_ROWS.items()},
        **{f"cand_dot {tag}": (n * B * H * 2 + n * C1 * H * 2 + n * C1 * 4 + n * B * C1 * 4,
                               2 * n * B * C1 * H, "bf16") for tag, n in LONG_CANDS.items()},
        "lstm_cell_step R10": (B * (E + 4 * H) * 2 + (E + H) * 4 * H * 2 + 4 * H * 4,
                               2 * B * (E + H) * 4 * H, "bf16"),
        f"lstm_cell_step E{eo} H{ho}": (R * (eo + 4 * ho) * 2 + (eo + ho) * 4 * ho * 2
                                        + 4 * ho * 4, 2 * R * (eo + ho) * 4 * ho, "bf16"),
        f"lstm_cell_step fp32 E{eo} H{ho}": (R32 * (eo + 4 * ho) * 4 + (eo + ho) * 4 * ho * 4
                                             + 4 * ho * 4, 2 * R32 * (eo + ho) * 4 * ho,
                                             "fp32"),
        f"cell_cand_step E{fe} H{fh}": (R * (fe + 2 * fh) * 2 + (fe + fh) * 4 * fh * 2
                                        + 4 * fh * 4 + S * C1 * (fh * 2 + 4) + R * fh * 6
                                        + R * C1 * 4,
                                        2 * R * (fe + fh) * 4 * fh + 2 * R * C1 * fh, "bf16"),
        # the scan forward at B = 16,384, T = 1, E = 16, H = HW (phase 2 only):
        # xs, W, b, c0, h0 -> hs, cs, c_T, h_T
        "lstm_scan_fwd fp32 B16384": (4 * (16384 * 16 + (16 + HW) * 4 * HW + 4 * HW
                                           + 6 * 16384 * HW),
                                      2 * 16384 * (16 + HW) * 4 * HW, "fp32"),
        f"cell_cand_step fp32 E{fe} H{fh}": (R32 * (fe + 2 * fh) * 4 + (fe + fh) * 4 * fh * 4
                                             + 4 * fh * 4 + S32 * C1 * (fh * 4 + 4)
                                             + R32 * fh * 8 + R32 * C1 * 4,
                                             2 * R32 * (fe + fh) * 4 * fh
                                             + 2 * R32 * C1 * fh, "fp32"),
    }


def bound_of(name):
    """(least ms the card could take, "bytes", "operations" or "exp"): the
    largest of the bytes over the memory rate, the operations over their
    peak and, for the head, its R x V exponentials over the SFU rate."""
    nbytes, ops, kind = {**work(), **shard_work(), **seq_qs_work()}[name]
    terms = [(nbytes / PEAK["bytes"] * 1e3, "bytes"), (ops / PEAK[kind] * 1e3, "operations")]
    if name in EXPS:
        terms.append((EXPS[name] / SFU_RATE["exp"] * 1e3, "exp"))
    return max(terms, key=lambda t: t[0])


def dsoftmax_case(dev, rng):
    """The D-softmax fused CE (one kernel call per block on its hidden
    slice) at the 100k head of BASELINE config 5: the mean loss and the
    grads of hs and every block against plain fp32 CE over ``head_logits``
    and against the same code through the plain versions, and the grads of
    the p-term alone (no block owns a target; random row weights) against
    the plain versions.  Returns ``{reading: (value, reading of a p-term
    off by P_SHIFT or None)}``, kernel ms and plain fp32 CE ms."""
    from jlm_tpu_torch.config import Config, default_dsoftmax_blocks
    from jlm_tpu_torch.models.heads import full_softmax_loss
    from jlm_tpu_torch.ops.softmax_ce import ce_loss_fused_dsoftmax

    cfg = Config(vocab_size=100_000, hidden_size=H, head="dsoftmax", fused_ce=True,
                 dsoftmax=default_dsoftmax_blocks(100_000, H))
    ds = cfg.dsoftmax
    blocks = [{"W": torch.from_numpy(rng.normal(0, 0.05, (d, n)).astype(np.float32)).to(dev),
               "b": torch.from_numpy(rng.normal(0, 0.1, n).astype(np.float32)).to(dev)}
              for n, d in zip(ds.block_sizes, ds.block_dims)]
    hs = torch.from_numpy(rng.uniform(-1, 1, (TB, TT, H)).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.integers(0, 100_000, (TB, TT))).to(dev)
    ga = torch.from_numpy((rng.uniform(0.5, 1.5, N_CE) / N_CE).astype(np.float32)).to(dev)
    no_target = torch.full((N_CE,), -1, device=dev)
    leaves = [hs] + [blk[k] for blk in blocks for k in ("W", "b")]
    for leaf in leaves:
        leaf.requires_grad_(True)

    def mean_loss(c=cfg):
        loss = full_softmax_loss({"head": {"blocks": blocks}}, c, hs, y)
        return (loss, *torch.autograd.grad(loss, leaves))

    def p_term():
        rows = ce_loss_fused_dsoftmax(
            hs.reshape(N_CE, H), [blk["W"] for blk in blocks], [blk["b"] for blk in blocks],
            no_target, ds.block_sizes, ds.block_dims, ds.mode, torch.bfloat16)
        return torch.autograd.grad(rows, leaves, grad_outputs=ga)

    got, fp32, got_p = mean_loss(), mean_loss(cfg.replace(fused_ce=False)), p_term()
    with plain_ce():
        plain, plain_p = mean_loss(), p_term()
    with plain_ce(P_SHIFT):
        wrong, wrong_p = mean_loss(), p_term()
    log(f"ce_loss_fused_dsoftmax {ds.block_sizes} @ {ds.block_dims}: "
        f"loss {got[0].item():.6f} vs plain fp32 {fp32[0].item():.6f}")
    readings = {
        "loss vs fp32": (abs(got[0].item() - fp32[0].item()), None),
        "grads vs fp32": (rel_err(got[1:], fp32[1:]), None),
        "grads vs plain": (rel_err(got[1:], plain[1:]), rel_err(wrong[1:], plain[1:])),
        "p-term grads vs plain": (rel_err(got_p, plain_p), rel_err(wrong_p, plain_p)),
    }
    return (readings, cuda_ms(mean_loss, reps=5),
            cuda_ms(lambda: mean_loss(cfg.replace(fused_ce=False)), reps=5))


def candidate_run(dev, rng):
    """Candidate extraction through its entry points as
    ``scripts/bench_kernels.py:48-77`` drives them (R = 800 rows of
    N(0, 0.3), C = 65 random ids, the 50k head of N(0, 0.05) weights, zero
    bias): fp32, int8 dequant in fp32 and in bf16, int8-MXU, and config
    5's D-softmax head in int8-MXU and fp32.  Each call runs with the
    candidate counter set to 0 just before it and is held to its plain
    version at its phase-2 bound; returns the launches by kernel-line name
    (one per block of the head)."""
    from jlm_tpu_torch.ops.project import (
        project_candidates, project_candidates_dsoftmax, project_candidates_dsoftmax_ref,
        project_candidates_ref)
    from jlm_tpu_torch.ops.quant import quantize_weight

    f32, bf = torch.float32, torch.bfloat16
    cfg = config5()
    h = torch.from_numpy(rng.normal(0, 0.3, (R_CAND, H)).astype(np.float32)).to(dev)
    w = rng.normal(0, 0.05, (H, V)).astype(np.float32)
    q = quantize_weight(w, axis=0)
    Wf, Wq = torch.from_numpy(w).to(dev), torch.from_numpy(q["q"]).to(dev)
    sq = torch.from_numpy(q["scale"]).to(dev)
    b = torch.zeros(V, device=dev)
    ids = torch.from_numpy(rng.integers(0, V, C_CAND).astype(np.int32)).to(dev)
    blocks_f, blocks_q = [], []
    for n, d in BLOCKS5:
        w_k = rng.normal(0, 0.05, (d, n)).astype(np.float32)
        q_k = quantize_weight(w_k, axis=0)
        blocks_f.append({"W": torch.from_numpy(w_k).to(dev), "b": torch.zeros(n, device=dev)})
        blocks_q.append({"W": {"q": torch.from_numpy(q_k["q"]).to(dev),
                               "scale": torch.from_numpy(q_k["scale"]).to(dev)},
                         "b": blocks_f[-1]["b"]})
    ids5 = torch.from_numpy(cand_ids(rng, [n for n, _ in BLOCKS5])).to(dev)
    runs = {  # kernel-line name -> (kernel, plain, args, compute dtype, int8_mxu, blocks)
        "project_candidates fp32": (project_candidates, project_candidates_ref,
                                    (h, Wf, None, b, ids), f32, False, 1),
        "project_candidates dequant fp32": (project_candidates, project_candidates_ref,
                                            (h, Wq, sq, b, ids), f32, False, 1),
        "project_candidates dequant bf16": (project_candidates, project_candidates_ref,
                                            (h, Wq, sq, b, ids), bf, False, 1),
        "project_candidates int8": (project_candidates, project_candidates_ref,
                                    (h, Wq, sq, b, ids), bf, True, 1),
        "project_candidates dsoftmax int8": (
            project_candidates_dsoftmax, project_candidates_dsoftmax_ref,
            (h, blocks_q, cfg, ids5), bf, True, len(BLOCKS5)),
        "project_candidates dsoftmax fp32": (
            project_candidates_dsoftmax, project_candidates_dsoftmax_ref,
            (h, blocks_f, cfg, ids5), f32, False, len(BLOCKS5)),
    }
    launches = {}
    for name, (kernel, plain, args, cd, mxu, blocks) in runs.items():
        project_candidates.launches = 0
        got = kernel(*args, compute_dtype=cd, int8_mxu=mxu)
        launches[name] = project_candidates.launches
        err = abs_err(got, plain(*args, compute_dtype=cd, int8_mxu=mxu))
        log(f"candidate run {name}: [{R_CAND}, {args[-1].shape[0]}] log-probs, "
            f"{launches[name]} launch(es), err vs plain {err:.3e} (bound {BOUNDS[name]:g})")
        check(launches[name] == blocks, f"{name}: {launches[name]} launches, expected {blocks}")
        check(bool(torch.isfinite(got).all()) and bool((got < 0).all()),
              f"{name}: log-probs finite and negative")
        check(err <= BOUNDS[name], f"candidate run {name}: error {err} exceeds {BOUNDS[name]}")
    return launches


def fp32_ce_run(dev, rng):
    """``full_softmax_loss(..., precision="highest")`` with ``fused_ce``
    forward and backward through ``torch.autograd`` at the training shape,
    on the 50k head and on config 5's D-softmax head: the fp32 CE kernels
    (per block), each counter set to 0 just before, held to the plain fp32
    log-softmax route with TF32 off (bounds ``FP32_CE_BOUNDS``).  Returns
    the launches of the runs by counter name."""
    from jlm_tpu_torch.models.heads import full_softmax_loss
    from jlm_tpu_torch.ops import softmax_ce as ce

    counters = dict(zip(CE_COUNTERS, (ce.ce_fwd_raw, ce.ce_bwd_dh, ce.ce_bwd_dw)))
    total = dict.fromkeys(CE_COUNTERS, 0)
    from jlm_tpu_torch.config import Config

    cfg50 = Config(vocab_size=V, embed_size=E, hidden_size=H, fused_ce=True)
    for label, cfg, shapes in (("50k head", cfg50, [(H, V)]),
                               ("config 5 D-softmax head", config5().replace(fused_ce=True),
                                [(d, n) for n, d in BLOCKS5])):
        blocks = [{"W": torch.from_numpy(rng.normal(0, 0.05, s).astype(np.float32)).to(dev),
                   "b": torch.from_numpy(rng.normal(0, 0.1, s[1]).astype(np.float32)).to(dev)}
                  for s in shapes]
        head = blocks[0] if len(blocks) == 1 else {"blocks": blocks}
        hs = torch.from_numpy(rng.uniform(-1, 1, (TB, TT, H)).astype(np.float32)).to(dev)
        y = torch.from_numpy(rng.integers(0, cfg.vocab_size, (TB, TT))).to(dev)
        leaves = [hs] + [blk[k] for blk in blocks for k in ("W", "b")]
        for leaf in leaves:
            leaf.requires_grad_(True)

        def run(c):
            loss = full_softmax_loss({"head": head}, c, hs, y, precision="highest")
            return (loss, *torch.autograd.grad(loss, leaves))

        for fn in counters.values():
            fn.launches = 0
        got = run(cfg)
        launches = {name: fn.launches for name, fn in counters.items()}
        want = run(cfg.replace(fused_ce=False))
        loss_err, grad_err = abs(got[0].item() - want[0].item()), rel_err(got[1:], want[1:])
        ms, plain_ms = cuda_ms(lambda: run(cfg), reps=5), cuda_ms(
            lambda: run(cfg.replace(fused_ce=False)), reps=5)
        log(f"fp32 fused CE ({label}): loss {got[0].item():.6f} vs plain fp32 "
            f"{want[0].item():.6f}, diff {loss_err:.3e} (bound {FP32_CE_BOUNDS['loss']:g}); "
            f"grads rel err {grad_err:.3e} (bound {FP32_CE_BOUNDS['grads']:g}); launches "
            f"{launches}; fwd+bwd {ms:.4f} ms, plain fp32 route {plain_ms:.4f} ms")
        check(loss_err <= FP32_CE_BOUNDS["loss"], f"fp32 fused CE ({label}): loss {loss_err}")
        check(grad_err <= FP32_CE_BOUNDS["grads"], f"fp32 fused CE ({label}): grads {grad_err}")
        check(launches == dict.fromkeys(CE_COUNTERS, len(blocks)),
              f"fp32 fused CE ({label}): launches {launches}, one of each per block")
        for name in CE_COUNTERS:
            total[name] += launches[name]
    return total


def bench_config():
    from jlm_tpu_torch.config import Config

    return Config(vocab_size=V, embed_size=E, hidden_size=H, num_layers=1,
                  beam_width=10, n_best_max=1, seed=0)


def bench_data():
    """The bench's config, vocab, lexicon, weights and 50 test sentences."""
    from jlm_tpu_torch.data import Lexicon, build_vocab, generate_corpus, generate_test_set
    from jlm_tpu_torch.models.params import init_params
    from jlm_tpu_torch.ops.quant import quantize_params

    config = bench_config()
    vocab = build_vocab(generate_corpus(2000, seed=1234), config.vocab_size)
    lexicon = Lexicon.from_vocab(vocab)
    params = init_params(config)
    kanas = [k for k, _ in generate_test_set(50, seed=777)]
    return config, vocab, lexicon, params, quantize_params(params), kanas


def bench_data5():
    """Config 5's config, vocab (``build_vocab`` of the same corpus at
    100,000), lexicon, weights and their int8 quantization."""
    from jlm_tpu_torch.data import Lexicon, build_vocab, generate_corpus
    from jlm_tpu_torch.models.params import init_params
    from jlm_tpu_torch.ops.quant import quantize_params

    config = config5()
    vocab = build_vocab(generate_corpus(2000, seed=1234), V5)
    params = init_params(config)
    return config, vocab, Lexicon.from_vocab(vocab), params, quantize_params(params)


def training_corpus(vocab):
    """Train ids for exactly TRAIN_STEPS windows of TB x TT and dev ids for
    4 windows, encoded from the synthetic corpus with the serving vocab."""
    from jlm_tpu_torch.data import encode_corpus, generate_corpus, split_corpus

    train, dev, _ = split_corpus(encode_corpus(generate_corpus(16_000, seed=1234), vocab))
    n_train, n_dev = N_CE * TRAIN_STEPS + 1, N_CE * 4 + 1
    check(len(train) >= n_train and len(dev) >= n_dev, "training corpus too small")
    return train[:n_train], dev[:n_dev]


def kernel_fn(name: str) -> str:
    """The CUDA function behind a ``kernels`` entry, with its design."""
    if name.startswith(("scan_gates", "scan_dx", "scan_xw")):
        layout = "NK" if name.startswith("scan_dx") else "KN"
        if "bf16" in name:
            return f"scan_gemm_bf16_kernel<{layout}> (operands rounded on load, mma.sync)"
        return (f"scan_gemm_kernel<{layout}> (exact fp32 FMAs, 8 x 8 a thread, two blocks an "
                "SM, K split where the tiles leave most SMs idle)")
    if name.startswith("scan_fwd_recur"):
        return ("scan_fwd_recur_kernel (cooperative, a grid barrier a step, Wh's gate columns "
                "resident in shared memory" + ("; mma.sync)" if "bf16" in name else ")"))
    if name.startswith("lstm_scan_fwd"):
        gemm = "scan_gemm_bf16_kernel" if "bf16" in name else "scan_gemm_kernel"
        return f"{gemm}<KN> + scan_fwd_recur_kernel"
    if name.startswith("scan_recur"):
        return ("scan_recur_kernel (cooperative, a grid barrier a step, Wh's rows resident "
                "in shared memory)")
    if name.startswith("lstm_scan_bwd"):
        gemm = "scan_gemm_bf16_kernel" if "bf16" in name else "scan_gemm_kernel"
        return f"{gemm}<KN> + scan_recur_kernel + {gemm}<NK>"
    if name.startswith(("ce_bwd_dh fp32", "ce_bwd_dw fp32")):
        kernel = name.split(" ")[0] + "_f32_kernel<Q>"
        return (f"{kernel} (exact fp32 FMAs, one body for dh and dW: a tile's logits 8 x 4 a "
                "thread over all of D, gp in shared memory, the output's rows in registers; "
                "a cp.async ring on mbarriers"
                + ("; sum_splits_kernel the splits)" if kernel.startswith("ce_bwd_dh") else ")"))
    if name.startswith(("ce_bwd_dh", "ce_bwd_dw")) and "fp32" not in name:
        kernel = name.split(" ")[0] + "_kernel"
        return (f"{kernel}<NW> (wgmma + TMA: 64 resident rows, kv tiles through a ring of "
                "slots, gp from the accumulators into the MN-major product; cast_wt_kernel "
                "writes W^T" + ("; output slices of 512" if name.endswith(" D1024") else "")
                + (", sum_splits_kernel the splits)" if kernel.startswith("ce_bwd_dh") else ")"))
    if name == "ce_fwd" or name.startswith("ce_fwd D") or name.startswith("ce_fwd bf16"):
        return ("ce_fwd_bf16_kernel (wgmma m64n128 + TMA over W^T: 128 rows a block, "
                "resident where they fit" + (", 10 of 16 K chunks streamed beside W^T's"
                                             if name.endswith(" D1024") else "")
                + "; kv tiles through a ring, two accumulators; ms_merge_kernel the splits)")
    if name.startswith("ce_fwd fp32"):
        return ("ce_fwd_f32_kernel (exact fp32 FMAs on the scan's fp32 GEMM loop: 128 x 128 "
                "tiles, 8 x 8 a thread, two blocks an SM, W copied as it lies by cp.async; the "
                "fp32 head's online-lse epilogue, storing the target logit; ms_merge_kernel the "
                "splits)")
    if name.endswith(" D1024") and name.startswith("ce_"):
        return kernel_fn(name[:-6]) + " (K in chunks of 512)"
    if name in ("project_lse", "project_lse dsoftmax int8", "project_candidates int8",
                "project_candidates dsoftmax int8"):
        return "proj_int8_kernel (wgmma + TMA; quantize_rows_kernel before it)"
    if name in tuple(f"project_lse {tag}" for tag in (*KEY_ROWS, *LONG_ROWS)):
        return ("proj_int8_kernel (wgmma + TMA, the last 256-row block partial; "
                "quantize_rows_kernel before it)")
    if name in tuple(f"project_lse dsoftmax int8 {tag}" for tag in (*KEY_ROWS5, *LONG_ROWS)):
        return ("proj_int8_kernel (wgmma + TMA, one launch a block, the last 256-row block "
                "partial; quantize_rows_kernel before them)")
    if name in tuple(f"project_lse dsoftmax int8 {tag} shard" for tag in SHARD_ROWS):
        return ("proj_int8_kernel (wgmma + TMA, one launch a rank's block, the ragged last "
                "vocab tile masked; quantize_rows_kernel before them)")
    if name in tuple(f"project_lse D{d}" for d in INT8_WIDE):
        return ("proj_bf16_kernel<Q8> (wgmma m64n256k32 s8 + TMA; the rows streamed "
                "with W^T; quantize_rows_kernel before it)")
    if name.startswith("lstm_cell_step E"):
        return "lstm_cell_wgmma_kernel (wgmma + TMA; E, H padded to multiples of 8)"
    if name.startswith("lstm_cell_step fp32 E"):
        return kernel_fn("lstm_cell_step fp32") + " (E, H padded to multiples of 32)"
    if name.startswith("cell_cand_step E"):
        return kernel_fn("cell_cand_step") + " (E, H padded to multiples of 8)"
    if name.startswith("cell_cand_step fp32 E"):
        return kernel_fn("cell_cand_step fp32") + " (E, H padded to multiples of 32)"
    if name.startswith("cand_dot"):
        return ("cand_dot_kernel (a persistent ring of bulk copies; "
                + ("exact fp32 dots)" if "fp32" in name else "mma.sync m16n8k16 bf16)"))
    if name in ("lstm_cell_step", "lstm_cell_step R10") or name.startswith("lstm_cell_step bf16"):
        return "lstm_cell_wgmma_kernel (wgmma + TMA)"
    if name.startswith("project_") and ("fp32" in name):
        return ("proj_ms_f32_kernel (the scan's fp32 GEMM loop, 128 x 128 tiles; "
                "the online lse in its epilogue)")
    if name.startswith("project_"):
        return "proj_bf16_kernel (wgmma m64n256 + TMA; h and W^T streamed)"
    fns = {"lstm_cell_step fp32": "lstm_cell_f32_kernel (register-tiled; a cp.async ring a K part)",
           "cell_cand_step": ("cell_cand_kernel (wgmma + TMA over unit groups; each group's "
                              "candidate share by mma.sync)"),
           "cell_cand_step fp32": ("cell_cand_f32_kernel (the fp32 cell's body over 32-unit "
                                   "groups; the groups' candidate shares summed in order)")}
    if name in fns:
        return fns[name]
    return name.replace(" fp32", "_f32") + "_kernel"


CE_COUNTERS = ("ce_fwd", "ce_bwd_dh", "ce_bwd_dw")
# the training runs also count the step's one cast of W^T (``cast_wt``),
# which the bf16 forward and backward share
STEP_COUNTERS = CE_COUNTERS + ("cast_wt",)
# phase-2 cases that no path of the run launches on its own count (phase
# 5c's config-5 run launches the fp32 forward at D = 128 once a forward,
# under ce_fwd fp32's count), so the kernels line has no entry of theirs;
# phase 2 logs their bound
PHASE2_ONLY = ("lstm_scan_fwd fp32 B16384", f"ce_fwd fp32 D{DS_D}",
               "ce_fwd fp32 V12500", "ce_bwd_dh fp32 V12500", "ce_bwd_dw fp32 V12500")
SCAN_COUNTERS = ("lstm_scan_fwd", "lstm_scan_bwd", "scan_xw", "scan_fwd_recur", "scan_gates",
                 "scan_recur", "scan_dx")
# the TPU kernel each scan wrapper's kernels replace (jlm_tpu/ops/lstm_scan.py)
SCAN_REPLACES = {"lstm_scan_fwd": 92, "scan_xw": 92, "scan_fwd_recur": 92}


def scan_counters():
    """The scan's wrappers in SCAN_COUNTERS' order, each with its count."""
    from jlm_tpu_torch.ops import lstm_scan as ls

    return tuple(getattr(ls, name) for name in SCAN_COUNTERS)


def training_run(dev, config, params, train_ids, dev_ids, label, swap=None):
    """TRAIN_STEPS ``Trainer`` steps from ``params``, inside ``swap`` (a
    context that swaps kernels for plain versions) if given.  Returns the
    trainer, the per-step losses, ms per step (steps 2 on, host clock
    ending in a synchronize), the CE (with ``cast_wt``) and scan launch
    counts of the steps, and dev perplexity."""
    from jlm_tpu_torch.ops import lstm_scan as ls
    from jlm_tpu_torch.ops import softmax_ce as ce
    from jlm_tpu_torch.train import Trainer

    counters = dict(zip(STEP_COUNTERS + SCAN_COUNTERS,
                        (ce.ce_fwd_raw, ce.ce_bwd_dh, ce.ce_bwd_dw, ce.cast_wt)
                        + scan_counters()))
    trainer = Trainer(config, params, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    with swap() if swap else contextlib.nullcontext():
        steps = trainer.train_steps(train_ids, epoch=0)
        losses = [next(steps)[0]]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += [loss for loss, _ in steps]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / (len(losses) - 1)
        launches = {name: fn.launches for name, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        ppl = trainer.evaluate_ppl(dev_ids)
    losses = torch.stack(losses).cpu().numpy()
    log(f"training ({label}): {len(losses)} steps, "
        f"loss {losses[0]:.6f} -> {losses[-1]:.6f}; {ms:.3f} ms/step, "
        f"{N_CE / ms * 1e3:.1f} tokens/s; launches {launches}; peak device memory "
        f"{peak:.2f} GiB; dev ppl {ppl:.4f}")
    return trainer, losses, ms, launches, ppl


def peaked(params):
    """``params`` with every head weight (each block's) scaled to standard
    deviation ``PEAKED``: peaked softmaxes, where an operand rounded to TF32
    moves a log-prob by about the rounding of one logit instead of
    averaging away."""
    def scale(blk):
        W = np.asarray(blk["W"], np.float32)
        return {**blk, "W": W * np.float32(PEAKED / W.std())}

    head = params["head"]
    return {**params, "head": ({"blocks": [scale(b) for b in head["blocks"]]}
                               if "blocks" in head else scale(head))}


def identical(results, oracle_results) -> int:
    return sum(r[0].segments == o.segments for r, o in zip(results, oracle_results))


# ---- vocab and data parallelism (phase 3f) ----
# BASELINE config 3 (jlm_tpu/config.py:260-266): V 50,000, the D-softmax
# head of default_dsoftmax_blocks(50_000, 512), vocab sharded 4 ways; config
# 5 on its (2, 4) mesh.  Every rank of a world shares the one card (Gloo).
SHARD_N = 4
BLOCKS3 = ((8_000, 512), (17_000, 256), (25_000, 128))
HEAD3 = sum(n * d for n, d in BLOCKS3)
# rows each vocab group's head sees after the h_top gather: config 3's one
# group the whole chunk, config 5's two groups half of it each
SHARD_ROWS = {"c3": (R, BLOCKS3), "c5": (R // 2, BLOCKS5)}
# a (2, 4) training rank's CE: 16 x 32 rows, a quarter of the 50k head
N_SH, V_SH = TB // 2 * TT, V // SHARD_N
SHARD_STEPS = 5
CLIP_NORM = 0.1  # the clip gate's max_grad_norm (SGD at lr 1: the clip sets each update)
SHARD_BOUNDS = {
    "scores vs one card": 1e-4,  # abs: only the lse merge's order differs
    "grads vs one card": 1e-3,   # of max |one card|, a step's LSTM gradient
    "clip step vs one card": 1e-3,  # of max |one card|, an SGD step's LSTM update
}
SHARD_FAULTS = ("dh summed twice", "dh never summed", "owner map off by one block",
                "clip on the rank-local norm")
EXPS.update({  # a rank's quarter of the head over its group's rows; the CE's logits
    **{f"project_lse dsoftmax int8 {tag} shard": rows * sum(n for n, _ in blocks) // SHARD_N
       for tag, (rows, blocks) in SHARD_ROWS.items()},
    f"ce_fwd bf16 V{V_SH}": N_SH * V_SH})
BOUNDS.update({f"project_lse dsoftmax int8 {tag} shard": BOUNDS["project_lse dsoftmax int8"]
               for tag in SHARD_ROWS})
BOUNDS.update({f"{k} {cd} V{V_SH}": BOUNDS[f"{k} {cd}"]
               for k in ("ce_fwd", "ce_bwd_dh", "ce_bwd_dw") for cd in ("bf16", "fp32")})


def config3():
    """BASELINE config 3: V 50,000 (the bench's vocab), E 256, H 512, the
    D-softmax prefix head, int8-MXU, beam 10, vocab sharded 4 ways."""
    from jlm_tpu_torch.config import Config, default_dsoftmax_blocks

    cfg = Config(vocab_size=V, embed_size=E, hidden_size=H, num_layers=1, head="dsoftmax",
                 dsoftmax=default_dsoftmax_blocks(V, H), beam_width=10, n_best_max=1,
                 seed=0, mesh_vocab=SHARD_N)
    check(tuple(zip(cfg.dsoftmax.block_sizes, cfg.dsoftmax.block_dims)) == BLOCKS3,
          f"config 3's blocks {cfg.dsoftmax}")
    return cfg


def bench_data3():
    """Config 3's config, the bench's vocab and lexicon, weights, int8."""
    from jlm_tpu_torch.data import Lexicon, build_vocab, generate_corpus
    from jlm_tpu_torch.models.params import init_params
    from jlm_tpu_torch.ops.quant import quantize_params

    config = config3()
    vocab = build_vocab(generate_corpus(2000, seed=1234), V)
    params = init_params(config)
    return config, vocab, Lexicon.from_vocab(vocab), params, quantize_params(params)


def shard_cases(dev, rng):
    """The kernels at a rank's shapes under vocab sharding (phase 3f).
    ``project_lse`` int8-MXU on one rank's quarter of config 3's and config
    5's D-softmax blocks (2,000 x 512, 4,250 x 256, 6,250 x 128; 4,000 x
    512, 8,500 x 256, 12,500 x 128) over the rows its vocab group sees, its
    ``(m, s)`` merged with the other three ranks' partials (plain, made
    once) into the global lse, as ``_make_sharded_kernel_forward`` merges
    them; wrong: one block's columns taken one slice on (the next rank's),
    one rank's ``s`` dropped from the merge.  The fused CE's three kernels,
    bf16 and fp32, at a (2, 4) training rank's shapes: 512 rows, D 512,
    12,500 columns, three quarters of the targets -1 (another rank's), the
    backward from a global lse above the local one; wrong as phase 2's."""
    from jlm_tpu_torch.config import Config, DSoftmaxConfig
    from jlm_tpu_torch.ops.project import project_ms, project_ms_ref
    from jlm_tpu_torch.ops.quant import quantize_weight
    from jlm_tpu_torch.ops.softmax_ce import (
        cast_wt, ce_bwd_dh, ce_bwd_dh_ref, ce_bwd_dw, ce_bwd_dw_ref, ce_fwd_raw, ce_fwd_raw_ref)

    bf = torch.bfloat16

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev).to(dtype)

    cases = []
    for tag, (rows, blocks) in SHARD_ROWS.items():
        cfg = Config(vocab_size=sum(n for n, _ in blocks), hidden_size=H, head="dsoftmax",
                     dsoftmax=DSoftmaxConfig(tuple(n for n, _ in blocks),
                                             tuple(d for _, d in blocks), "prefix"))
        full = []
        for n, d in blocks:
            q = quantize_weight(rng.normal(0, 0.05, (d, n)).astype(np.float32), axis=0)
            full.append((torch.from_numpy(q["q"]).to(dev), t(q["scale"]), t(rng.normal(0, 0.1, n))))

        def shard(v, shifted=None):
            out = []
            for k, ((q, sc, b), (n, _)) in enumerate(zip(full, blocks)):
                sl = n // SHARD_N
                lo = ((v + (k == shifted)) % SHARD_N) * sl
                qk = q[:, lo:lo + sl].contiguous()
                out.append({"W": {"q": qk, "scale": sc[lo:lo + sl].contiguous()},
                            "b": b[lo:lo + sl].contiguous(), "WT": qk.t().contiguous()})
            return {"blocks": out}

        heads = [shard(v) for v in range(SHARD_N)]
        wrong_head = shard(0, shifted=1)
        h = t(rng.uniform(-1, 1, (rows, H)), bf)
        kw = dict(compute_dtype=bf, int8_mxu=True)
        others = [project_ms_ref(h, heads[v], cfg, **kw) for v in range(1, SHARD_N)]

        def merged(ms0, drop=None, others=others):
            parts = [ms0] + others
            m_all = torch.cat([m for m, _ in parts], dim=1)
            m_g = m_all.amax(dim=1, keepdim=True)
            s_g = sum(s * torch.exp(m - m_g) for i, (m, s) in enumerate(parts) if i != drop)
            return m_g + torch.log(s_g)

        cases.append((
            f"project_lse dsoftmax int8 {tag} shard",
            lambda h=h, hd=heads[0], cfg=cfg, mg=merged: mg(project_ms(h, hd, cfg, **kw)),
            lambda h=h, hd=heads[0], cfg=cfg, mg=merged: mg(project_ms_ref(h, hd, cfg, **kw)),
            abs_errs,
            {"the second block's columns one slice on": lambda h=h, cfg=cfg, mg=merged,
             wh=wrong_head: mg(project_ms_ref(h, wh, cfg, **kw)),
             "one rank's s dropped from the merge": lambda h=h, hd=heads[0], cfg=cfg,
             mg=merged: mg(project_ms_ref(h, hd, cfg, **kw), drop=SHARD_N - 1)},
            None))
    # the fused CE at a training rank's quarter of the 50k head
    h_sh = t(rng.uniform(-1, 1, (N_SH, H)))
    b_sh = t(rng.normal(0, 0.1, V_SH))
    y_sh = torch.from_numpy(np.where(rng.random(N_SH) < 0.75, -1,
                                     rng.integers(0, V_SH, N_SH))).to(dev)
    ga = torch.full((N_SH,), 1.0 / N_SH, device=dev)
    for cd, scale in ((bf, 0.05), (torch.float32, PEAKED)):
        name = "bf16" if cd == bf else "fp32"
        W_sh = t(rng.normal(0, scale, (H, V_SH)))
        wt = cast_wt(W_sh, H) if cd == bf else None
        m, s = ce_fwd_raw_ref(h_sh, W_sh, b_sh, y_sh, cd)[:2]
        lse = m + torch.log(s) + math.log(SHARD_N)  # the other ranks' share
        args = (h_sh, W_sh, b_sh, y_sh, lse, ga, -ga, cd)
        wrong = (h_sh, W_sh, b_sh, y_sh, lse + P_SHIFT, ga, -ga, cd)

        def no_bias_t(W=W_sh, cd=cd):
            m, s, t_ = ce_fwd_raw_ref(h_sh, W, b_sh, y_sh, cd)
            own = (y_sh >= 0) & (y_sh < V_SH)
            return m, s, t_ - torch.where(own, b_sh[y_sh.clamp(0, V_SH - 1)], 0.0)

        cases.append((f"ce_fwd {name} V{V_SH}",
                      lambda W=W_sh, cd=cd, wt=wt: ce_fwd_raw(h_sh, W, b_sh, y_sh, cd, wt=wt),
                      lambda W=W_sh, cd=cd: ce_fwd_raw_ref(h_sh, W, b_sh, y_sh, cd), ce_fwd_err,
                      {"the target logit without its bias": no_bias_t}, None))
        for k, kern, ref in (("ce_bwd_dh", ce_bwd_dh, ce_bwd_dh_ref),
                             ("ce_bwd_dw", ce_bwd_dw, ce_bwd_dw_ref)):
            cases.append((f"{k} {name} V{V_SH}",
                          lambda kern=kern, a=args, wt=wt: kern(*a, wt=wt),
                          lambda ref=ref, a=args: ref(*a), bwd_err,
                          {f"a p-term {1 - math.exp(-P_SHIFT):.0%} low":
                           lambda ref=ref, a=wrong: ref(*a)}, None))
    return cases


def shard_work():
    """``work()``'s entries of ``shard_cases``: a rank's head quarter over
    its group's rows (int8), the CE at a rank's 512 rows and 12,500 columns."""
    out = {}
    for tag, (rows, blocks) in SHARD_ROWS.items():
        words, weights = sum(n for n, _ in blocks) // SHARD_N, sum(n * d for n, d in blocks)
        out[f"project_lse dsoftmax int8 {tag} shard"] = (
            rows * H * 2 + weights // SHARD_N + words * 8 + rows * 4 * 3,
            2 * rows * weights // SHARD_N, "int8")
    for cd in ("bf16", "fp32"):
        out.update({f"{k} {cd} V{V_SH}": v for k, v in ce_work(N_SH, H, V_SH, cd).items()})
    return out


@contextlib.contextmanager
def shard_fault(fault):
    """One planted fault of ``SHARD_FAULTS`` in this rank's process."""
    from jlm_tpu_torch.parallel import comm
    from jlm_tpu_torch.parallel import sharded_head as sh
    from jlm_tpu_torch.parallel import train_step as ts
    from jlm_tpu_torch.train import optim

    keep = sh._reduce_dh, sh._ce_blocks, ts.global_norm
    if fault == "dh summed twice":
        sh._reduce_dh = lambda dh, g: comm.all_reduce_sum(comm.all_reduce_sum(dh, g), g)
    elif fault == "dh never summed":
        sh._reduce_dh = lambda dh, g: dh
    elif fault == "owner map off by one block":
        blocks = keep[1]
        sh._ce_blocks = lambda cfg, mesh: [
            (st, d, lo + (s if mesh.vocab_index + 1 < mesh.vocab else -s * (mesh.vocab - 1)), s)
            for st, d, lo, s in blocks(cfg, mesh)]
    elif fault == "clip on the rank-local norm":
        ts.global_norm = lambda g, mesh: optim.global_norm([g[k] for k in sorted(g)])
    elif fault is not None:
        raise ValueError(fault)
    try:
        yield
    finally:
        sh._reduce_dh, sh._ce_blocks, ts.global_norm = keep


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def shard_train_config():
    """Phase 5's training config on the (2, 4) mesh."""
    return bench_config().replace(batch_size=TB, num_steps=TT, fused_ce=True, mesh_data=2,
                                  mesh_vocab=SHARD_N)


def first_step(trainer, ids, sgd: bool):
    """One training step on the first window, on a mesh or one card: the
    global mean loss and either the gradient of ``lstm/0/W`` (data-synced
    on a mesh; nothing applied) or, with ``sgd``, its update after one call
    of the step; the tensor on the last rank only (None elsewhere): the
    rank of the rarest words' columns, which hold the least of the head's
    gradient, so a rank-local norm differs most from the tree's there."""
    from jlm_tpu_torch.models.lstm import initial_state
    from jlm_tpu_torch.parallel import comm
    from jlm_tpu_torch.parallel import train_step as ts

    mesh = trainer.mesh
    x, y = next(iter(trainer._windows(ids)))
    state = initial_state(trainer.config, trainer.rows, trainer.device)
    if sgd:
        before = trainer.flat["lstm/0/W"].detach().clone()
        _, loss = trainer._train_step(state, x, y, trainer.config.learning_rate)
        out = trainer.flat["lstm/0/W"].detach() - before
    else:
        if mesh is not None:
            x, y = trainer._rows(x), trainer._rows(y)
        loss, _ = trainer._loss(trainer.params, x, y, state)
        g = torch.autograd.grad(loss, [trainer.flat["lstm/0/W"]])[0]
        if trainer.seq:  # a rank's share: summed over the seq group
            g = ts.seq_sum_grads({"k": g}, mesh)["k"]
            loss = comm.all_reduce_sum(loss.detach(), mesh.group)
        elif mesh is not None:
            g, loss = ts.sync_grads({"k": g}, mesh)["k"], ts.data_mean(loss.detach(), mesh)
        out = g
    return float(loss.detach()), out.cpu() if mesh is None or mesh.rank == mesh.world - 1 else None


def one_card_refs(dev, params, train_ids):
    """Phase 5's training config on this card alone: the first window's
    loss and ``lstm/0/W`` gradient, a clipped SGD step's update of it
    (``first_step``), and the window's final carries; what phases 3f and
    3g hold their ranks to."""
    from jlm_tpu_torch.models.lstm import initial_state
    from jlm_tpu_torch.train import Trainer

    tcfg = shard_train_config()
    sgd = tcfg.replace(optimizer="sgd", learning_rate=1.0, max_grad_norm=CLIP_NORM)
    trainer = Trainer(tcfg, params, device=dev)
    x, y = next(iter(trainer._windows(train_ids)))
    with torch.no_grad():
        _, carries = trainer._loss(trainer.params, x, y,
                                   initial_state(tcfg, trainer.rows, dev))
    return {"grads": first_step(trainer, train_ids, False),
            "clip": first_step(Trainer(sgd, params, device=dev), train_ids, True),
            "carries": tuple(c.cpu() for c in carries)}


def shard_run(dev, card, kanas, stream, train_ids, ref, loss_k, results5, oracle5_q):
    """Phase 3f: config 3 on a (1, 4) world and config 5 with the training
    step on a (2, 4) world, every rank on this card (Gloo), against the
    one-card references (``ref``: ``one_card_refs``).  Returns the launches
    for the ``kernels`` line (rank 0's; every rank's are checked)."""
    from jlm_tpu_torch.decoder.engine import BeamDecoder
    from jlm_tpu_torch.decoder.suggest import Suggester
    from jlm_tpu_torch.oracle import OracleDecoder, OracleLM
    from jlm_tpu_torch.parallel.comm import spawn

    t_ref = time.perf_counter()
    cfg3, vocab3, lex3, p3, qp3 = bench_data3()
    one3 = BeamDecoder(qp3, lex3, vocab3, cfg3, precision="default",
                       device=dev).decode_batch(stream)
    orc3 = OracleDecoder(OracleLM(qp3, cfg3), lex3, vocab3, cfg3)
    oracle3 = [orc3.decode(k)[0] for k in kanas]
    g3 = cfg3.replace(beam_width=1)
    orc3g = OracleDecoder(OracleLM(peaked(p3), g3), lex3, vocab3, g3)
    oracle3g = [orc3g.decode(k)[0] for k in kanas]
    contexts = [[5, 6], [17, 3, 40], [2], []]
    sugs = {"c3": [Suggester(p3, vocab3, cfg3, device=dev).top_k(c, 5) for c in contexts]}
    del qp3, orc3, orc3g
    _, vocab5, _, p5, _ = bench_data5()
    sugs["c5"] = [Suggester(p5, vocab5, config5(), device=dev).top_k(c, 5) for c in contexts]
    del p5
    torch.cuda.empty_cache()
    log(f"phase 3f one-card references: {time.perf_counter() - t_ref:.1f} s")

    t0 = time.perf_counter()
    w3 = spawn(shard_rank, SHARD_N, device="cuda", args=(("c3",), stream, kanas, contexts, None))
    t_w3 = time.perf_counter() - t0
    w8 = spawn(shard_rank, 2 * SHARD_N, device="cuda",
               args=(("c5", "train"), stream, kanas, contexts, train_ids))
    log(f"phase 3f worlds: 4 ranks {t_w3:.1f} s, 8 ranks {time.perf_counter() - t0 - t_w3:.1f} s "
        "(spawns included)")
    for world in (w3, w8):
        check(all(r["modules"] == [] for r in world), "a rank imported jax or the JAX package")
    log(f"Gloo all_reduce MAX on CUDA tensors equals the max of the gathered values: "
        f"{[r[t]['max_probe'] for r in w3 + w8 for t in r if t in ('c3', 'c5')]}")
    check(all(r[t]["max_probe"] for r in w3 + w8 for t in r if t in ("c3", "c5")),
          "all_reduce MAX on CUDA tensors differs from the gathered max")
    check(all(r[t]["broadcast_probe"] for r in w3 + w8 for t in r if t in ("c3", "c5")),
          "Gloo broadcast of a CUDA tensor differs from rank 0's gathered copy")

    def same(got, want, tol):
        return all(g[0] == w[0].segments and abs(g[1] - w[0].score) <= tol
                   for g, w in zip(got, want))

    def same_top5(got, want):
        return all(g[0] == w[0] and np.allclose(g[1], w[1], atol=1e-4, rtol=0)
                   for g, w in zip(got, want))

    for tag, world, one, oracle, layers in (("c3", w3, one3, oracle3, 1),
                                            ("c5", w8, results5, oracle5_q, 2)):
        r0 = world[0][tag]
        n = sum(g[0] == o.segments for g, o in zip(r0["results"], oracle))
        fwd = r0["forwards"]
        log(f"phase 3f {tag} on {len(world)} ranks (one card, Gloo): top-1 {n}/{len(kanas)} vs "
            f"the int8 oracle; n-best vs the one-card kernel forward: "
            f"{sum(g[0] == w[0].segments for g, w in zip(r0['results'], one))}/{len(one)} "
            f"paths, max |score diff| "
            f"{max(abs(g[1] - w[0].score) for g, w in zip(r0['results'], one)):.3e}; "
            f"{r0['ms']:.1f} ms a 2,048-lattice chunk ({len(world)} ranks on one card, "
            f"{card}); launches per rank {[r[tag]['launches'] for r in world][:2]}...; "
            f"{r0['seconds']:.1f} s in the world")
        check(n == len(kanas), f"phase 3f {tag}: top-1 vs the int8 oracle")
        check(same(r0["results"], one, SHARD_BOUNDS["scores vs one card"]),
              f"phase 3f {tag}: n-best vs the one-card kernel forward")
        check(len({r[tag]["digest"] for r in world}) == 1, f"phase 3f {tag}: ranks disagree")
        want = {"project_lse": fwd * 3, "lstm_cell_step": fwd * layers, "cand_dot": fwd}
        check(all(r[tag]["launches"] == want for r in world),
              f"phase 3f {tag}: launches {[r[tag]['launches'] for r in world]}, expected {want}")
        check(all(same_top5(r[tag]["suggest"], sugs[tag]) for r in world),
              f"phase 3f {tag}: the sharded suggester's top 5")
        check(all(r[tag]["topk_equal"] for r in world), f"phase 3f {tag}: sharded_topk ties")
    g32 = w3[0]["c3"]["greedy32"]
    n = sum(g[0] == o.segments for g, o in zip(g32, oracle3g))
    worst = max(abs(g[1] - o.score) for g, o in zip(g32, oracle3g))
    log(f"phase 3f c3 greedy fp32 kernel forward, PEAKED head: {n}/{len(kanas)} vs the fp32 "
        f"oracle, max |score - oracle| {worst:.3e}")
    check(n == len(kanas) and worst <= 1e-3, "phase 3f c3 greedy fp32 parity")

    tr = [r["train"] for r in w8]
    losses = tr[0]["losses"]
    step1, last = abs(losses[0] - loss_k[0]), abs(losses[-1] / loss_k[SHARD_STEPS - 1] - 1)
    log(f"phase 3f training (2, 4): losses {[round(l, 6) for l in losses]} vs one card "
        f"{[round(float(l), 6) for l in loss_k[:SHARD_STEPS]]}: step 1 diff {step1:.3e}, step "
        f"{SHARD_STEPS} rel diff {last:.3e} (bounds {TRAIN_BOUNDS}); {tr[0]['ms']:.2f} ms/step "
        f"(8 ranks on one card, {card}); CE launches per rank {tr[0]['launches']}")
    check(step1 <= TRAIN_BOUNDS["step 1 loss"] and last <= TRAIN_BOUNDS["last loss"],
          "phase 3f: sharded training losses vs one card")
    check(all(t["losses"] == losses for t in tr), "phase 3f: ranks' losses differ")
    check(all(t["launches"] == dict(ce_fwd_raw=SHARD_STEPS, ce_bwd_dh=SHARD_STEPS,
                                    ce_bwd_dw=SHARD_STEPS, cast_wt=SHARD_STEPS) for t in tr),
          f"phase 3f: CE launches {[t['launches'] for t in tr]}: one a rank, block and step")

    def gate(kind, fault):
        loss, got = tr[-1][(kind, fault)]
        loss1, want = ref[kind]
        err = float((got - want).abs().max() / want.abs().max())
        bound = SHARD_BOUNDS["grads vs one card" if kind == "grads" else "clip step vs one card"]
        ok = err <= bound and abs(loss - loss1) <= TRAIN_BOUNDS["step 1 loss"]
        log(f"  phase 3f {kind} gate, {fault or 'no fault'}: rel err {err:.3e} (bound {bound:g}), "
            f"loss diff {abs(loss - loss1):.3e}")
        return ok

    check(gate("grads", None) and gate("clip", None), "phase 3f: the step vs one card")
    for fault in SHARD_FAULTS:
        kind = "clip" if fault.startswith("clip") else "grads"
        check(not gate(kind, fault), f"phase 3f: the gates miss {fault}")
    return {"project_lse dsoftmax int8 c3 shard": w3[0]["c3"]["launches"]["project_lse"],
            "project_lse dsoftmax int8 c5 shard": w8[0]["c5"]["launches"]["project_lse"],
            **{f"{k} bf16 V{V_SH}": tr[0]["launches"][fn] for k, fn in (
                ("ce_fwd", "ce_fwd_raw"), ("ce_bwd_dh", "ce_bwd_dh"), ("ce_bwd_dw", "ce_bwd_dw"))}}


def shard_train(mesh, train_ids):
    """Phase 3f's training on this rank: ``SHARD_STEPS`` fused-CE Adam
    steps at phase 5's width (losses, ms, CE launches), then the gates'
    single steps, good and with each planted fault."""
    from jlm_tpu_torch.ops import softmax_ce as ce
    from jlm_tpu_torch.parallel import comm
    from jlm_tpu_torch.train import Trainer

    tcfg = shard_train_config()
    counters = (ce.ce_fwd_raw, ce.ce_bwd_dh, ce.ce_bwd_dw, ce.cast_wt)
    trainer = Trainer(tcfg, mesh=mesh)
    comm.barrier()
    for fn in counters:
        fn.launches = 0
    steps = trainer.train_steps(train_ids, epoch=0)
    losses = [next(steps)[0]]
    sync(mesh.device)
    t0 = time.perf_counter()
    losses += [next(steps)[0] for _ in range(SHARD_STEPS - 1)]
    sync(mesh.device)
    ms = (time.perf_counter() - t0) * 1e3 / (SHARD_STEPS - 1)
    out = {"losses": [float(l) for l in losses], "ms": ms,
           "launches": {fn.__name__: fn.launches for fn in counters}}
    del trainer, steps
    sgd = tcfg.replace(optimizer="sgd", learning_rate=1.0, max_grad_norm=CLIP_NORM)
    for fault in (None,) + SHARD_FAULTS:
        with shard_fault(fault):
            if fault is None or not fault.startswith("clip"):
                out[("grads", fault)] = first_step(Trainer(tcfg, mesh=mesh), train_ids, False)
            if fault is None or fault.startswith("clip"):
                out[("clip", fault)] = first_step(Trainer(sgd, mesh=mesh), train_ids, True)
    return out


def shard_serve(mesh, which, stream, kanas, contexts):
    """Phase 3f's serving on this rank: ``stream`` (one 2,048-lattice
    chunk) through the sharded kernel forward (int8-MXU, bf16) twice, the
    second counted and timed; with config 3 also the fp32 kernel forward
    greedy on ``PEAKED`` heads; the suggester's top 5; ``sharded_topk`` on
    planted ties; the MAX and broadcast probes."""
    from jlm_tpu_torch.decoder.engine import BeamDecoder, topk_stable
    from jlm_tpu_torch.decoder.suggest import Suggester
    from jlm_tpu_torch.ops.cand_dot import cand_dot
    from jlm_tpu_torch.ops.lstm_cell import lstm_cell_step
    from jlm_tpu_torch.ops.project import project_lse
    from jlm_tpu_torch.parallel import comm, make_sharded_forward, sharded_topk
    from jlm_tpu_torch.parallel.sharded_head import local_ids

    cfg, vocab, lexicon, params, qp = bench_data3() if which == "c3" else bench_data5()
    cfg = cfg.replace(mesh_data=mesh.data, mesh_vocab=mesh.vocab)
    out = {}
    probe = torch.arange(4, device=mesh.device, dtype=torch.float32) * (mesh.rank + 1) - mesh.rank
    out["max_probe"] = bool(torch.equal(comm.all_reduce_max(probe),
                                        comm.all_gather(probe).amax(dim=0)))
    out["broadcast_probe"] = bool(torch.equal(comm.broadcast(probe), comm.all_gather(probe)[0]))
    eng = BeamDecoder(qp, lexicon, vocab, cfg, forward_fn=make_sharded_forward(mesh, cfg))
    eng.decode_batch(stream)  # warm-up
    counters = (project_lse, lstm_cell_step, cand_dot)
    sync(mesh.device)
    comm.barrier()
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    res = eng.decode_batch(stream)
    out["ms"] = (time.perf_counter() - t0) * 1e3
    out["launches"] = {fn.__name__: fn.launches for fn in counters}
    out["forwards"] = min(eng._t_bucket(max(len(k) for k in stream)), cfg.max_kana_len) + 1
    flat = [(r[0].segments, r[0].score) for r in res]
    out["digest"] = hashlib.sha256(repr(flat).encode()).hexdigest()
    if mesh.rank == 0:
        out["results"] = flat
    del eng
    if which == "c3":
        greedy = cfg.replace(beam_width=1)
        eng32 = BeamDecoder(peaked(params), lexicon, vocab, greedy,
                            forward_fn=make_sharded_forward(mesh, greedy,
                                                            compute_dtype=torch.float32))
        res32 = eng32.decode_batch(kanas)
        out["greedy32"] = [(r[0].segments, r[0].score) for r in res32] if mesh.rank == 0 else None
        del eng32
    sug = Suggester(params, vocab, cfg, mesh=mesh)
    out["suggest"] = [sug.top_k(c, 5) for c in contexts]
    ties = torch.from_numpy(np.random.default_rng(11).integers(0, 8, (4, cfg.vocab_size))
                            .astype(np.float32)).to(mesh.device)
    ids = local_ids(cfg, mesh).to(mesh.device)
    got = sharded_topk(mesh, ties[:, ids], 10, ids)
    want = topk_stable(ties, 10)
    out["topk_equal"] = bool(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))
    return out


def shard_rank(device, tasks, stream, kanas, contexts, train_ids):
    """One rank of a phase-3f world: ``tasks`` from ("c3", "c5", "train")."""
    from jlm_tpu_torch.config import Config
    from jlm_tpu_torch.parallel import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shape = (1, SHARD_N) if "c3" in tasks else (2, SHARD_N)
    mesh = make_mesh(Config(mesh_data=shape[0], mesh_vocab=shape[1]), device)
    out = {}
    for task in tasks:
        t0 = time.perf_counter()
        out[task] = (shard_train(mesh, train_ids) if task == "train"
                     else shard_serve(mesh, task, stream, kanas, contexts))
        out[task]["seconds"] = time.perf_counter() - t0
    out["modules"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jlm_tpu"))
    return out


# ---- the time-block pipeline (phase 3g) and trained config 5 (phase 3h) ----
# phase 3g: phase 5's training at mesh_seq = SEQ_P, M = SEQ_M pipeline
# microbatches (every rank on this card, Gloo); a stage's CE rows: the
# batch times its time block, 32 x 8 = 256
SEQ_P, SEQ_M, SEQ_STEPS = 4, 8, 5
N_SEQ = TB * TT // SEQ_P
SEQ_FAULTS = ("the carry cotangent never passed left", "gradients averaged over the seq group",
              "the halo read from slot p + 1")
SEQ_BOUNDS = {"carries vs one card": 1e-5}  # abs, c and h after the first window
# the --mesh-seq CLI's corpus (python -m jlm_tpu_torch.scripts.prepare_data
# --stream --dev-frac 0.1): 9 training windows of 32 x 32 and one dev window
SEQ_CLI_SENTENCES = 2_000
SEQ_CLI_PREP = ["--vocab-size", str(V), "--dev-frac", "0.1"]
# phase 3h: scripts/quality_stats.py's config 5 (2 layers, E 256, H 512, the
# 100k D-softmax head) cut to one seed, 2 epochs over 8,000 sentences at
# batch 32 (N_CE CE rows a step), 200 tests (the 300 model-selection
# sentences kept)
QS_SEED = 3
QS_ARGS = ["--sentences", "8000", "--tests", "200", "--seeds",
           str(QS_SEED), "--epochs", "2", "--batch-size", str(TB), "--fused-ce",
           "--skip-baselines"]
QS_GATED = 50  # test sentences held to the oracles
# the decode's shapes there: 200 sentences bucket to 256, beam 10
QS_S = 256
R_QS = QS_S * B
QS_CELLS = (E, H)  # the cell's input width at layer 0 and 1
EXPS.update({
    f"ce_fwd bf16 N{N_SEQ}": N_SEQ * V,
    **{f"ce_fwd bf16 c5 b{k}": N_CE * n for k, (n, _) in enumerate(BLOCKS5[:2])},
    f"project_lse dsoftmax bf16 R{R_QS}": R_QS * V5})
BOUNDS.update({f"{k} bf16 N{N_SEQ}": BOUNDS[f"{k} bf16"] for k in CE_COUNTERS})
BOUNDS.update({f"{k} bf16 c5 b{i}": BOUNDS[f"{k} bf16"]
               for k in CE_COUNTERS for i in range(len(BLOCKS5))})
BOUNDS.update({f"project_lse dsoftmax bf16 R{R_QS}": BOUNDS["project_lse dsoftmax bf16"],
               **{f"lstm_cell_step bf16 R{R_QS} E{e}": BOUNDS["lstm_cell_step bf16"]
                  for e in QS_CELLS},
               f"cand_dot bf16 S{QS_S}": BOUNDS["cand_dot bf16"]})


def seq_qs_cases(dev, rng):
    """The kernels at phase 3g's and 3h's shapes, as kernel_cases' cases.
    The fused CE's three bf16 kernels at a pipeline stage's rows (N_SEQ x
    the 50k head, D 512, every target owned) and at config 5's D-softmax
    blocks over a step's N_CE rows (16,000 x 512, 34,000 x 256; the third
    block's forward is phase 2's ``ce_fwd bf16 D128``), two thirds of a
    block's targets another block's (-1), the backward from an lse above
    the block's own; wrong as phase 2's.  The decode kernels at
    quality_stats' beam-10 chunk (256 sentences, R_QS rows): the bf16
    D-softmax head (wrong: the second warpgroup's rows from the first's),
    the bf16 cell at each layer's input width (wrong: gates j and f
    swapped), ``cand_dot`` (wrong: beam rows 8 on from rows 0 on)."""
    from jlm_tpu_torch.ops.cand_dot import cand_dot, cand_dot_ref
    from jlm_tpu_torch.ops.lstm_cell import cell_weight_tiles, lstm_cell_ref, lstm_cell_step
    from jlm_tpu_torch.ops.project import project_lse, project_lse_ref
    from jlm_tpu_torch.ops.softmax_ce import (
        cast_wt, ce_bwd_dh, ce_bwd_dh_ref, ce_bwd_dw, ce_bwd_dw_ref, ce_fwd_raw, ce_fwd_raw_ref)

    bf = torch.bfloat16

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev).to(dtype)

    def ce_cases(tag, N, Vb, D, owned, fwd=True):
        h = t(rng.uniform(-1, 1, (N, D)))
        W, b = t(rng.normal(0, 0.05, (D, Vb))), t(rng.normal(0, 0.1, Vb))
        y = torch.from_numpy(np.where(rng.random(N) < owned, rng.integers(0, Vb, N), -1)).to(dev)
        wt = cast_wt(W, D)
        m, s = ce_fwd_raw_ref(h, W, b, y, bf)[:2]
        lse = m + torch.log(s) + (0.0 if owned == 1.0 else math.log(3.0))
        ga = torch.full((N,), 1.0 / N, device=dev)
        args = (h, W, b, y, lse, ga, -ga, bf)
        wrong = (h, W, b, y, lse + P_SHIFT, ga, -ga, bf)
        out = []
        if fwd:
            def no_bias_t():
                m, s, t_ = ce_fwd_raw_ref(h, W, b, y, bf)
                own = (y >= 0) & (y < Vb)
                return m, s, t_ - torch.where(own, b[y.clamp(0, Vb - 1)], 0.0)

            out.append((f"ce_fwd bf16 {tag}", lambda: ce_fwd_raw(h, W, b, y, bf, wt=wt),
                        lambda: ce_fwd_raw_ref(h, W, b, y, bf), ce_fwd_err,
                        {"the second warpgroup's rows from the first's":
                         lambda: ce_fwd_raw_ref(second_half_fault(h, 64), W, b, y, bf),
                         "the target logit without its bias": no_bias_t}, None))
        for k, kern, ref in (("ce_bwd_dh", ce_bwd_dh, ce_bwd_dh_ref),
                             ("ce_bwd_dw", ce_bwd_dw, ce_bwd_dw_ref)):
            wrongs = {f"a p-term {1 - math.exp(-P_SHIFT):.0%} low": lambda r=ref: r(*wrong)}
            wrongs.update(ce_bwd_traps(k, args))
            out.append((f"{k} bf16 {tag}", lambda kern=kern: kern(*args, wt=wt),
                        lambda ref=ref: ref(*args), bwd_err, wrongs, None))
        return out

    cases = ce_cases(f"N{N_SEQ}", N_SEQ, V, H, 1.0)
    for k, (n, d) in enumerate(BLOCKS5):
        cases += ce_cases(f"c5 b{k}", N_CE, n, d, 1 / 3, fwd=k < 2)

    cfg = config5()
    blocks = []
    for n, d in BLOCKS5:
        Wb = t(rng.normal(0, 0.05, (d, n)), bf)
        blocks.append({"W": Wb, "b": t(rng.normal(0, 0.1, n)), "WT": Wb.t().contiguous()})
    head = {"blocks": blocks}
    h = t(rng.uniform(-1, 1, (R_QS, H)), bf)
    cases.append((f"project_lse dsoftmax bf16 R{R_QS}",
                  lambda: project_lse(h, head, cfg, compute_dtype=bf),
                  lambda: project_lse_ref(h, head, cfg, compute_dtype=bf), abs_errs,
                  {"the second warpgroup's rows from the first's":
                   lambda: project_lse_ref(second_half_fault(h, 64), head, cfg,
                                           compute_dtype=bf)}, None))
    hc, cc = t(rng.uniform(-1, 1, (R_QS, H)), bf), t(rng.normal(0, 1.0, (R_QS, H)), bf)
    for e in QS_CELLS:
        x = t(rng.normal(0, 0.3, (R_QS, e)), bf)
        Wc, bc = t(rng.normal(0, 0.05, (e + H, 4 * H)), bf), t(rng.normal(0, 0.1, 4 * H))
        cell_weight_tiles(Wc, e, H)
        w_ih, w_hh, b_ih = torch_gates(Wc, bc)

        def plain(x=x, W=Wc, b=bc):
            c_new, h_new = lstm_cell_ref(x, hc, cc, W, b, 1.0)
            return c_new.to(bf), h_new.to(bf)

        cases.append((f"lstm_cell_step bf16 R{R_QS} E{e}",
                      lambda x=x, W=Wc, b=bc: lstm_cell_step(x, hc, cc, W, b, 1.0,
                                                              compute_dtype=bf, c_out_dtype=bf),
                      plain, cell_err,
                      {"gates j and f swapped (a gate-tile mapping fault)":
                       lambda plain=plain, W=Wc, b=bc: plain(W=swap_jf(W), b=swap_jf(b))},
                      lambda x=x, w_ih=w_ih, w_hh=w_hh, b_ih=b_ih: torch.lstm_cell(
                          x, (hc, cc), w_ih, w_hh, b_ih.to(bf), torch.zeros_like(b_ih, dtype=bf))))
    h3 = t(rng.uniform(-1, 1, (QS_S, B, H)), bf)
    cols, cbias = t(rng.normal(0, 0.05, (QS_S, C1, H)), bf), t(rng.normal(0, 0.1, (QS_S, C1)))
    cases.append((f"cand_dot bf16 S{QS_S}", lambda: cand_dot(h3, cols, cbias),
                  lambda: cand_dot_ref(h3, cols, cbias), cand_err,
                  {"beam rows 8 on read from rows 0 on (the m16 tile's second half)":
                   lambda: cand_dot_ref(second_half_rows(h3), cols, cbias)},
                  lambda: torch.baddbmm(cbias.to(bf)[:, None, :], h3, cols.transpose(1, 2))))
    return cases


def seq_qs_work():
    """``work()``'s entries of ``seq_qs_cases``, by kernels-line name."""
    out = {f"{k} bf16 N{N_SEQ}": v for k, v in ce_work(N_SEQ, H, V, "bf16").items()}
    for i, (n, d) in enumerate(BLOCKS5):
        out.update({f"{k} bf16 c5 b{i}": v for k, v in ce_work(N_CE, d, n, "bf16").items()})
    out[f"project_lse dsoftmax bf16 R{R_QS}"] = (R_QS * H * 2 + HEAD5 * 2 + V5 * 4 + R_QS * 4,
                                                 2 * R_QS * HEAD5, "bf16")
    for e in QS_CELLS:
        out[f"lstm_cell_step bf16 R{R_QS} E{e}"] = (
            R_QS * (e + 4 * H) * 2 + (e + H) * 4 * H * 2 + 4 * H * 4,
            2 * R_QS * (e + H) * 4 * H, "bf16")
    out[f"cand_dot bf16 S{QS_S}"] = (QS_S * B * H * 2 + QS_S * C1 * H * 2 + QS_S * C1 * 4
                                     + QS_S * B * C1 * 4, 2 * QS_S * B * C1 * H, "bf16")
    return out


def seq_train_config():
    """Phase 5's training config on a SEQ_P-stage seq mesh, SEQ_M microbatches."""
    return bench_config().replace(batch_size=TB, num_steps=TT, fused_ce=True, mesh_seq=SEQ_P,
                                  seq_microbatches=SEQ_M)


def halo_from_next_slot(x, group=None):
    """``comm.shift_right`` reading slot ``p + 1`` of the buffer (its own
    carry) instead of slot ``p`` (the carry of the rank before it)."""
    import torch.distributed as dist

    from jlm_tpu_torch.parallel import comm

    n, r = comm.group_size(group), comm.group_rank(group)
    buf = torch.zeros((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    if r + 1 < n:
        buf[r + 1] = x
    dist.all_reduce(buf, group=group)
    return buf[r + 1] if r + 1 < n else torch.zeros_like(x)


@contextlib.contextmanager
def seq_fault(fault):
    """One planted fault of ``SEQ_FAULTS`` in this rank's process."""
    from jlm_tpu_torch.parallel import comm
    from jlm_tpu_torch.parallel import train_step as ts

    keep = comm.shift_left, comm.shift_right, ts.seq_sum_grads
    if fault == SEQ_FAULTS[0]:
        comm.shift_left = lambda x, group=None: torch.zeros_like(x)
    elif fault == SEQ_FAULTS[1]:
        ts.seq_sum_grads = lambda g, mesh: {k: v / mesh.seq for k, v in keep[2](g, mesh).items()}
    elif fault == SEQ_FAULTS[2]:
        comm.shift_right = halo_from_next_slot
    elif fault is not None:
        raise ValueError(fault)
    try:
        yield
    finally:
        comm.shift_left, comm.shift_right, ts.seq_sum_grads = keep


def digest(tensors) -> str:
    return hashlib.sha256(b"".join(t.detach().cpu().numpy().tobytes() for t in tensors)
                          ).hexdigest()


def seq_rank(device, train_ids):
    """One rank of phase 3g's world: SEQ_STEPS fused-CE Adam steps of the
    pipeline (losses, ms, CE launches, a digest of the carries), the first
    window's carries, then the gates' single steps, good and with each
    planted fault."""
    from jlm_tpu_torch.config import Config
    from jlm_tpu_torch.models.lstm import initial_state
    from jlm_tpu_torch.models.params import init_params
    from jlm_tpu_torch.ops import softmax_ce as ce
    from jlm_tpu_torch.parallel import comm, make_seq_mesh
    from jlm_tpu_torch.train import Trainer, epoch_lr

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_seq_mesh(Config(mesh_seq=SEQ_P), device)
    tcfg = seq_train_config()
    params = init_params(tcfg)  # phase 5's weights (seed 0), drawn once for every trainer

    def trainer_of(cfg):
        return Trainer(cfg, params, mesh=mesh, device=mesh.device)

    counters = (ce.ce_fwd_raw, ce.ce_bwd_dh, ce.ce_bwd_dw, ce.cast_wt)
    trainer = trainer_of(tcfg)
    windows = iter(trainer._windows(train_ids))
    state = initial_state(tcfg, trainer.rows, mesh.device)
    comm.barrier()
    for fn in counters:
        fn.launches = 0
    for fn in counters[:3]:
        fn.shapes = {}
    losses = []
    for i in range(SEQ_STEPS):
        x, y = next(windows)
        state, loss = trainer._train_step(state, x, y, epoch_lr(tcfg, 0))
        losses.append(loss)
        if i == 0:
            sync(mesh.device)
            t0 = time.perf_counter()
    sync(mesh.device)
    out = {"losses": [float(l) for l in losses],
           "ms": (time.perf_counter() - t0) * 1e3 / (SEQ_STEPS - 1),
           "launches": {fn.__name__: fn.launches for fn in counters},
           "shapes": {fn.__name__: dict(fn.shapes) for fn in counters[:3]},
           "digest": digest(state)}
    del trainer
    first = trainer_of(tcfg)
    x, y = next(iter(first._windows(train_ids)))
    with torch.no_grad():
        _, carries = first._loss(first.params, x, y, initial_state(tcfg, first.rows, mesh.device))
    out["first digest"] = digest(carries)
    out["carries"] = tuple(c.cpu() for c in carries) if mesh.rank == SEQ_P - 1 else None
    sgd = tcfg.replace(optimizer="sgd", learning_rate=1.0, max_grad_norm=CLIP_NORM)
    for fault in (None,) + SEQ_FAULTS:
        with seq_fault(fault):
            out[("grads", fault)] = first_step(trainer_of(tcfg), train_ids, False)
    out[("clip", None)] = first_step(trainer_of(sgd), train_ids, True)
    out["modules"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jlm_tpu"))
    return out


def seq_cli(card):
    """The ``--mesh-seq`` entry point: a corpus file through ``python -m
    jlm_tpu_torch.scripts.prepare_data --stream`` and its in-memory path
    (vocab.tsv and ids bit-equal), then ``python -m jlm_tpu_torch.train
    --mesh-seq SEQ_P --fused-ce`` for one epoch on the streamed data dir
    (SEQ_P ranks on this card)."""
    from jlm_tpu_torch.data import generate_corpus
    from jlm_tpu_torch.data.io import load_dataset
    from jlm_tpu_torch.native import encoder_lib
    from jlm_tpu_torch.scripts import prepare_data
    from jlm_tpu_torch.train import checkpoint

    with tempfile.TemporaryDirectory() as tmp:
        corpus = os.path.join(tmp, "corpus.txt")
        with open(corpus, "w", encoding="utf-8") as f:
            f.write("\n".join(generate_corpus(SEQ_CLI_SENTENCES, seed=1234)) + "\n")
        streamed, mem, exp = (os.path.join(tmp, d) for d in ("streamed", "mem", "exp"))
        t0 = time.perf_counter()
        prepare_data.main(["--out", streamed, "--corpus", corpus, "--stream"] + SEQ_CLI_PREP)
        prepare_data.main(["--out", mem, "--corpus", corpus] + SEQ_CLI_PREP)
        with open(os.path.join(streamed, "vocab.tsv"), "rb") as a, \
                open(os.path.join(mem, "vocab.tsv"), "rb") as b:
            same_vocab = a.read() == b.read()
        (_, *ids_s), (_, *ids_m) = load_dataset(streamed), load_dataset(mem)
        same_ids = all(np.array_equal(a, b) for a, b in zip(ids_s, ids_m))
        log(f"phase 3g prepare_data --stream (native encoder: {encoder_lib.available()}) vs "
            f"in memory: vocab.tsv equal {same_vocab}, ids equal {same_ids} "
            f"({sum(len(a) for a in ids_s)} ids; {time.perf_counter() - t0:.1f} s)")
        check(same_vocab and same_ids, "prepare_data --stream differs from the in-memory path")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "jlm_tpu_torch.train", "--data", streamed, "--exp", exp,
             "--mesh-seq", str(SEQ_P), "--epochs", "1", "--fused-ce", "--batch-size", str(TB),
             "--num-steps", str(TT)], capture_output=True, text=True, timeout=600,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        secs = time.perf_counter() - t0
        check(proc.returncode == 0, f"python -m jlm_tpu_torch.train --mesh-seq {SEQ_P} failed: "
              f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
        records = checkpoint.read_log(exp)
        _, cfg = checkpoint.load_checkpoint(exp)
        log(f"phase 3g python -m jlm_tpu_torch.train --mesh-seq {SEQ_P} --fused-ce, one epoch "
            f"on the streamed data dir: {records} ({secs:.1f} s with its {SEQ_P} ranks on "
            f"{card})")
        check(len(records) == 1 and np.isfinite(records[0]["dev_ppl"])
              and cfg.mesh_seq == SEQ_P, "the --mesh-seq CLI's epoch")


def seq_run(dev, card, train_ids, refs, loss_k):
    """Phase 3g: the time-block pipeline with every rank on this card
    (Gloo), against phase 5's one-card losses and ``one_card_refs``; the
    planted faults; then the CLI.  Returns the launches for the ``kernels``
    line (rank 0's; every rank's are checked)."""
    from jlm_tpu_torch.parallel.comm import spawn

    t0 = time.perf_counter()
    world = spawn(seq_rank, SEQ_P, device="cuda", args=(train_ids,))
    log(f"phase 3g world: {SEQ_P} ranks {time.perf_counter() - t0:.1f} s (spawns included)")
    check(all(r["modules"] == [] for r in world), "a rank imported jax or the JAX package")
    losses = world[0]["losses"]
    step1 = abs(losses[0] - loss_k[0])
    last = abs(losses[-1] / loss_k[SEQ_STEPS - 1] - 1)
    log(f"phase 3g training, seq mesh of {SEQ_P} stages, {SEQ_M} microbatches: losses "
        f"{[round(l, 6) for l in losses]} vs one card "
        f"{[round(float(l), 6) for l in loss_k[:SEQ_STEPS]]}: step 1 diff {step1:.3e}, step "
        f"{SEQ_STEPS} rel diff {last:.3e} (bounds {TRAIN_BOUNDS}); {world[0]['ms']:.2f} ms/step "
        f"({SEQ_P} ranks on one card, Gloo, {card}); CE launches per rank "
        f"{world[0]['launches']}")
    check(step1 <= TRAIN_BOUNDS["step 1 loss"] and last <= TRAIN_BOUNDS["last loss"],
          "phase 3g: pipeline training losses vs one card")
    check(all(r["losses"] == losses for r in world), "phase 3g: ranks' losses differ")
    check(all(r["launches"] == dict(ce_fwd_raw=SEQ_STEPS, ce_bwd_dh=SEQ_STEPS,
                                    ce_bwd_dw=SEQ_STEPS, cast_wt=SEQ_STEPS) for r in world),
          f"phase 3g: CE launches {[r['launches'] for r in world]}: one a rank and step")
    check(len({r["digest"] for r in world}) == 1 and len({r["first digest"] for r in world}) == 1,
          "phase 3g: the final carries differ between ranks")
    carry_err = max(abs_err(a, b) for a, b in zip(world[-1]["carries"], refs["carries"]))
    log(f"phase 3g final carries equal on all {SEQ_P} ranks; the first window's vs one card: "
        f"max abs {carry_err:.3e} (bound {SEQ_BOUNDS['carries vs one card']:g})")
    check(carry_err <= SEQ_BOUNDS["carries vs one card"], "phase 3g: carries vs one card")

    def gate(kind, fault):
        loss, got = world[-1][(kind, fault)]
        loss1, want = refs[kind]
        err = float((got - want).abs().max() / want.abs().max())
        bound = SHARD_BOUNDS["grads vs one card" if kind == "grads" else "clip step vs one card"]
        ok = err <= bound and abs(loss - loss1) <= TRAIN_BOUNDS["step 1 loss"]
        log(f"  phase 3g {kind} gate, {fault or 'no fault'}: rel err {err:.3e} (bound {bound:g}), "
            f"loss diff {abs(loss - loss1):.3e}")
        return ok

    check(gate("grads", None) and gate("clip", None), "phase 3g: the step vs one card")
    for fault in SEQ_FAULTS:
        check(not gate("grads", fault), f"phase 3g: the gates miss {fault}")
    seq_cli(card)
    return {f"{k} bf16 N{N_SEQ}": world[0]["shapes"][fn].get((N_SEQ, H, V), 0) for k, fn in (
        ("ce_fwd", "ce_fwd_raw"), ("ce_bwd_dh", "ce_bwd_dh"), ("ce_bwd_dw", "ce_bwd_dw"))}


def differing(results, oracle_results):
    """(top-1 paths that differ from the oracle's, each top-1's |score gap|,
    the gaps of the differing ones)."""
    diff = [r[0].segments != o.segments for r, o in zip(results, oracle_results)]
    gaps = [abs(r[0].score - o.score) for r, o in zip(results, oracle_results)]
    return sum(diff), gaps, [round(g, 6) for g, d in zip(gaps, diff) if d]


def trained_c5_run(dev, card):
    """Phase 3h: ``python -m jlm_tpu_torch.scripts.quality_stats --fused-ce``
    at QS_ARGS' size (config 5 trained, then decoded through BeamDecoder),
    launches counted; on the trained weights fp32 greedy through the kernel
    forward path-identical to the fp32 oracle on the first QS_GATED test
    sentences (the gate); bf16 and int8 beam-10 against their oracles
    reported.  Returns the launches for the ``kernels`` line."""
    from jlm_tpu_torch.data.corpus import build_vocab
    from jlm_tpu_torch.data.lexicon import Lexicon
    from jlm_tpu_torch.data.synthetic_ctx import generate_corpus_ctx, generate_test_set_ctx
    from jlm_tpu_torch.decoder.engine import BeamDecoder, make_kernel_forward
    from jlm_tpu_torch.ops import softmax_ce as ce
    from jlm_tpu_torch.ops.cand_dot import cand_dot
    from jlm_tpu_torch.ops.lstm_cell import lstm_cell_step
    from jlm_tpu_torch.ops.project import project_lse
    from jlm_tpu_torch.ops.quant import quantize_params
    from jlm_tpu_torch.oracle import OracleDecoder, OracleLM
    from jlm_tpu_torch.scripts import quality_stats
    from jlm_tpu_torch.train import load_checkpoint

    t_phase = time.perf_counter()
    train_counters = (ce.ce_fwd_raw, ce.ce_bwd_dh, ce.ce_bwd_dw, ce.cast_wt)
    decode_counters = (project_lse, lstm_cell_step, cand_dot)
    for fn in train_counters + decode_counters:
        fn.launches = 0
    for fn in train_counters[:3] + (lstm_cell_step, cand_dot):
        fn.shapes = {}
    project_lse.rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "quality.json")
        printed = io.StringIO()  # its JSON line, kept off the lines this script ends with
        with contextlib.redirect_stdout(printed):
            quality_stats.main(QS_ARGS + ["--out", out, "--exp-root", os.path.join(tmp, "exp")])
        log(f"quality_stats printed: {printed.getvalue().strip()}")
        with open(out) as f:
            stats = json.load(f)["config5_stats"]
        params, cfg = load_checkpoint(os.path.join(tmp, "exp", f"seed{QS_SEED}"))
    qs_secs = time.perf_counter() - t_phase
    counts = {fn.__name__: fn.launches for fn in train_counters + decode_counters}
    shapes = {fn.__name__: dict(fn.shapes)
              for fn in train_counters[:3] + (lstm_cell_step, cand_dot)}
    row = stats["per_seed"][0]
    log(f"phase 3h quality_stats ({' '.join(QS_ARGS)}) on {card}: {qs_secs:.1f} s; dev ppl "
        f"{row['dev_ppl']}, beam-10 {row['beam10']}, greedy {row['greedy']}, model-selection "
        f"beam-10 {row['beam10_devsel_acc']}; launches {counts}, project_lse by rows "
        f"{dict(project_lse.rows)}, by shape {shapes}")
    check(np.isfinite(row["dev_ppl"]), "phase 3h: dev perplexity")
    n_ce = counts["ce_fwd_raw"]
    check(n_ce > 0 and n_ce % len(BLOCKS5) == 0 and counts["cast_wt"] == n_ce
          and counts["ce_bwd_dh"] == counts["ce_bwd_dw"] > 0
          and counts["ce_bwd_dh"] % len(BLOCKS5) == 0,
          f"phase 3h: CE launches {counts}: one of each a block and step (forward also a dev "
          "window)")
    check(counts["project_lse"] == len(BLOCKS5) * counts["cand_dot"]
          and counts["lstm_cell_step"] == 2 * counts["cand_dot"],
          f"phase 3h: decode launches {counts}: a forward's 3 blocks, 2 cells, one cand_dot")

    corpus = generate_corpus_ctx(int(QS_ARGS[QS_ARGS.index("--sentences") + 1]), seed=1234)
    vocab = build_vocab(corpus, V5)
    lexicon = Lexicon.from_vocab(vocab)
    kanas = [k for k, _ in generate_test_set_ctx(200, seed=777)[:QS_GATED]]
    beam = cfg.replace(beam_width=10, n_best_max=1)
    greedy = beam.replace(beam_width=1)
    t0 = time.perf_counter()
    eng = BeamDecoder(params, lexicon, vocab, greedy, device=dev,
                      forward_fn=make_kernel_forward(greedy, torch.float32))
    oracle_g = OracleDecoder(OracleLM(params, greedy), lexicon, vocab, greedy)
    n_diff, gaps, _ = differing(eng.decode_batch(kanas), [oracle_g.decode(k)[0] for k in kanas])
    log(f"phase 3h trained config 5, fp32 greedy kernel forward vs the fp32 oracle: "
        f"{QS_GATED - n_diff}/{QS_GATED} paths identical, max |score gap| {max(gaps):.3e} "
        f"({time.perf_counter() - t0:.1f} s)")
    check(n_diff == 0, "phase 3h: trained-weights fp32 greedy parity")
    t0 = time.perf_counter()
    qp = quantize_params(params)
    for label, p, oracle_p in (("bf16", params, params), ("int8", qp, qp)):
        eng = BeamDecoder(p, lexicon, vocab, beam, precision="default", device=dev)
        oracle = OracleDecoder(OracleLM(oracle_p, beam), lexicon, vocab, beam)
        n_diff, gaps, diff_gaps = differing(eng.decode_batch(kanas),
                                            [oracle.decode(k)[0] for k in kanas])
        log(f"phase 3h trained config 5, {label} beam-10 vs the oracle on "
            f"{'fp32' if label == 'bf16' else 'int8'} weights: {n_diff}/{QS_GATED} paths "
            f"differ; |score gap| max {max(gaps):.3e}, median {statistics.median(gaps):.3e}; "
            f"the differing paths' gaps {diff_gaps}")
    log(f"phase 3h reports {time.perf_counter() - t0:.1f} s; phase 3h "
        f"{time.perf_counter() - t_phase:.1f} s")
    ce_at = {f"{k} bf16 c5 b{i}": shapes[fn].get((N_CE, d, n), 0)
             for k, fn in (("ce_fwd", "ce_fwd_raw"), ("ce_bwd_dh", "ce_bwd_dh"),
                           ("ce_bwd_dw", "ce_bwd_dw"))
             for i, (n, d) in enumerate(BLOCKS5)}
    ce_at[f"ce_fwd bf16 D{DS_D}"] = ce_at.pop(f"ce_fwd bf16 c5 b{len(BLOCKS5) - 1}")
    return {**ce_at,
            f"project_lse dsoftmax bf16 R{R_QS}": project_lse.rows.get(R_QS, 0),
            **{f"lstm_cell_step bf16 R{R_QS} E{e}": shapes["lstm_cell_step"].get((R_QS, e), 0)
               for e in QS_CELLS},
            f"cand_dot bf16 S{QS_S}": shapes["cand_dot"].get((QS_S, B), 0)}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; needs one CUDA card",
              file=sys.stderr)
        return 1
    from jlm_tpu_torch.oracle import OracleDecoder, OracleLM
    from jlm_tpu_torch.decoder.engine import (
        BeamDecoder, make_fused_frame_forward, make_kernel_forward)
    from jlm_tpu_torch.models.params import load_npz_params
    from jlm_tpu_torch.ops import _build
    from jlm_tpu_torch.ops.cand_dot import cand_dot
    from jlm_tpu_torch.ops.frame_step import cell_cand_step
    from jlm_tpu_torch.ops.lstm_cell import lstm_cell_step
    from jlm_tpu_torch.ops.project import project_lse

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # ---- phase 1: card and build ----
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    max_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    SFU_RATE["exp"] = SFU_PER_CLOCK * sms * max_mhz * 1e6
    log(f"exponentials: {SFU_PER_CLOCK} a clock x {sms} SMs x {max_mhz:g} MHz = "
        f"{SFU_RATE['exp']:.4g}/s")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")
    _build.lib()
    info = _build.build_info
    log(f"kernels: {info['path']} built in {info['seconds']:.1f} s "
        f"(cached={info['cached']}) from {', '.join(_build.sources())}")
    for line in info.get("log", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # ---- phase 2: each kernel vs its plain version at its path's shapes ----
    rng = np.random.default_rng(0)
    measured, device_ms = {}, {}
    wrong_p = f"a p-term {1 - math.exp(-P_SHIFT):.0%} low"
    wrongs = {  # what a case's wrong call gets wrong, where it is not wrong_p
        "lstm_scan_bwd fp32": f"a forget gate sigmoid(f + {F_SHIFT:g}) in the backward",
        "project_lse dsoftmax int8 slice scale": "an int8 row scale over all H",
        "project_lse int8": "the ragged last vocab tile's zero-filled columns unmasked",
        "lstm_cell_step bf16": "gates j and f swapped (a gate-tile mapping fault)",
        "project_lse dequant bf16": "the exact int8 product rescaled after it",
        "project_lse bf16": "the second warpgroup's rows from the first's",
        "project_lse bf16 D1024": "the second warpgroup's rows from the first's",
        "project_lse dequant bf16 D1024": "the exact int8 product rescaled after it",
        "lstm_cell_step fp32": "operands rounded to TF32",
        **{name: "beam rows 8 on read from rows 0 on (the m16 tile's second half)"
           for name in ("cand_dot bf16", "cand_dot fp32", "cand_dot bf16 B20",
                        "cand_dot fp32 B20")},
    }
    cases, yardsticks = kernel_cases(dev, rng)
    cases += head_mode_cases(dev, rng) + port_cases(dev, rng) + wide_cases(dev, rng)
    cases += odd_width_cases(dev, rng) + keystroke_cases(dev, rng) + long_cases(dev)
    cases += shard_cases(dev, rng) + seq_qs_cases(dev, rng)
    for name, kernel, plain, err_fn, wrong, library in cases:
        want = plain()
        err, max_abs = err_fn(kernel(), want)
        ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
        lib_ms = cuda_ms(library) if library is not None else None
        # in a row: the device's time where it is the slower side (a
        # one-call time adds the wrapper's Python before the launch)
        row_ms, host_ms = in_a_row(kernel)
        lib_row = in_a_row(library) if library is not None else (None, None)
        log(f"{name}: err {err:.3e} (bound {BOUNDS[name]:g}; max abs {max_abs:.3e}), "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
            + ("" if lib_ms is None else f", library call {lib_ms:.4f} ms")
            + f"; 50 in a row: kernel {row_ms:.4f} ms a call (host {host_ms:.4f})"
            + ("" if lib_row[0] is None else
               f", library call {lib_row[0]:.4f} (host {lib_row[1]:.4f})"))
        check(err <= BOUNDS[name], f"{name}: error {err} exceeds {BOUNDS[name]}")
        if name in PHASE2_ONLY:  # no path launches it: its bound beside its time here
            log(f"  {name}: bound {bound_of(name)[0]:.4f} ms ({bound_of(name)[1]})")
        if callable(wrong):
            wrong = {wrongs.get(name, wrong_p): wrong}
        for what, call in (wrong or {}).items():
            caught = err_fn(call(), want)[0]
            log(f"  {name}: {what} reads {caught:.3e}")
            check(caught > BOUNDS[name], f"{name}: bound misses {what} ({caught})")
        measured[name] = (max_abs, ms, plain_ms, lib_ms, row_ms, host_ms, lib_row[0])
        if name in KEY_CASES + LONG_CASES:  # host-bound: the device's time from the profiler
            device_ms[name] = profiled(kernel)[0]
            log(f"  {name}: device {device_ms[name]:.4f} ms a call (torch.profiler, "
                f"its kernels summed)")
        if name in SPLIT_PAIRS:  # the fused frame against the split pair it replaces
            pair = SPLIT_PAIRS[name]
            p_row, p_host = in_a_row(pair)
            log(f"  {name}: the split pair lstm_cell_step + cand_dot {cuda_ms(pair):.4f} ms "
                f"one call; 50 in a row {p_row:.4f} ms a call (host {p_host:.4f})")
    for name, run in yardsticks.items():
        log(f"{name}: {cuda_ms(run):.4f} ms")
    del cases, yardsticks
    torch.cuda.empty_cache()
    readings, ds_ms, ds_plain_ms = dsoftmax_case(dev, rng)
    for what, (err, caught) in readings.items():
        bound = DSOFTMAX_BOUNDS[what]
        log(f"ce_loss_fused_dsoftmax {what}: err {err:.3e} (bound {bound:g})"
            + ("" if caught is None else f"; {wrong_p} reads {caught:.3e}"))
        check(err <= bound, f"D-softmax fused CE {what}: error {err} exceeds {bound}")
        check(caught is None or caught > bound,
              f"D-softmax fused CE {what}: bound misses {wrong_p} ({caught})")
    log(f"ce_loss_fused_dsoftmax fwd+bwd: kernels {ds_ms:.4f} ms, "
        f"plain fp32 CE {ds_plain_ms:.4f} ms")
    torch.cuda.empty_cache()

    # ---- phase 2b: candidate extraction through its entry points ----
    launches_cand = candidate_run(dev, rng)
    torch.cuda.empty_cache()

    # ---- phase 3: the main path, streaming beam-10 at flagship width ----
    config, vocab, lexicon, params, qp, kanas = bench_data()
    engine = BeamDecoder(qp, lexicon, vocab, config, precision="default", device=dev)
    stream = (kanas * (-(-S // len(kanas))))[:S]
    n_chars = sum(len(k) for k in stream)
    t0 = time.perf_counter()
    engine.decode_stream(stream, chunk_size=S)
    log(f"first decode_stream (warm-up): {time.perf_counter() - t0:.3f} s")
    counters = (project_lse, lstm_cell_step, cand_dot)
    for fn in counters:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(PASSES):
        t0 = time.perf_counter()
        results = engine.decode_stream(stream, chunk_size=S, n_best=1)
        times.append(time.perf_counter() - t0)  # ends in the blob fetch
    launches = {fn.__name__: fn.launches for fn in counters}
    frames = min(engine._t_bucket(max(len(k) for k in stream)), config.max_kana_len)
    forwards = PASSES * (frames + 1)  # root forward + one per frame
    log(f"launches over {PASSES} passes ({frames} frames each): {launches}")
    check(launches == {"project_lse": forwards, "cand_dot": forwards,
                       "lstm_cell_step": forwards * config.num_layers},
          f"launch counts {launches}, expected {forwards} forwards")
    med = statistics.median(times)
    log(f"main path: {n_chars} chars per pass, passes {[round(t, 4) for t in times]} s; "
        f"median {n_chars / med:.1f} chars/s, best {n_chars / min(times):.1f} chars/s "
        f"on {card}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    finite = all(len(r) == 1 and np.isfinite(r[0].score) for r in results)
    check(len(results) == len(stream) and finite,
          "main path: every sentence has one finite top-1 result")

    # ---- phase 4: parity with the numpy oracle on the 50 test sentences ----
    greedy_cfg = config.replace(beam_width=1)
    oracle = OracleDecoder(OracleLM(params, greedy_cfg), lexicon, vocab, greedy_cfg)
    greedy = BeamDecoder(params, lexicon, vocab, greedy_cfg, precision="highest",
                         device=dev)
    oracle_g_results = [oracle.decode(k)[0] for k in kanas]
    t0 = time.perf_counter()
    n = identical(greedy.decode_batch(kanas), oracle_g_results)
    log(f"greedy fp32 parity {n}/{len(kanas)} (top-1 path identity vs oracle); wall "
        f"{time.perf_counter() - t0:.4f} s")
    check(n == len(kanas), "greedy parity")
    oracle_q = OracleDecoder(OracleLM(qp, config), lexicon, vocab, config)
    oracle_q_results = [oracle_q.decode(k)[0] for k in kanas]
    n = identical(results[:len(kanas)], oracle_q_results)
    log(f"beam-10 int8 parity {n}/{len(kanas)} (kernel path vs int8 oracle)")
    check(n == len(kanas), "int8 beam parity")
    bf16_engine = BeamDecoder(params, lexicon, vocab, config, precision="default",
                              device=dev)
    oracle_f = OracleDecoder(OracleLM(params, config), lexicon, vocab, config)
    project_lse.launches = 0  # the 50k bf16 head's launches on this run
    results_bf16 = bf16_engine.decode_batch(kanas)
    launches_bf16 = project_lse.launches
    n = identical(results_bf16, [oracle_f.decode(k)[0] for k in kanas])
    log(f"beam-10 bf16 parity {n}/{len(kanas)} (kernel path vs fp32 oracle)")
    check(n == len(kanas), "bf16 beam parity")
    check("jax" not in sys.modules, "the port imported jax")
    del greedy, bf16_engine

    # ---- phase 3c: the fused frame (kernel 9) on the same chunk, in turns ----
    fused = BeamDecoder(qp, lexicon, vocab, config, device=dev,
                        forward_fn=make_fused_frame_forward(config))
    t0 = time.perf_counter()
    fused.decode_stream(stream, chunk_size=S)
    log(f"fused frame: first decode_stream (warm-up): {time.perf_counter() - t0:.3f} s")
    frame_counters = (project_lse, cell_cand_step, lstm_cell_step, cand_dot)
    launches_f = dict.fromkeys((fn.__name__ for fn in frame_counters), 0)
    times_split, times_fused = [], []
    for _ in range(PASSES):  # split, fused in turns
        t0 = time.perf_counter()
        engine.decode_stream(stream, chunk_size=S, n_best=1)
        times_split.append(time.perf_counter() - t0)
        for fn in frame_counters:
            fn.launches = 0
        t0 = time.perf_counter()
        results_f = fused.decode_stream(stream, chunk_size=S, n_best=1)
        times_fused.append(time.perf_counter() - t0)
        for fn in frame_counters:
            launches_f[fn.__name__] += fn.launches
    log(f"fused frame launches over {PASSES} passes ({frames} frames each): {launches_f}")
    check(launches_f == {"project_lse": forwards, "cell_cand_step": forwards,
                         "lstm_cell_step": 0, "cand_dot": 0},
          f"fused frame launch counts {launches_f}, expected {forwards} forwards")
    med_s, med_f = statistics.median(times_split), statistics.median(times_fused)
    log(f"fused frame vs split frame (in turns): split passes "
        f"{[round(t, 4) for t in times_split]} s, median {n_chars / med_s:.1f} chars/s; "
        f"fused passes {[round(t, 4) for t in times_fused]} s, median "
        f"{n_chars / med_f:.1f} chars/s on {card}")
    check(len(results_f) == len(stream)
          and all(len(r) == 1 and np.isfinite(r[0].score) for r in results_f),
          "fused frame: every sentence has one finite top-1 result")
    n = identical(results_f[:len(kanas)], oracle_q_results)
    log(f"fused frame beam-10 int8 parity {n}/{len(kanas)} (vs int8 oracle)")
    check(n == len(kanas), "fused frame int8 beam parity")
    # the fp32 fused frame (the parity mode) greedy on the 50 sentences
    fused32 = BeamDecoder(params, lexicon, vocab, greedy_cfg, device=dev,
                          forward_fn=make_fused_frame_forward(greedy_cfg, torch.float32))
    for fn in frame_counters:
        fn.launches = 0
    t0 = time.perf_counter()
    res32 = fused32.decode_batch(kanas)
    wall32 = time.perf_counter() - t0
    launches_f32 = {fn.__name__: fn.launches for fn in frame_counters}
    n = identical(res32, oracle_g_results)
    worst = max(abs(r[0].score - o.score) for r, o in zip(res32, oracle_g_results))
    fwd32 = min(fused32._t_bucket(max(len(k) for k in kanas)), config.max_kana_len) + 1
    log(f"fused frame greedy fp32 parity {n}/{len(kanas)} (vs fp32 oracle); max |score - "
        f"oracle| {worst:.3e}; launches {launches_f32}; wall {wall32:.4f} s")
    check(n == len(kanas) and worst <= 1e-3, "fused frame greedy fp32 parity")
    check(launches_f32 == {"project_lse": fwd32, "cell_cand_step": fwd32,
                           "lstm_cell_step": 0, "cand_dot": 0},
          f"fp32 fused frame launches {launches_f32}, expected {fwd32} forwards")
    del engine, fused, fused32
    torch.cuda.empty_cache()

    # ---- phase 3b: BASELINE config 5 serving (2 layers, 100k, D-softmax) ----
    cfg5, vocab5, lexicon5, params5, qp5 = bench_data5()
    n_blocks = len(cfg5.dsoftmax.block_sizes)

    def expect(fwd, layers, blocks):
        """Launches of ``fwd`` split-frame forwards: per forward one
        projection per block, one cell per layer, one cand_dot."""
        return {"project_lse": fwd * blocks, "lstm_cell_step": fwd * layers,
                "cand_dot": fwd, "cell_cand_step": 0}

    def counted(run):
        """Run with the four frame counters set to 0; returns (result, counts)."""
        for fn in frame_counters:
            fn.launches = 0
        out = run()
        return out, {fn.__name__: fn.launches for fn in frame_counters}

    engine5 = BeamDecoder(qp5, lexicon5, vocab5, cfg5, precision="default", device=dev)
    t0 = time.perf_counter()
    engine5.decode_stream(stream, chunk_size=S)
    log(f"config 5: first decode_stream (warm-up): {time.perf_counter() - t0:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    times5 = []

    def passes5():
        for _ in range(PASSES):
            t0 = time.perf_counter()
            res = engine5.decode_stream(stream, chunk_size=S, n_best=1)
            times5.append(time.perf_counter() - t0)
        return res

    results5, launches5 = counted(passes5)
    frames5 = min(engine5._t_bucket(max(len(k) for k in stream)), cfg5.max_kana_len)
    forwards5 = PASSES * (frames5 + 1)
    log(f"config 5 launches over {PASSES} passes ({frames5} frames each): {launches5}")
    check(launches5 == expect(forwards5, cfg5.num_layers, n_blocks),
          f"config 5 launch counts {launches5}, expected {forwards5} forwards x "
          f"{n_blocks} blocks / {cfg5.num_layers} layers / 1")
    med5 = statistics.median(times5)
    log(f"config 5 serving (2 layers, V={V5}, D-softmax {cfg5.dsoftmax.block_sizes} @ "
        f"{cfg5.dsoftmax.block_dims}, int8-MXU): {n_chars} chars per pass, passes "
        f"{[round(t, 4) for t in times5]} s; median {n_chars / med5:.1f} chars/s, best "
        f"{n_chars / min(times5):.1f} chars/s on {card}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(len(results5) == len(stream)
          and all(len(r) == 1 and np.isfinite(r[0].score) for r in results5),
          "config 5: every sentence has one finite top-1 result")

    # ---- phase 4b: config-5 and int8-dequant parity on the 50 sentences ----
    frames_50 = min(engine5._t_bucket(max(len(k) for k in kanas)), cfg5.max_kana_len)
    oracle5_q = OracleDecoder(OracleLM(qp5, cfg5), lexicon5, vocab5, cfg5)
    oracle5_q_results = [oracle5_q.decode(k)[0] for k in kanas]
    n = identical(results5[:len(kanas)], oracle5_q_results)
    log(f"config 5 beam-10 int8 parity {n}/{len(kanas)} (kernel path vs int8 oracle)")
    check(n == len(kanas), "config 5 int8 beam parity")
    del engine5
    torch.cuda.empty_cache()
    mode_launches = {}

    def parity_run(label, params_, lexicon_, vocab_, cfg_, oracle_results, blocks,
                   score_tol=None, want=None, **kw):
        eng = BeamDecoder(params_, lexicon_, vocab_, cfg_, device=dev, **kw)
        t0 = time.perf_counter()
        res, counts = counted(lambda: eng.decode_batch(kanas))
        wall = time.perf_counter() - t0
        n = identical(res, oracle_results)
        worst = max(abs(r[0].score - o.score) for r, o in zip(res, oracle_results))
        log(f"{label} parity {n}/{len(kanas)}; max |score - oracle| {worst:.3e}; "
            f"launches {counts}; wall {wall:.4f} s")
        check(n == len(kanas), f"{label} parity")
        check(score_tol is None or worst <= score_tol,
              f"{label}: score off the oracle by {worst} > {score_tol}")
        want = want or expect(frames_50 + 1, cfg_.num_layers, blocks)
        check(counts == want, f"{label}: launches {counts}, expected {want}")
        return counts

    oracle5 = OracleDecoder(OracleLM(params5, cfg5), lexicon5, vocab5, cfg5)
    mode_launches["bf16 dsoftmax"] = parity_run(
        "config 5 beam-10 bf16 (vs fp32 oracle)", params5, lexicon5, vocab5, cfg5,
        [oracle5.decode(k)[0] for k in kanas], n_blocks, precision="default")
    greedy5 = cfg5.replace(beam_width=1)
    oracle5_g = OracleDecoder(OracleLM(params5, greedy5), lexicon5, vocab5, greedy5)
    mode_launches["fp32"] = parity_run(
        "config 5 greedy fp32 kernel forward (vs fp32 oracle)", params5, lexicon5, vocab5,
        greedy5, [oracle5_g.decode(k)[0] for k in kanas], n_blocks, score_tol=1e-3,
        forward_fn=make_kernel_forward(greedy5, torch.float32))
    mode_launches["dequant"] = parity_run(
        "50k beam-10 int8 dequant (vs int8 oracle)", qp, lexicon, vocab,
        config.replace(int8_mxu=False), oracle_q_results, 1, precision="default")
    oracle_qg = OracleDecoder(OracleLM(qp, greedy_cfg), lexicon, vocab, greedy_cfg)
    mode_launches["dequant fp32"] = parity_run(
        "50k greedy fp32 int8-dequant kernel forward (vs int8 oracle)", qp, lexicon, vocab,
        greedy_cfg, [oracle_qg.decode(k)[0] for k in kanas], 1, score_tol=1e-3,
        forward_fn=make_kernel_forward(greedy_cfg, torch.float32, int8_mxu=False))
    # the fp32 gates at head weights of scale PEAKED (where TF32 would show)
    from jlm_tpu_torch.ops.quant import quantize_params

    def greedy_oracle(params_, lexicon_, vocab_, cfg_):
        o = OracleDecoder(OracleLM(params_, cfg_), lexicon_, vocab_, cfg_)
        return [o.decode(k)[0] for k in kanas]

    pk, pk5 = peaked(params), peaked(params5)
    qpk = quantize_params(pk)
    fwd = frames_50 + 1
    parity_run("50k greedy fp32 kernel forward, PEAKED head (vs fp32 oracle)", pk, lexicon,
               vocab, greedy_cfg, greedy_oracle(pk, lexicon, vocab, greedy_cfg), 1,
               score_tol=1e-3, forward_fn=make_kernel_forward(greedy_cfg, torch.float32))
    parity_run("config 5 greedy fp32 kernel forward, PEAKED head (vs fp32 oracle)", pk5,
               lexicon5, vocab5, greedy5, greedy_oracle(pk5, lexicon5, vocab5, greedy5),
               n_blocks, score_tol=1e-3, forward_fn=make_kernel_forward(greedy5, torch.float32))
    parity_run("50k greedy fp32 int8-dequant kernel forward, PEAKED head (vs int8 oracle)",
               qpk, lexicon, vocab, greedy_cfg, greedy_oracle(qpk, lexicon, vocab, greedy_cfg),
               1, score_tol=1e-3,
               forward_fn=make_kernel_forward(greedy_cfg, torch.float32, int8_mxu=False))
    parity_run("50k greedy fp32 fused frame, PEAKED head (vs fp32 oracle)", pk, lexicon, vocab,
               greedy_cfg, greedy_oracle(pk, lexicon, vocab, greedy_cfg), 1, score_tol=1e-3,
               want={"project_lse": fwd, "cell_cand_step": fwd, "lstm_cell_step": 0,
                     "cand_dot": 0},
               forward_fn=make_fused_frame_forward(greedy_cfg, torch.float32))
    check(not any(m.split(".")[0] in ("jax", "jlm_tpu") for m in sys.modules),
          "the port imported jax or the JAX package")
    del params5, pk, pk5, qpk
    torch.cuda.empty_cache()

    # ---- phase 3d: per-keystroke serving (BASELINE config 4) ----
    t0 = time.perf_counter()
    launches_key = keystroke_run(dev, card, config, vocab, lexicon, qp, kanas, oracle_q_results,
                                 (cfg5, vocab5, lexicon5, qp5, oracle5_q_results))
    log(f"phase 3d: {time.perf_counter() - t0:.1f} s")

    # ---- phase 3e: decode_long, inputs past max_kana_len ----
    launches_long = long_run(dev, card, config, vocab, lexicon, params, qp, kanas,
                             (cfg5, vocab5, lexicon5, qp5))
    del qp5
    torch.cuda.empty_cache()

    # ---- phase 5: the training path, CE kernels vs their plain versions ----
    tcfg = config.replace(batch_size=TB, num_steps=TT, fused_ce=True)
    train_ids, dev_ids = training_corpus(vocab)
    trainer, loss_k, ms_k, launches_k, ppl_k = training_run(
        dev, tcfg, params, train_ids, dev_ids, "CE kernels")
    _, loss_p, ms_p, launches_p, ppl_p = training_run(
        dev, tcfg, params, train_ids, dev_ids, "CE plain versions", plain_ce)
    check(np.isfinite(loss_k).all() and np.isfinite(loss_p).all(), "training loss finite")
    check(loss_k[-5:].mean() < loss_k[:5].mean(),
          f"training loss falls: first 5 {loss_k[:5]}, last 5 {loss_k[-5:]}")
    step1, last = abs(loss_k[0] - loss_p[0]), abs(loss_k[-1] / loss_p[-1] - 1)
    ppl_rel = abs(ppl_k / ppl_p - 1)
    log(f"training kernels vs plain: step 1 loss diff {step1:.3e} (bound "
        f"{TRAIN_BOUNDS['step 1 loss']:g}), last loss rel diff {last:.3e} (bound "
        f"{TRAIN_BOUNDS['last loss']:g}), dev ppl rel diff {ppl_rel:.3e} (bound "
        f"{TRAIN_BOUNDS['dev ppl']:g}); {ms_p / ms_k:.3f}x the plain run's step rate")
    check(step1 <= TRAIN_BOUNDS["step 1 loss"], "step 1 loss: kernels vs plain")
    check(last <= TRAIN_BOUNDS["last loss"], "last loss: kernels vs plain")
    check(ppl_rel <= TRAIN_BOUNDS["dev ppl"], "dev perplexity: kernels vs plain")
    check(launches_k == {**dict.fromkeys(STEP_COUNTERS, TRAIN_STEPS),
                         **dict.fromkeys(SCAN_COUNTERS, 0)},
          f"CE launches {launches_k}: one forward, one backward and one cast of W^T per step")
    check(not any(launches_p.values()), f"plain run launched {launches_p}")
    launches.update((k, launches_k[k]) for k in CE_COUNTERS)

    # ---- phase 3f: vocab and data parallelism, every rank on this card ----
    t0 = time.perf_counter()
    refs = one_card_refs(dev, params, train_ids)
    launches_shard = shard_run(dev, card, kanas, stream, train_ids, refs, loss_k, results5,
                               oracle5_q_results)
    log(f"phase 3f: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # ---- phase 3g: the time-block pipeline (--mesh-seq), every rank on this card ----
    t0 = time.perf_counter()
    launches_seq = seq_run(dev, card, train_ids, refs, loss_k)
    log(f"phase 3g: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # ---- phase 3h: config 5 trained by quality_stats, then decoded ----
    launches_qs = trained_c5_run(dev, card)
    torch.cuda.empty_cache()

    # ---- phase 5b: --pallas-scan, the scan kernels vs their plain versions ----
    scfg = tcfg.replace(use_pallas_scan=True)
    _, loss_s, ms_s, launches_s, ppl_s = training_run(
        dev, scfg, params, train_ids, dev_ids, "--pallas-scan, scan kernels")
    _, loss_sp, ms_sp, launches_sp, ppl_sp = training_run(
        dev, scfg, params, train_ids, dev_ids, "--pallas-scan, scan plain versions",
        plain_scan)
    check(np.isfinite(loss_s).all() and np.isfinite(loss_sp).all(), "scan loss finite")
    check(loss_s[-5:].mean() < loss_s[:5].mean(),
          f"scan training loss falls: first 5 {loss_s[:5]}, last 5 {loss_s[-5:]}")
    step1, last = abs(loss_s[0] - loss_sp[0]), abs(loss_s[-1] / loss_sp[-1] - 1)
    ppl_rel, loop1 = abs(ppl_s / ppl_sp - 1), abs(loss_s[0] - loss_k[0])
    log(f"scan kernels vs plain: step 1 loss diff {step1:.3e}, last loss rel diff "
        f"{last:.3e}, dev ppl rel diff {ppl_rel:.3e}; scan vs loop run: step 1 loss "
        f"diff {loop1:.3e} (bounds {TRAIN_BOUNDS}); {ms_k / ms_s:.3f}x the loop run's "
        f"step rate, {ms_sp / ms_s:.3f}x the plain scan's")
    check(step1 <= TRAIN_BOUNDS["step 1 loss"], "step 1 loss: scan kernels vs plain")
    check(last <= TRAIN_BOUNDS["last loss"], "last loss: scan kernels vs plain")
    check(ppl_rel <= TRAIN_BOUNDS["dev ppl"], "dev perplexity: scan kernels vs plain")
    check(loop1 <= TRAIN_BOUNDS["step 1 loss"], "step 1 loss: scan run vs loop run")
    per_step = TRAIN_STEPS * scfg.num_layers
    check(launches_s == {**dict.fromkeys(STEP_COUNTERS, TRAIN_STEPS),
                         **dict.fromkeys(SCAN_COUNTERS, per_step)},
          f"scan run launches {launches_s}: each scan kernel once per layer per step")
    check(launches_sp == {**dict.fromkeys(STEP_COUNTERS, TRAIN_STEPS),
                          **dict.fromkeys(SCAN_COUNTERS, 0)},
          f"plain scan run launched {launches_sp}")
    launches.update((k, launches_s[k]) for k in SCAN_COUNTERS)
    torch.cuda.empty_cache()

    # ---- phase 5d: the paths at H = E = 1,024 ----
    launches_wide = wide_run(dev, rng, config, vocab, dev_ids)
    torch.cuda.empty_cache()

    # ---- phase 5e: the width repairs through their entry points ----
    launches_odd = odd_width_run(dev, vocab, lexicon, kanas)
    torch.cuda.empty_cache()

    # ---- phase 5c: the fp32 fused CE through autograd ----
    launches_ce32 = fp32_ce_run(dev, rng)

    # ---- phase 6: train -> serve: reload the checkpoint, greedy parity ----
    with tempfile.TemporaryDirectory() as exp:
        trainer.save_state(exp, epoch=0)
        served = load_npz_params(os.path.join(exp, "ckpt-latest.npz"))
    check(not np.array_equal(served["head"]["W"], params["head"]["W"]),
          "the checkpoint holds trained weights")
    greedy = BeamDecoder(served, lexicon, vocab, greedy_cfg, precision="highest", device=dev)
    oracle_t = OracleDecoder(OracleLM(served, greedy_cfg), lexicon, vocab, greedy_cfg)
    n = identical(greedy.decode_batch(kanas), [oracle_t.decode(k)[0] for k in kanas])
    log(f"trained greedy fp32 parity {n}/{len(kanas)} (reloaded checkpoint vs oracle)")
    check(n == len(kanas), "trained-weights greedy parity")
    check(not any(m.split(".")[0] in ("jax", "jlm_tpu") for m in sys.modules),
          "the port imported jax or the JAX package")

    # ---- phase 7: records ----
    sources = {
        "project_lse": ("jlm_tpu_torch/csrc/project_lse.cu", "jlm_tpu/ops/project.py:42",
                        "project_lse int8"),
        "lstm_cell_step": ("jlm_tpu_torch/csrc/lstm_cell.cu",
                           "jlm_tpu/ops/lstm_cell.py:38", "lstm_cell_step bf16"),
        "cand_dot": ("jlm_tpu_torch/csrc/cand_dot.cu", "jlm_tpu/ops/cand_dot.py:31",
                     "cand_dot bf16"),
        "ce_fwd": ("jlm_tpu_torch/csrc/softmax_ce.cu", "jlm_tpu/ops/softmax_ce.py:111",
                   "ce_fwd bf16"),
        "ce_bwd_dh": ("jlm_tpu_torch/csrc/softmax_ce.cu", "jlm_tpu/ops/softmax_ce.py:157",
                      "ce_bwd_dh bf16"),
        "ce_bwd_dw": ("jlm_tpu_torch/csrc/softmax_ce.cu", "jlm_tpu/ops/softmax_ce.py:207",
                      "ce_bwd_dw bf16"),
        **{k: ("jlm_tpu_torch/csrc/lstm_scan.cu",
               f"jlm_tpu/ops/lstm_scan.py:{SCAN_REPLACES.get(k, 256)}", f"{k} fp32")
           for k in SCAN_COUNTERS},
        # the head's other modes and the fp32 cell: launches from their own runs
        "project_lse dsoftmax int8": ("jlm_tpu_torch/csrc/project_lse.cu",
                                      "jlm_tpu/ops/project.py:42", "project_lse dsoftmax int8"),
        "project_lse dsoftmax bf16": ("jlm_tpu_torch/csrc/project_lse.cu",
                                      "jlm_tpu/ops/project.py:42", "project_lse dsoftmax bf16"),
        "project_lse dequant bf16": ("jlm_tpu_torch/csrc/project_lse.cu",
                                     "jlm_tpu/ops/project.py:42", "project_lse dequant bf16"),
        "project_lse fp32": ("jlm_tpu_torch/csrc/project_lse.cu", "jlm_tpu/ops/project.py:42",
                             "project_lse fp32"),
        "project_lse dequant fp32": ("jlm_tpu_torch/csrc/project_lse.cu",
                                     "jlm_tpu/ops/project.py:42", "project_lse dequant fp32"),
        "lstm_cell_step fp32": ("jlm_tpu_torch/csrc/lstm_cell.cu",
                                "jlm_tpu/ops/lstm_cell.py:38", "lstm_cell_step fp32"),
        # the kernels that finish the table: launches from phases 2b, 3c, 5c
        "ce_fwd fp32": ("jlm_tpu_torch/csrc/softmax_ce.cu", "jlm_tpu/ops/softmax_ce.py:111",
                        "ce_fwd fp32"),
        "ce_bwd_dh fp32": ("jlm_tpu_torch/csrc/softmax_ce.cu",
                           "jlm_tpu/ops/softmax_ce.py:157", "ce_bwd_dh fp32"),
        "ce_bwd_dw fp32": ("jlm_tpu_torch/csrc/softmax_ce.cu",
                           "jlm_tpu/ops/softmax_ce.py:207", "ce_bwd_dw fp32"),
        **{name: ("jlm_tpu_torch/csrc/project_lse.cu", "jlm_tpu/ops/project.py:140", name)
           for name in launches_cand},
        "cell_cand_step": ("jlm_tpu_torch/csrc/cell_cand.cu", "jlm_tpu/ops/frame_step.py:47",
                           "cell_cand_step bf16"),
        "cell_cand_step fp32": ("jlm_tpu_torch/csrc/cell_cand.cu",
                                "jlm_tpu/ops/frame_step.py:47", "cell_cand_step fp32"),
        # the bf16 head at 50k (phase 4's bf16 run), and the widths past 512
        # (launches from phase 5d)
        "project_lse bf16": ("jlm_tpu_torch/csrc/project_lse.cu", "jlm_tpu/ops/project.py:42",
                             "project_lse bf16"),
        **{name: ("jlm_tpu_torch/csrc/project_lse.cu", "jlm_tpu/ops/project.py:42", name)
           for name in ("project_lse bf16 D1024", "project_lse dequant bf16 D1024")},
        **{f"{k} D1024": ("jlm_tpu_torch/csrc/softmax_ce.cu", f"jlm_tpu/ops/softmax_ce.py:{ln}",
                          f"{k} bf16 D1024") for k, ln in zip(CE_COUNTERS, (111, 157, 207))},
        **{f"{k} fp32 D1024": ("jlm_tpu_torch/csrc/softmax_ce.cu",
                               f"jlm_tpu/ops/softmax_ce.py:{ln}", f"{k} fp32 D1024")
           for k, ln in zip(CE_COUNTERS, (111, 157, 207))},
        **{f"{k} H1024": ("jlm_tpu_torch/csrc/lstm_scan.cu",
                          f"jlm_tpu/ops/lstm_scan.py:{SCAN_REPLACES.get(k, 256)}",
                          f"{k} fp32 H1024") for k in SCAN_COUNTERS},
        **{f"{k} bf16 H1024": ("jlm_tpu_torch/csrc/lstm_scan.cu",
                               f"jlm_tpu/ops/lstm_scan.py:{SCAN_REPLACES.get(k, 256)}",
                               f"{k} bf16 H1024") for k in SCAN_COUNTERS},
        # the redesigned cand_dot's other modes (launches: phase 4b's fp32
        # run, phase 5e's beam-20 run) and the width repairs (phase 5e)
        "cand_dot fp32": ("jlm_tpu_torch/csrc/cand_dot.cu", "jlm_tpu/ops/cand_dot.py:31",
                          "cand_dot fp32"),
        "cand_dot B20": ("jlm_tpu_torch/csrc/cand_dot.cu", "jlm_tpu/ops/cand_dot.py:31",
                         "cand_dot bf16 B20"),
        **{f"project_lse D{d}": ("jlm_tpu_torch/csrc/project_lse.cu",
                                 "jlm_tpu/ops/project.py:42", f"project_lse int8 D{d}")
           for d in INT8_WIDE},
        f"lstm_cell_step E{ODD_CELL[0]} H{ODD_CELL[1]}": (
            "jlm_tpu_torch/csrc/lstm_cell.cu", "jlm_tpu/ops/lstm_cell.py:38",
            f"lstm_cell_step bf16 E{ODD_CELL[0]} H{ODD_CELL[1]}"),
        f"lstm_cell_step fp32 E{ODD_CELL[0]} H{ODD_CELL[1]}": (
            "jlm_tpu_torch/csrc/lstm_cell.cu", "jlm_tpu/ops/lstm_cell.py:38",
            f"lstm_cell_step fp32 E{ODD_CELL[0]} H{ODD_CELL[1]}"),
        f"cell_cand_step E{ODD_FRAME[0]} H{ODD_FRAME[1]}": (
            "jlm_tpu_torch/csrc/cell_cand.cu", "jlm_tpu/ops/frame_step.py:47",
            f"cell_cand_step bf16 E{ODD_FRAME[0]} H{ODD_FRAME[1]}"),
        f"cell_cand_step fp32 E{ODD_FRAME[0]} H{ODD_FRAME[1]}": (
            "jlm_tpu_torch/csrc/cell_cand.cu", "jlm_tpu/ops/frame_step.py:47",
            f"cell_cand_step fp32 E{ODD_FRAME[0]} H{ODD_FRAME[1]}"),
        # the keystroke paths' rows (launches: phase 3d)
        **{f"project_lse {tag}": ("jlm_tpu_torch/csrc/project_lse.cu",
                                  "jlm_tpu/ops/project.py:42", f"project_lse int8 {tag}")
           for tag in KEY_ROWS},
        "project_lse dequant fp32 R10": ("jlm_tpu_torch/csrc/project_lse.cu",
                                         "jlm_tpu/ops/project.py:42",
                                         "project_lse dequant fp32 R10"),
        **{f"project_lse dsoftmax int8 {tag}": ("jlm_tpu_torch/csrc/project_lse.cu",
                                                "jlm_tpu/ops/project.py:42",
                                                f"project_lse dsoftmax int8 {tag}")
           for tag in KEY_ROWS5},
        # decode_long's shapes (launches: phase 3e)
        **{f"project_lse {tag}": ("jlm_tpu_torch/csrc/project_lse.cu",
                                  "jlm_tpu/ops/project.py:42", f"project_lse int8 {tag}")
           for tag in LONG_ROWS},
        **{f"project_lse dsoftmax int8 {tag}": ("jlm_tpu_torch/csrc/project_lse.cu",
                                                "jlm_tpu/ops/project.py:42",
                                                f"project_lse dsoftmax int8 {tag}")
           for tag in LONG_ROWS},
        **{f"cand_dot {tag}": ("jlm_tpu_torch/csrc/cand_dot.cu", "jlm_tpu/ops/cand_dot.py:31",
                               f"cand_dot bf16 {tag}") for tag in LONG_CANDS},
        "lstm_cell_step R10": ("jlm_tpu_torch/csrc/lstm_cell.cu", "jlm_tpu/ops/lstm_cell.py:38",
                               "lstm_cell_step bf16 R10"),
        # a rank's shapes under vocab sharding (launches: phase 3f, rank 0)
        **{f"project_lse dsoftmax int8 {tag} shard": (
            "jlm_tpu_torch/csrc/project_lse.cu", "jlm_tpu/ops/project.py:42",
            f"project_lse dsoftmax int8 {tag} shard") for tag in SHARD_ROWS},
        **{f"{k} bf16 V{V_SH}": ("jlm_tpu_torch/csrc/softmax_ce.cu",
                                 f"jlm_tpu/ops/softmax_ce.py:{ln}", f"{k} bf16 V{V_SH}")
           for k, ln in zip(CE_COUNTERS, (111, 157, 207))},
        # a pipeline stage's rows (launches: phase 3g, rank 0), config 5's
        # D-softmax blocks and decode at quality_stats' shapes (phase 3h)
        **{f"{k} bf16 N{N_SEQ}": ("jlm_tpu_torch/csrc/softmax_ce.cu",
                                  f"jlm_tpu/ops/softmax_ce.py:{ln}", f"{k} bf16 N{N_SEQ}")
           for k, ln in zip(CE_COUNTERS, (111, 157, 207))},
        **{f"{k} bf16 c5 b{i}": ("jlm_tpu_torch/csrc/softmax_ce.cu",
                                 f"jlm_tpu/ops/softmax_ce.py:{ln}", f"{k} bf16 c5 b{i}")
           for k, ln in zip(CE_COUNTERS, (111, 157, 207)) for i in range(len(BLOCKS5))
           if k != "ce_fwd" or i < 2},
        f"ce_fwd bf16 D{DS_D}": ("jlm_tpu_torch/csrc/softmax_ce.cu",
                                 "jlm_tpu/ops/softmax_ce.py:111", f"ce_fwd bf16 D{DS_D}"),
        f"project_lse dsoftmax bf16 R{R_QS}": ("jlm_tpu_torch/csrc/project_lse.cu",
                                               "jlm_tpu/ops/project.py:42",
                                               f"project_lse dsoftmax bf16 R{R_QS}"),
        **{f"lstm_cell_step bf16 R{R_QS} E{e}": ("jlm_tpu_torch/csrc/lstm_cell.cu",
                                                  "jlm_tpu/ops/lstm_cell.py:38",
                                                  f"lstm_cell_step bf16 R{R_QS} E{e}")
           for e in QS_CELLS},
        f"cand_dot bf16 S{QS_S}": ("jlm_tpu_torch/csrc/cand_dot.cu", "jlm_tpu/ops/cand_dot.py:31",
                                   f"cand_dot bf16 S{QS_S}"),
    }
    launches.update({
        "project_lse dsoftmax int8": launches5["project_lse"],
        "project_lse dsoftmax bf16": mode_launches["bf16 dsoftmax"]["project_lse"],
        "project_lse dequant bf16": mode_launches["dequant"]["project_lse"],
        "project_lse fp32": mode_launches["fp32"]["project_lse"],
        "project_lse dequant fp32": mode_launches["dequant fp32"]["project_lse"],
        "lstm_cell_step fp32": mode_launches["fp32"]["lstm_cell_step"],
        **{f"{name} fp32": launches_ce32[name] for name in CE_COUNTERS},
        **launches_cand,
        "cell_cand_step": launches_f["cell_cand_step"],
        "cell_cand_step fp32": launches_f32["cell_cand_step"],
        "project_lse bf16": launches_bf16,
        **launches_wide,
        "cand_dot fp32": mode_launches["fp32"]["cand_dot"],
        **launches_odd,
        **launches_key,
        **launches_long,
        **launches_shard,
        **launches_seq,
        **launches_qs,
    })
    kernels = []
    for name, (src, replaces, case) in sources.items():
        err, ms, plain_ms, lib_ms, row_ms, host_ms, lib_row_ms = measured[case]
        bound_ms, bound_by = bound_of(name)
        # launches a timed call makes: one a block of config 5's D-softmax
        # head (the fp32 head case is that head too), one a group of 16 beam
        # rows
        per_call = (len(BLOCKS5) if "dsoftmax" in name or name == "project_lse fp32"
                    else 2 if name == "cand_dot B20" else 1)
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "calls": launches[name] // per_call,
                        "max_abs_err": err, "ms": ms, "row_ms": row_ms,
                        "row_host_ms": host_ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
                        "library_row_ms": lib_row_ms, "kernel": kernel_fn(name),
                        **({"device_ms": device_ms[case]} if case in device_ms else {})})
    # rule 2's second key: calls on the path x (ms in a row - bound), in the
    # unit of the time beside it
    score = sorted(((k["calls"] * (k["row_ms"] - k["bound_ms"]), k["name"]) for k in kernels),
                   reverse=True)
    log("calls x (row_ms - bound_ms): "
        + ", ".join(f"{name} {ms:.1f}" for ms, name in score[:16]))
    idle = [k["name"] for k in kernels if k["launches"] <= 0]
    check(not idle, f"kernels the paths never launched: {idle}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
