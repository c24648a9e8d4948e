#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``jlm_tpu_torch``) on one GPU.

Run from the repository root on a machine with one Hopper card and the CUDA
toolkit:  ``python3 chip_smoke.py``.  Phases, none of them caught:

1. print the card, its power limit, the torch/CUDA versions, and build the
   kernels from ``jlm_tpu_torch/csrc`` with nvcc (sm_90a);
2. compare each kernel with its plain PyTorch version on the card at the
   shapes its path gives it, with a stated bound, and time both (CUDA
   events): the three decode kernels at the serving shapes, the three
   fused-CE kernels at the training shapes, and the D-softmax fused CE
   at the 100k D-softmax head; each backward bound is also shown to
   catch a deliberately wrong p-term (see ``P_SHIFT``);
3. drive the serving path — streaming beam-10 conversion at V=50,000,
   E=256, H=512, one layer, int8 head, speed mode — over one 2,048-lattice
   chunk through ``BeamDecoder.decode_stream``, and check that every decode
   kernel was launched by it;
4. check top-1 path identity against the numpy oracle on the 50 test
   sentences: fp32 greedy, int8 beam-10, and bf16 beam-10 (50/50 each);
5. drive the training path — ``Trainer`` at the same width, batch 32, BPTT
   window 32, Adam, fused CE — for 20 steps over the synthetic corpus, once
   through the CE kernels and once with each swapped for its plain
   version: the loss falls, the two runs agree, every CE kernel was
   launched once per forward or backward, and dev perplexity agrees;
6. save the trained weights, reload the checkpoint, and decode the 50
   sentences fp32 greedy: 50/50 top-1 identity with the oracle on them.

Weights are random (``init_params`` seed 0) before training.  The last line
is ``{"ok": true, "device": {...}}``; any failure exits non-zero before it.
No JAX is imported (the oracle is numpy).
"""

from __future__ import annotations

import contextlib
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
# training shapes: batch 32 x BPTT window 32 = 1,024 CE rows per step
TB, TT, TRAIN_STEPS = 32, 32, 20
N_CE = TB * TT
BOUNDS = {  # kernel vs plain version, on the same inputs on the card
    "project_lse int8": 1e-4,   # abs, lse; the int32 product is exact
    "project_lse bf16": 1e-3,   # abs, lse; fp32 sums in another order
    "lstm_cell_step bf16": 2.0,  # bf16 ulps of c' and h' (see bf16_ulps)
    "cand_dot bf16": 1e-3,      # abs error / max(1, max |plain|)
    "ce_fwd bf16": 1e-3,        # abs, per-row loss and lse; fp32 sums in another order
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
}
# lse + P_SHIFT in the plain backward: a p-term exp(-0.3) = 0.74 of its value
P_SHIFT = 0.3
DSOFTMAX_BOUNDS = {  # the D-softmax fused CE (bf16 compute) at the 100k head
    "loss vs fp32": 1e-3,    # abs, mean loss, vs fp32 plain CE over the logits
    "grads vs fp32": 1e-2,   # abs error / max |plain| of hs and every block's W
                             # and b: bf16 rounding; checks the block merge and
                             # the one-hot term, too loose for the p-term
    "grads vs plain": 1e-4,  # the same code through the plain versions: as
    "p-term grads vs plain": 2e-3,  # the ce_bwd_* cases (p-term: no block
                                    # owns a target, random row weights)
}
TRAIN_BOUNDS = {  # the CE kernels' run vs the plain versions' run
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
    for their plain versions, where the fused CE's autograd Functions look
    them up.  With ``lse_shift`` the backward ones compute a wrong p-term,
    ``exp(l - lse - lse_shift)``, which a bound must catch."""
    from jlm_tpu_torch.ops import softmax_ce as ce

    kernels = ce.ce_fwd_raw, ce.ce_bwd_dh, ce.ce_bwd_dw

    def shifted(ref):
        return lambda h, W, b, y, lse, *rest: ref(h, W, b, y, lse + lse_shift, *rest)

    ce.ce_fwd_raw = ce.ce_fwd_raw_ref
    ce.ce_bwd_dh, ce.ce_bwd_dw = shifted(ce.ce_bwd_dh_ref), shifted(ce.ce_bwd_dw_ref)
    try:
        yield
    finally:
        ce.ce_fwd_raw, ce.ce_bwd_dh, ce.ce_bwd_dw = kernels


def rel_err(got, want):
    """Max over the tensor pairs of max |got - want| / max |want|."""
    return max(float((a.float() - w.float()).abs().max()) / float(w.abs().max())
               for a, w in zip(got, want))


def kernel_cases(dev, rng):
    """(name, kernel call, plain call, error fn, wrong call or None) per
    case; the error fn returns (the bounded metric, the max absolute
    error); the wrong call is the plain version with a p-term off by
    ``P_SHIFT``."""
    from jlm_tpu.ops.quant import quantize_weight
    from jlm_tpu_torch.ops.cand_dot import cand_dot, cand_dot_ref
    from jlm_tpu_torch.ops.lstm_cell import lstm_cell_ref, lstm_cell_step
    from jlm_tpu_torch.ops.project import project_lse, project_lse_ref
    from jlm_tpu_torch.ops.softmax_ce import (
        ce_bwd_dh, ce_bwd_dh_ref, ce_bwd_dw, ce_bwd_dw_ref, ce_fwd_raw, ce_fwd_raw_ref)

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

    def abs_err(k, p):
        return float((k.float() - p.float()).abs().max())

    def lse_err(k, p):
        return abs_err(k, p), abs_err(k, p)

    def cell_plain():
        c_new, h_new = lstm_cell_ref(x, h, c, Wc, bc, 1.0)
        return c_new.to(bf), h_new.to(bf)

    def cell_err(k, p):
        return (max(bf16_ulps(k[0], p[0]), bf16_ulps(k[1], p[1])),
                max(abs_err(k[0], p[0]), abs_err(k[1], p[1])))

    def cand_err(k, p):
        return abs_err(k, p) / max(1.0, float(p.abs().max())), abs_err(k, p)

    def ce_fwd_err(k, p):
        (mk, sk, tk), (mp, sp, tp) = k, p
        lse_k, lse_p = mk + torch.log(sk), mp + torch.log(sp)
        err = max(abs_err(lse_k - tk, lse_p - tp), abs_err(lse_k, lse_p))
        return err, err

    def bwd_err(k, p):
        k, p = (k, p) if isinstance(k, tuple) else ((k,), (p,))
        return rel_err(k, p), max(abs_err(a, b) for a, b in zip(k, p))

    bwd_cases = []
    for suffix, (g_a, g_b) in cotangents.items():
        args = (h_ce, W_ce, b_ce, y_ce, lse_ce, g_a, g_b, bf)
        wrong = (h_ce, W_ce, b_ce, y_ce, lse_ce + P_SHIFT, g_a, g_b, bf)
        for name, kernel, ref in (("ce_bwd_dh", ce_bwd_dh, ce_bwd_dh_ref),
                                  ("ce_bwd_dw", ce_bwd_dw, ce_bwd_dw_ref)):
            bwd_cases.append((f"{name} bf16{suffix}", lambda k=kernel, a=args: k(*a),
                              lambda r=ref, a=args: r(*a), bwd_err,
                              lambda r=ref, a=wrong: r(*a)))

    return [
        ("project_lse int8",
         lambda: project_lse(h, head_q, None, compute_dtype=bf, int8_mxu=True),
         lambda: project_lse_ref(h, Wq, head_q["W"]["scale"], bias,
                                 compute_dtype=bf, int8_mxu=True),
         lse_err, None),
        ("project_lse bf16",
         lambda: project_lse(h, head_b, None, compute_dtype=bf),
         lambda: project_lse_ref(h, Wb, None, bias, compute_dtype=bf),
         lse_err, None),
        ("lstm_cell_step bf16",
         lambda: lstm_cell_step(x, h, c, Wc, bc, 1.0, compute_dtype=bf,
                                c_out_dtype=bf),
         cell_plain, cell_err, None),
        ("cand_dot bf16",
         lambda: cand_dot(h3, cols, cbias),
         lambda: cand_dot_ref(h3, cols, cbias),
         cand_err, None),
        ("ce_fwd bf16",
         lambda: ce_fwd_raw(h_ce, W_ce, b_ce, y_ce, bf),
         lambda: ce_fwd_raw_ref(h_ce, W_ce, b_ce, y_ce, bf),
         ce_fwd_err, None),
    ] + bwd_cases


def dsoftmax_case(dev, rng):
    """The D-softmax fused CE (one kernel call per block on its hidden
    slice) at the 100k head of BASELINE config 5: the mean loss and the
    grads of hs and every block against plain fp32 CE over ``head_logits``
    and against the same code through the plain versions, and the grads of
    the p-term alone (no block owns a target; random row weights) against
    the plain versions.  Returns ``{reading: (value, reading of a p-term
    off by P_SHIFT or None)}``, kernel ms and plain fp32 CE ms."""
    from jlm_tpu.config import Config, default_dsoftmax_blocks
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


def bench_data():
    """The bench's config, vocab, lexicon, weights and 50 test sentences."""
    from jlm_tpu.config import Config
    from jlm_tpu.data import Lexicon, build_vocab, generate_corpus, generate_test_set
    from jlm_tpu.models.params import init_params
    from jlm_tpu.ops.quant import quantize_params

    config = Config(vocab_size=V, embed_size=E, hidden_size=H, num_layers=1,
                    beam_width=10, n_best_max=1, seed=0)
    vocab = build_vocab(generate_corpus(2000, seed=1234), config.vocab_size)
    lexicon = Lexicon.from_vocab(vocab)
    params = init_params(config)
    kanas = [k for k, _ in generate_test_set(50, seed=777)]
    return config, vocab, lexicon, params, quantize_params(params), kanas


def training_corpus(vocab):
    """Train ids for exactly TRAIN_STEPS windows of TB x TT and dev ids for
    4 windows, encoded from the synthetic corpus with the serving vocab."""
    from jlm_tpu.data import encode_corpus, generate_corpus, split_corpus

    train, dev, _ = split_corpus(encode_corpus(generate_corpus(16_000, seed=1234), vocab))
    n_train, n_dev = N_CE * TRAIN_STEPS + 1, N_CE * 4 + 1
    check(len(train) >= n_train and len(dev) >= n_dev, "training corpus too small")
    return train[:n_train], dev[:n_dev]


CE_COUNTERS = ("ce_fwd", "ce_bwd_dh", "ce_bwd_dw")


def training_run(dev, config, params, train_ids, dev_ids, plain: bool):
    """TRAIN_STEPS ``Trainer`` steps from ``params``; the CE kernels (or,
    with ``plain``, their plain versions).  Returns the trainer, the
    per-step losses, ms per step (steps 2 on, host clock ending in a
    synchronize), the CE launch counts of the steps, and dev perplexity."""
    from jlm_tpu_torch.ops import softmax_ce as ce
    from jlm_tpu_torch.train import Trainer

    counters = dict(zip(CE_COUNTERS, (ce.ce_fwd_raw, ce.ce_bwd_dh, ce.ce_bwd_dw)))
    trainer = Trainer(config, params, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    with plain_ce() if plain else contextlib.nullcontext():
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
    log(f"training ({'plain versions' if plain else 'CE kernels'}): {len(losses)} steps, "
        f"loss {losses[0]:.6f} -> {losses[-1]:.6f}; {ms:.3f} ms/step, "
        f"{N_CE / ms * 1e3:.1f} tokens/s; launches {launches}; peak device memory "
        f"{peak:.2f} GiB; dev ppl {ppl:.4f}")
    return trainer, losses, ms, launches, ppl


def identical(results, oracle_results) -> int:
    return sum(r[0].segments == o.segments for r, o in zip(results, oracle_results))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; needs one CUDA card",
              file=sys.stderr)
        return 1
    from jlm_tpu.oracle import OracleDecoder, OracleLM
    from jlm_tpu_torch.decoder.engine import BeamDecoder
    from jlm_tpu_torch.models.params import load_npz_params
    from jlm_tpu_torch.ops import _build
    from jlm_tpu_torch.ops.cand_dot import cand_dot
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
    measured = {}
    wrong_p = f"a p-term {1 - math.exp(-P_SHIFT):.0%} low"
    for name, kernel, plain, err_fn, wrong in kernel_cases(dev, rng):
        want = plain()
        err, max_abs = err_fn(kernel(), want)
        ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
        log(f"{name}: err {err:.3e} (bound {BOUNDS[name]:g}; max abs {max_abs:.3e}), "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        check(err <= BOUNDS[name], f"{name}: error {err} exceeds {BOUNDS[name]}")
        if wrong is not None:
            caught = err_fn(wrong(), want)[0]
            log(f"  {name}: {wrong_p} reads {caught:.3e}")
            check(caught > BOUNDS[name], f"{name}: bound misses {wrong_p} ({caught})")
        measured[name] = (max_abs, ms, plain_ms)
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
    n = identical(greedy.decode_batch(kanas), [oracle.decode(k)[0] for k in kanas])
    log(f"greedy fp32 parity {n}/{len(kanas)} (top-1 path identity vs oracle)")
    check(n == len(kanas), "greedy parity")
    oracle_q = OracleDecoder(OracleLM(qp, config), lexicon, vocab, config)
    n = identical(results[:len(kanas)], [oracle_q.decode(k)[0] for k in kanas])
    log(f"beam-10 int8 parity {n}/{len(kanas)} (kernel path vs int8 oracle)")
    check(n == len(kanas), "int8 beam parity")
    bf16_engine = BeamDecoder(params, lexicon, vocab, config, precision="default",
                              device=dev)
    oracle_f = OracleDecoder(OracleLM(params, config), lexicon, vocab, config)
    n = identical(bf16_engine.decode_batch(kanas),
                  [oracle_f.decode(k)[0] for k in kanas])
    log(f"beam-10 bf16 parity {n}/{len(kanas)} (kernel path vs fp32 oracle)")
    check(n == len(kanas), "bf16 beam parity")
    check("jax" not in sys.modules, "the port imported jax")
    del engine, greedy, bf16_engine
    torch.cuda.empty_cache()

    # ---- phase 5: the training path, CE kernels vs their plain versions ----
    tcfg = config.replace(batch_size=TB, num_steps=TT, fused_ce=True)
    train_ids, dev_ids = training_corpus(vocab)
    trainer, loss_k, ms_k, launches_k, ppl_k = training_run(
        dev, tcfg, params, train_ids, dev_ids, plain=False)
    _, loss_p, ms_p, launches_p, ppl_p = training_run(
        dev, tcfg, params, train_ids, dev_ids, plain=True)
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
    check(launches_k == dict.fromkeys(CE_COUNTERS, TRAIN_STEPS),
          f"CE launches {launches_k}: one forward and one backward per step")
    check(launches_p == dict.fromkeys(CE_COUNTERS, 0), f"plain run launched {launches_p}")
    launches.update(launches_k)

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
    check("jax" not in sys.modules, "the port imported jax")

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
    }
    kernels = []
    for name, (src, replaces, case) in sources.items():
        err, ms, plain_ms = measured[case]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
