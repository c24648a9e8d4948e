"""Train cells: ``Trainer.train_steps`` over BPTT windows.

Set-up makes the fp32 weights from the seed, builds one trainer and drives
it through ``setup_steps`` windows by the window's own call, keeping what
the output check reads: each step's loss, the first step's gradient (from
Adam's first moment after one step, ``mu = (1 - b1) g``) and the
parameters after the last set-up step.  The timed window hands the same
trainer call after call until ``seconds`` have passed, then waits for the
device.  The reference then follows the set-up steps from the same weights.
"""

from __future__ import annotations

import gc
import time
from typing import Any, Dict, List

import torch

from benchmark.core import program
from benchmark.core.trace import Recorder, Trace, reduce_profile
from benchmark.core.weights import flatten, make_weights
from benchmark.reference.train import compare_steps, reference_steps


def _ce_shape(tag):
    def shape(h, W, *args, **kwargs):
        return (tag, int(h.shape[0]), int(h.shape[1]), int(W.shape[1]))
    return shape


def _scan_shape(tag):
    def shape(xs, W, b, c0, h0, *args, **kwargs):
        return (tag, int(xs.shape[0]), int(xs.shape[1]), int(xs.shape[2]), int(h0.shape[-1]))
    return shape


SHAPES = {("softmax_ce", "ce_loss_fused"): _ce_shape("fwd"),
          ("softmax_ce", "ce_bwd"): _ce_shape("bwd"),
          ("lstm_scan", "lstm_scan_fwd"): _scan_shape("fwd"),
          ("lstm_scan", "lstm_scan_bwd"): _scan_shape("bwd")}


def useful_ops(model: Dict[str, Any], tp: Dict[str, Any], steps: int) -> Dict[str, float]:
    """A step's forward and backward of every layer's cell over the window
    (fp32: the forward's product, the backward's dx/dh and dW) and of the
    head (bf16: the logits, dh and dW once each)."""
    E, H, L, V = (model["embed_size"], model["hidden_size"], model["num_layers"],
                  model["vocab_size"])
    N = tp["batch"] * tp["window"]
    cell = sum(3 * 2 * N * ((E if l == 0 else H) + H) * 4 * H for l in range(L))
    return {"fp32": float(cell * steps), "bf16": float(3 * 2 * N * H * V * steps)}


def run(cell: Dict[str, Any], cfg: Dict[str, Any], traffic, seed: int, seconds: float,
        trace: bool, device, t_start: float, build_dir: str) -> Dict[str, Any]:
    model, tsec, tp = cfg["model"], cfg["train"], cell["traffic"]
    config = program.make_config(model, tsec, batch_size=tp["batch"], num_steps=tp["window"])
    weights = make_weights(model, cfg["weights"], seed, device)
    init = flatten(weights)  # the trainer copies its leaves: these stay as made
    trainer = program.make_trainer(config, weights, device)
    setup_ids = traffic.ids(-1, tp["setup_steps"])
    losses: List[torch.Tensor] = []
    for k, (loss, _) in enumerate(trainer.train_steps(setup_ids, epoch=0)):
        losses.append(loss.clone())
        if k == 0:
            grad1 = {n: m.detach() / (1 - program.ADAM_B1)
                     for n, m in program.first_moments(trainer).items()}
    after = {n: p.detach().clone() for n, p in program.flat_params(trainer).items()}
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    sync()
    setup_s = time.perf_counter() - t_start
    gc.collect()
    gc.freeze()  # set-up's objects out of the collector's walks

    rec = Recorder()
    if trace:
        for owner, attr, label in program.train_patch_points():
            rec.wrap(owner, attr, label, SHAPES.get((label, attr)))
        rec.timing = True
    steps, call = 0, 0
    t0 = time.perf_counter()
    done = False
    while not done:
        for _ in trainer.train_steps(traffic.ids(call, tp["steps_per_call"]), epoch=0):
            steps += 1
            if time.perf_counter() - t0 >= seconds:
                done = True
                break
        call += 1
    sync()
    window = time.perf_counter() - t0
    gc.unfreeze()
    rec.timing = False
    tokens = steps * tp["batch"] * tp["window"]
    out: Dict[str, Any] = {"attempted": steps, "failed": 0, "setup_s": setup_s,
                           "metrics": {"tokens_per_s": (tokens / window, "tokens/s"),
                                       "setup_s": (setup_s, "s")},
                           "steps": steps, "window_s": window}
    if trace:
        out["trace"] = _profile(rec, trainer, traffic, cell, cfg, steps, window, device)
    rec.restore()
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0)
    del trainer
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    ref = reference_steps(init, model, tsec, setup_ids, tp, device)
    readings = compare_steps([float(l) for l in losses], grad1,
                             {n: after[n] - init[n] for n in init}, ref)
    out["checks"] = {k: {"value": v, "limit": cell["limits"][k]} for k, v in readings.items()}
    out["check_s"] = time.perf_counter() - t_check
    return out


def _profile(rec: Recorder, trainer, traffic, cell, cfg, steps0: int, timed_s: float,
             device) -> Trace:
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark.core.peaks import peaks

    tp = cell["traffic"]
    n = tp["profile_steps"]
    ids = traffic.ids(1 << 20, n)
    torch.cuda.synchronize(device)
    rec.profiling = True
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("bench::window"):
            for _ in trainer.train_steps(ids, epoch=0):
                pass
            torch.cuda.synchronize(device)
    rec.profiling = False
    return Trace(kind="train", model=cfg["model"], spans=dict(rec.spans), calls=dict(rec.calls),
                 timed_units={"steps": steps0}, timed_s=timed_s, profiled_units={"steps": n},
                 useful_ops=useful_ops(cfg["model"], tp, n), peaks=peaks(device.index or 0),
                 device=reduce_profile(prof))
