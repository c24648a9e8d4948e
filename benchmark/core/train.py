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
from benchmark.reference.train import compare_steps


def run(cell: Dict[str, Any], cfg: Dict[str, Any], family, traffic, seed: int, seconds: float,
        trace: bool, device, t_start: float, build_dir: str) -> Dict[str, Any]:
    model, tsec, tp = cfg["model"], cfg["train"], cell["traffic"]
    if family.reference_steps is None:
        raise ValueError(f"model family of {cfg['name']!r} has no training reference")
    config = family.make_config(model, tsec, batch_size=tp["batch"], num_steps=tp["window"])
    weights = make_weights(family.leaves(model), cfg["weights"], seed, device)
    init = flatten(weights)  # the trainer copies its leaves: these stay as made
    trainer = family.make_trainer(config, weights, device)
    setup_ids = traffic.ids(-1, tp["setup_steps"])
    losses: List[torch.Tensor] = []
    for k, (loss, _) in enumerate(trainer.train_steps(setup_ids, epoch=0)):
        losses.append(loss.clone())
        if k == 0:
            grad1 = {n: m.detach() / (1 - program.ADAM_B1)
                     for n, m in family.first_moments(trainer).items()}
    after = {n: p.detach().clone() for n, p in family.flat_params(trainer).items()}
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    sync()
    setup_s = time.perf_counter() - t_start
    gc.collect()
    gc.freeze()  # set-up's objects out of the collector's walks

    rec = Recorder()
    if trace:
        for owner, attr, label, shape in family.train_patch_points():
            rec.wrap(owner, attr, label, shape)
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
        out["trace"] = _profile(rec, trainer, family, traffic, cell, cfg, steps, window, device)
    rec.restore()
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0)
    del trainer
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    ref = family.reference_steps(init, model, tsec, setup_ids, tp, device)
    readings = compare_steps([float(l) for l in losses], grad1,
                             {n: after[n] - init[n] for n in init}, ref)
    out["checks"] = {k: {"value": v, "limit": cell["limits"][k]} for k, v in readings.items()}
    out["check_s"] = time.perf_counter() - t_check
    return out


def _profile(rec: Recorder, trainer, family, traffic, cell, cfg, steps0: int, timed_s: float,
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
    return Trace(kind="train", head_blocks=family.head_blocks(cfg["model"]),
                 spans=dict(rec.spans), calls=dict(rec.calls),
                 timed_units={"steps": steps0}, timed_s=timed_s, profiled_units={"steps": n},
                 useful_ops=family.train_ops(cfg["model"], tp, n), peaks=peaks(device.index or 0),
                 device=reduce_profile(prof))
