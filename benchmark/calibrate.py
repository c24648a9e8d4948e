"""Readings the output check's limits are set from, in one process.

    python benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 --seconds 2

For each of ``--seeds``: one run of the cell as ``run.py`` makes it (a
short window), its check's numbers.  For each of ``--control-seeds``: the
control, the reference put in the program's place one precision lower
(the model family's ``control_lm`` and ``train_controls``), judged by the
same comparison; for a train cell also the planted faults the family's
``train_controls`` names.  One JSON line a reading; the benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def control_serve(cell, cfg, kind, seed: int, device):
    import numpy as np

    from benchmark.core import registry
    from benchmark.core.serve import compare
    from benchmark.core.weights import dequantize_params, make_weights, quantize_params
    from benchmark.reference.beam import beam_search

    family = registry.family_of(cfg)
    model, serve, tp = cfg["model"], cfg["serve"], cell["traffic"]
    traffic = kind.build(tp, model, seed)
    kanas = traffic.job(0)
    rng = np.random.default_rng([seed, 5])
    longest = max(kanas, key=len)
    sample = [longest] + [kanas[i] for i in rng.choice(len(kanas), tp["check_sentences"] - 1,
                                                       replace=False)]
    leaves = family.leaves(model)
    weights = make_weights(leaves, cfg["weights"], seed, device)
    ref = family.reference_lm(dequantize_params(quantize_params(weights, leaves), leaves), model)
    ctrl = family.control_lm(weights, model)
    M, N = serve["max_word_len"], tp["max_nodes_per_frame"]
    served = [(s, [w for w, _ in nodes]) for s, nodes in
              beam_search(ctrl, sample, traffic.lexicon, serve["beam_width"], M, N, device)]
    return compare(ref, [(k, None) for k in sample], traffic.lexicon, serve["beam_width"], M, N,
                   device, 0, cell["limits"], served=served)


def control_train(cell, cfg, kind, seed: int, device):
    from benchmark.core import registry
    from benchmark.core.weights import flatten, make_weights
    from benchmark.reference.train import compare_steps

    family = registry.family_of(cfg)
    model, tsec, tp = cfg["model"], cfg["train"], cell["traffic"]
    traffic = kind.build(tp, model, seed)
    init = flatten(make_weights(family.leaves(model), cfg["weights"], seed, device))
    ids = traffic.ids(-1, tp["setup_steps"])
    ref = family.reference_steps(init, model, tsec, ids, tp, device)
    out = {}
    for name, kw in family.train_controls().items():
        r = family.reference_steps(init, model, tsec, ids, tp, device, **kw)
        out[name] = compare_steps(r["losses"], r["grad1"], r["delta"], ref)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args()

    import torch

    from benchmark.core import registry, run_cell

    if not torch.cuda.is_available():
        sys.exit("no CUDA card")
    device = torch.device("cuda", 0)
    torch.set_num_threads(1)
    cell = registry.workload(args.workload)
    cfg = registry.config(cell["config"])
    kind = registry.traffic(cell["traffic"]["kind"])
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        out = run_cell.run(cell, cfg, kind, seed, args.seconds, False, device,
                           time.perf_counter(), os.path.join(ROOT, "build", "native"))
        print(json.dumps({"seed": seed, "program": {k: c["value"] for k, c in out["checks"].items()},
                          "metrics": {k: v for k, (v, _) in out["metrics"].items()}}), flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
    control = control_serve if kind.RUNNER == "serve" else control_train
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        got = control(cell, cfg, kind, seed, device)
        if kind.RUNNER == "serve":
            got = {"control": {k: c["value"] for k, c in got.items()}}
        print(json.dumps({"seed": seed, **got}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
