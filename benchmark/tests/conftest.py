"""Shared pieces of the benchmark's tests: tiny copies of the cells for the
CPU, and the card fixture (the card is looked for here, never at import)."""

import copy
import time

import pytest

TINY_MODEL = {"vocab_size": 400, "embed_size": 32, "hidden_size": 64, "num_layers": 1,
              "forget_bias": 1.0, "head": "full"}
TINY_DSOFTMAX = {"vocab_size": 400, "embed_size": 32, "hidden_size": 64, "num_layers": 2,
                 "forget_bias": 1.0, "head": "dsoftmax",
                 "dsoftmax": {"block_sizes": [64, 136, 200], "block_dims": [64, 32, 16],
                              "mode": "prefix"}}


def tiny_cell(name: str, model=None):
    """The workload ``name`` and its configuration cut to a CPU test's size
    (the widths above, a few dozen sentences or a few windows)."""
    from benchmark.core import registry

    cell = copy.deepcopy(registry.workload(name))
    cfg = copy.deepcopy(registry.config(cell["config"]))
    cfg["model"] = dict(model or TINY_MODEL)
    tp = cell["traffic"]
    if tp["kind"] == "serve_stream":
        tp.update(pool_sentences=300, job_sentences=24, chunk_size=16, warm_jobs=1,
                  profile_jobs=1, check_sentences=12)
        if tp["lexicon"] == "realistic":
            tp.update(lexicon_words=cfg["model"]["vocab_size"])
    else:
        tp.update(batch=4, window=8, steps_per_call=4, profile_steps=2)
    return cell, cfg, registry.traffic(tp["kind"])


def run_tiny(cell, cfg, kind, seed=1234567890123, seconds=0.5):
    import torch

    from benchmark.core import run_cell

    return run_cell.run(cell, cfg, kind, seed, seconds, False, torch.device("cpu"),
                        time.perf_counter(), _build_dir())


def _build_dir():
    import os

    from benchmark.core.registry import ROOT

    return os.path.join(ROOT, "build", "native")


@pytest.fixture
def card():
    """The CUDA device; the test is skipped where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
