"""The output check fails a run whose timed path is broken underneath, and
fails the control (the reference one precision lower in the program's
place).  The harness's look for a card is skipped: the runs are the CPU's,
at a test's size; the card tests run the same at the cells' own size."""

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark.core import registry
from benchmark.core.run_cell import correct
from benchmark.tests.conftest import run_tiny, tiny_cell

SERVE = "serve.jlm50k.synthetic.s2048"
TRAIN = "train.jlm50k.b256x32"


def _alter_blob(column_fn):
    """Wrap the engine's device search so the result blob it produces is
    altered: ``column_fn(blob)`` edits it in place."""
    from jlm_tpu_torch.decoder import engine

    orig = engine._decode_scan

    def scan(*args, **kwargs):
        out = orig(*args, **kwargs)
        if "blob" in out:
            column_fn(out["blob"])
        return out
    return engine, "_decode_scan", scan


def score_raised(blob):
    blob[:, 0] = (blob[:, 0].view(torch.float32) + 1.0).view(torch.int32)


def token_altered(blob):
    blob[:, 4] = blob[:, 4] + 1  # the node index of each top path's last word


def state_unchanged():
    from jlm_tpu_torch.decoder import engine

    def cell(x, h, c, *args, compute_dtype=None, c_out_dtype=None, **kwargs):
        return c.to(c_out_dtype or c.dtype), h.to(compute_dtype or h.dtype)
    return engine, "lstm_cell_step", cell


def half_the_batch_dropped():
    from jlm_tpu_torch.decoder.engine import BeamDecoder

    orig = BeamDecoder.materialize

    def materialize(self, kanas, packed, out, n_best=1):
        res = orig(self, kanas, packed, out, n_best)
        return res[:len(res) // 2] + [[] for _ in res[len(res) // 2:]]
    return BeamDecoder, "materialize", materialize


def optimizer_skipped():
    from jlm_tpu_torch.train import optim

    return optim, "apply_gradients", lambda *args, **kwargs: None


def loss_over_half_the_batch():
    from jlm_tpu_torch.train import trainer

    orig = trainer.full_softmax_loss

    def loss(params, config, hs, targets, *args, **kwargs):
        half = hs.shape[0] // 2
        return orig(params, config, hs[:half], targets[:half], *args, **kwargs)
    return trainer, "full_softmax_loss", loss


FAULTS = {
    "serve: a score altered where it is produced": (SERVE, lambda: _alter_blob(score_raised)),
    "serve: a token altered where it is produced": (SERVE, lambda: _alter_blob(token_altered)),
    "serve: a step returns its state unchanged": (SERVE, state_unchanged),
    "serve: half of the batch left out": (SERVE, half_the_batch_dropped),
    "train: a step returns its state unchanged": (TRAIN, optimizer_skipped),
    "train: half of the batch left out, the mean over the rest": (TRAIN,
                                                                  loss_over_half_the_batch),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    name, plant = FAULTS[fault]
    cell, cfg, kind = tiny_cell(name)
    owner, attr, broken = plant()
    monkeypatch.setattr(owner, attr, broken)
    out = run_tiny(cell, cfg, kind)
    assert not correct(out["checks"]), out["checks"]


# the control at a size a test run holds: the widths of the cells, a small
# vocabulary and few sentences
CONTROL_MODEL = {"vocab_size": 3000, "embed_size": 256, "hidden_size": 512, "num_layers": 1,
                 "forget_bias": 1.0, "head": "full"}


@pytest.mark.parametrize("name", [SERVE, TRAIN])
def test_the_control_is_not_correct(name):
    from benchmark import calibrate

    cell, cfg, kind = tiny_cell(name, CONTROL_MODEL)
    if kind.RUNNER == "serve":
        checks = calibrate.control_serve(cell, cfg, kind, 2001, torch.device("cpu"))
    else:
        got = calibrate.control_train(cell, cfg, kind, 2001, torch.device("cpu"))["control"]
        checks = {k: {"value": v, "limit": cell["limits"][k]} for k, v in got.items()}
    assert not correct(checks), checks


@pytest.mark.cuda
@pytest.mark.parametrize("name", registry.names("workloads"))
def test_cells_on_the_card(name, card):
    """Each cell as run.py runs it, a short window: correct, every key there."""
    got = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed",
                          "2147483659", "--seconds", "3", "--trace", "0"], cwd=registry.ROOT,
                         capture_output=True, text=True, timeout=900)
    assert got.returncode == 0, got.stderr[-4000:]
    line = json.loads(got.stdout.strip().splitlines()[-1])
    assert line["correct"] and list(line)[-1] == "checks"


@pytest.mark.cuda
@pytest.mark.parametrize("name", registry.names("workloads"))
def test_the_control_on_the_card(name, card):
    """The control at the cell's own size on the card is not correct."""
    from benchmark import calibrate

    cell = registry.workload(name)
    cfg = registry.config(cell["config"])
    kind = registry.traffic(cell["traffic"]["kind"])
    if kind.RUNNER == "serve":
        checks = calibrate.control_serve(cell, cfg, kind, 2001, card)
    else:
        got = calibrate.control_train(cell, cfg, kind, 2001, card)["control"]
        checks = {k: {"value": v, "limit": cell["limits"][k]} for k, v in got.items()}
    assert not correct(checks), checks
