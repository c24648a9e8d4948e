"""The reference agrees with the port's plain path at a tiny size on the CPU,
and a sound run of each cell kind reads inside its limits."""

import numpy as np
import pytest
import torch

from benchmark.core import program, registry
from benchmark.core.weights import flatten, make_weights
from benchmark.data.lexicon import synthetic_lexicon
from benchmark.data.synthetic import generate_test_set
from benchmark.reference.beam import beam_search, rescore
from benchmark.reference.lstm import RefLM, reference_steps
from benchmark.reference.train import compare_steps
from benchmark.tests.conftest import TINY_DSOFTMAX, TINY_MODEL, run_tiny, tiny_cell

SCALES = {"embedding": 1.0, "lstm_W": 0.3, "lstm_b": 0.1, "head_W": 0.5, "head_b": 0.5}
CPU = torch.device("cpu")
LSTM = registry.family("lstm")


@pytest.mark.parametrize("model", [TINY_MODEL, TINY_DSOFTMAX], ids=["full", "dsoftmax"])
def test_beam_search_equals_the_ports_fp32_path(model):
    """The port's fp32 parity decoder (plain torch on the CPU) and the
    reference find the same top paths, with scores within 1e-4."""
    lex = synthetic_lexicon(model["vocab_size"])
    weights = make_weights(LSTM.leaves(model), SCALES, 31, CPU)
    serve = {"beam_width": 6, "n_best_max": 1, "max_word_len": 5, "max_kana_len": 62,
             "max_lookahead": 64}
    config = LSTM.make_config(model, serve, max_nodes_per_frame=16)
    dec = LSTM.make_decoder(weights, lex, config, "highest", CPU)
    kanas = [k for k, _ in generate_test_set(24, seed=3)]
    got = dec.decode_batch(kanas)
    ref = beam_search(RefLM(weights, model), kanas, lex, 6, 5, 16, CPU)
    for r, (score, nodes) in zip(got, ref):
        assert [w for _, w in r[0].segments] == [w for w, _ in nodes]
        assert r[0].score == pytest.approx(score, abs=1e-4)
    rescored = rescore(RefLM(weights, model), [[w for w, _ in n] for _, n in ref], CPU)
    np.testing.assert_allclose(rescored, [s for s, _ in ref], atol=1e-4)


def test_training_steps_equal_the_ports_plain_path():
    """Three steps of the port's trainer on its plain path (fp32, no fused
    CE, no scan kernels) and of the reference: losses, first gradient and
    the change after three steps agree to rounding."""
    model = TINY_MODEL
    cell, cfg, kind = tiny_cell("train.jlm50k.b256x32")
    tp = cell["traffic"]
    train = dict(cfg["train"], fused_ce=False, use_pallas_scan=False)
    config = LSTM.make_config(model, train, batch_size=tp["batch"], num_steps=tp["window"])
    weights = make_weights(LSTM.leaves(model), SCALES, 17, CPU)
    init = {k: v.clone() for k, v in flatten(weights).items()}
    trainer = LSTM.make_trainer(config, weights, CPU)
    ids = kind.build(tp, model, 17).ids(-1, 3)
    losses, grad1 = [], None
    for k, (loss, _) in enumerate(trainer.train_steps(ids, epoch=0)):
        losses.append(float(loss))
        if k == 0:
            grad1 = {n: m / (1 - program.ADAM_B1) for n, m in trainer.opt_state.mu.items()}
    delta = {n: p.detach() - init[n] for n, p in trainer.flat.items()}
    got = compare_steps(losses, grad1, delta, reference_steps(init, model, train, ids, tp, CPU))
    assert got["loss_gap"] < 1e-5 and got["grad_gap"] < 1e-4 and got["update_gap"] < 1e-4


@pytest.mark.parametrize("name", ["serve.jlm50k.synthetic.s2048", "serve.jlm100k.realistic.s2048",
                                  "train.jlm50k.b256x32"])
def test_a_sound_run_is_correct(name):
    from benchmark.core.run_cell import correct

    cell, cfg, kind = tiny_cell(name)
    out = run_tiny(cell, cfg, kind)
    assert correct(out["checks"]), out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


def test_a_dsoftmax_run_is_correct():
    from benchmark.core.run_cell import correct

    cell, cfg, kind = tiny_cell("serve.jlm100k.realistic.s2048", TINY_DSOFTMAX)
    out = run_tiny(cell, cfg, kind)
    assert correct(out["checks"]), out["checks"]
