"""The port's quality scripts (``python -m jlm_tpu_torch.scripts.eval_quality``
and ``quality_stats``) beside their ``scripts/`` originals, on the CPU.

Each runs at a tiny size (one seed, one epoch, a few hundred sentences,
ten tests) with ``--device cpu``, its original with the same flags, and
their reports are compared: the exact Bayes ceiling and the n-gram
baselines equal; every LM's dev perplexity within 1e-3 relative; the
LMs' accuracies within one test sentence (0.1 at ten tests: the two
trainers' fp32 sums run in other orders, which may flip a near-tie).
``quality_stats`` keeps its fixed config-5 shape (2 layers, E 256, H 512,
the 100k D-softmax head).  Its original picks the shipping seed on 300
hard-coded model-selection sentences, as the port does; here both take
ten, each through its own test-set generator, patched for that seed.
"""

import json
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

ACC_TOL = 0.1  # one of ten test sentences


def _lm_close(got, want):
    assert abs(got["dev_ppl"] / want["dev_ppl"] - 1) < 1e-3
    for name in ("beam10", "greedy"):
        for key in ("top1_acc", "char_acc"):
            assert abs(got[name][key] - want[name][key]) <= ACC_TOL, (name, key)


def _run_original(monkeypatch, module, argv):
    monkeypatch.setattr(sys, "argv", [module.__file__] + argv)
    module.main()


def test_eval_quality(monkeypatch, tmp_path):
    import eval_quality as ref
    from jlm_tpu_torch.scripts import eval_quality

    argv = ["--sentences", "4000", "--tests", "10", "--epochs", "1", "--skip-dsoftmax"]
    p_out, j_out = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    eval_quality.main(argv + ["--out", p_out, "--device", "cpu"])
    _run_original(monkeypatch, ref, argv + ["--out", j_out])
    with open(p_out) as f:
        got = json.load(f)
    with open(j_out) as f:
        want = json.load(f)
    for key in ("corpus_sentences", "test_sentences", "vocab", "bayes_ceiling", "unigram",
                "bigram"):
        assert got[key] == want[key], key
    _lm_close(got["lstm_full"], want["lstm_full"])
    assert got["claims"]["lstm_vs_ceiling_gap"] == pytest.approx(
        want["claims"]["lstm_vs_ceiling_gap"], abs=ACC_TOL)


def test_quality_stats(monkeypatch, tmp_path):
    import jax

    import jlm_tpu.data.synthetic_ctx as j_ctx
    import jlm_tpu_torch.data.synthetic_ctx as p_ctx
    import quality_stats as ref
    from jlm_tpu_torch.scripts import quality_stats

    dev_tests = 10
    argv = ["--sentences", "800", "--tests", "10", "--seeds", "3", "--epochs", "1",
            "--batch-size", "4"]
    p_out, j_out = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    for ctx in (p_ctx, j_ctx):
        monkeypatch.setattr(ctx, "generate_test_set_ctx",
                            lambda n, seed, gen=ctx.generate_test_set_ctx:
                            gen(dev_tests if seed == 31337 else n, seed=seed))
    quality_stats.main(argv + ["--out", p_out, "--exp-root", str(tmp_path / "p_exp"),
                               "--device", "cpu"])
    update = jax.config.update  # the original's persistent compilation cache stays off
    monkeypatch.setattr(jax.config, "update", lambda k, v: None if "cache" in k else update(k, v))
    _run_original(monkeypatch, ref, argv + ["--out", j_out, "--exp-root", str(tmp_path / "j_exp")])
    with open(p_out) as f:
        got = json.load(f)["config5_stats"]
    with open(j_out) as f:
        want = json.load(f)["config5_stats"]
    for key in ("test_sentences", "train_sentences", "epochs", "seeds", "binomial_se_at_0.7",
                "bayes_ceiling", "bigram", "recipe"):
        assert got[key] == want[key], key
    (row_p,), (row_j,) = got["per_seed"], want["per_seed"]
    _lm_close(row_p, row_j)
    assert abs(row_p["beam10_devsel_acc"] - row_j["beam10_devsel_acc"]) <= ACC_TOL
    assert os.path.exists(os.path.join(row_p["exp_dir"], "ckpt-latest.npz"))
