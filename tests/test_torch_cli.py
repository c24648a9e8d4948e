"""The port's CLIs (``python -m jlm_tpu_torch.scripts.<name>``) beside their
``scripts/`` originals, on one tiny checkpoint and data dir.

The checkpoint (``init_params``, ``max_kana_len`` 12) is saved through the
port's ``save_checkpoint``; each port CLI runs with ``--device cpu`` and its
original on the same files, and their outputs are compared: the same
stdout lines (conversion, the ceiling), the same summary up to the timing
(evaluation), perplexity within 1e-4 relative, and checkpoints that load
bit-equal through the JAX package.
"""

import os
import pickle
import shutil
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

from jlm_tpu_torch.config import Config  # noqa: E402
from jlm_tpu_torch.data import build_vocab, encode_corpus, generate_corpus, split_corpus  # noqa: E402
from jlm_tpu_torch.data.io import save_dataset  # noqa: E402
from jlm_tpu_torch.models.params import init_params  # noqa: E402
from jlm_tpu_torch.train import save_checkpoint  # noqa: E402

CFG = Config(vocab_size=256, embed_size=32, hidden_size=64, beam_width=4, max_kana_len=12,
             n_best_max=2, batch_size=4, num_steps=8, seed=0)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """(data dir, experiment dir) shared by every CLI."""
    root = tmp_path_factory.mktemp("cli")
    lines = generate_corpus(800, seed=1234)
    vocab = build_vocab(lines, CFG.vocab_size)
    data, exp = str(root / "data"), str(root / "exp")
    save_dataset(data, vocab, *split_corpus(encode_corpus(lines, vocab)))
    save_checkpoint(exp, init_params(CFG), CFG)
    return data, exp


def _run(main, argv, capsys):
    capsys.readouterr()
    main(argv)
    return capsys.readouterr().out.splitlines()


def _long_kana():
    from jlm_tpu_torch.data import generate_test_set

    kana = "".join(k for k, _ in generate_test_set(8, seed=42))[:30]
    assert len(kana) == 30 > CFG.max_kana_len
    return kana


@pytest.mark.parametrize("flags", [[], ["--int8"], ["--incremental", "--n-best", "2"]])
def test_convert(files, capsys, flags):
    """A 30-kana input (past ``max_kana_len``: ``decode_long`` one-shot, the
    window roll incrementally): the same n-best lines."""
    import convert as ref
    from jlm_tpu_torch.scripts import convert

    data, exp = files
    kana = _long_kana() if "--incremental" not in flags else _long_kana()[:14]
    argv = ["--data", data, "--exp", exp, "--kana", kana] + flags
    got = _run(convert.main, argv + ["--device", "cpu"], capsys)
    want = _run(ref.main, argv, capsys)
    assert got == want and got


def test_eval_conversion(files, capsys):
    """The summary's fields equal, ``chars/s`` aside; one test line past
    ``max_kana_len``."""
    import eval_conversion as ref
    from jlm_tpu_torch.data import generate_test_set
    from jlm_tpu_torch.scripts import eval_conversion

    data, exp = files
    pairs = generate_test_set(10, seed=777)
    pairs.append((_long_kana(), "".join(g for _, g in generate_test_set(8, seed=42))))
    test_file = os.path.join(os.path.dirname(exp), "pairs.tsv")
    with open(test_file, "w") as f:
        f.write("".join(f"{k}\t{g}\n" for k, g in pairs))
    argv = ["--data", data, "--exp", exp, "--test-file", test_file, "--n-best", "2"]

    def fields(lines):
        assert len(lines) == 1
        return {k: v for k, v in (kv.split("=") for kv in lines[0].split()) if k != "chars/s"}

    got = fields(_run(eval_conversion.main, argv + ["--device", "cpu"], capsys))
    assert got == fields(_run(ref.main, argv, capsys))
    assert got["sentences"] == "11"


def test_eval_ppl(files, capsys):
    import eval_ppl as ref
    from jlm_tpu_torch.scripts import eval_ppl

    data, exp = files
    for split in ("dev", "test"):
        argv = ["--data", data, "--exp", exp, "--split", split]
        (got,) = _run(eval_ppl.main, argv + ["--device", "cpu"], capsys)
        (want,) = _run(ref.main, argv, capsys)
        assert got.split("=")[0] == want.split("=")[0] == f"{split}_ppl"
        np.testing.assert_allclose(float(got.split("=")[1]), float(want.split("=")[1]),
                                   rtol=1e-4)


def test_export_int8(files, capsys, tmp_path):
    """The port's int8 checkpoint loads through the JAX package bit-equal to
    JAX's ``quantize_params`` of the same weights; the report line is the
    original's."""
    import export_int8 as ref
    from jlm_tpu.ops.quant import quantize_params
    from jlm_tpu.train import load_checkpoint
    from jlm_tpu_torch.scripts import export_int8

    _, exp = files
    exp_p, exp_j = str(tmp_path / "port"), str(tmp_path / "jax")
    shutil.copytree(exp, exp_p)
    shutil.copytree(exp, exp_j)
    (got,) = _run(export_int8.main, ["--exp", exp_p], capsys)
    (want,) = _run(ref.main, ["--exp", exp_j], capsys)
    assert got.replace(exp_p, "") == want.replace(exp_j, "")
    qp, cfg = load_checkpoint(exp_p, tag="int8")
    params, _ = load_checkpoint(exp)
    want_q = quantize_params(params)

    def leaves(t, prefix=""):
        if isinstance(t, dict):
            for k in sorted(t):
                yield from leaves(t[k], f"{prefix}{k}/")
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                yield from leaves(v, f"{prefix}{i}/")
        else:
            yield prefix, np.asarray(t)

    got_l, want_l = dict(leaves(qp)), dict(leaves(want_q))
    assert sorted(got_l) == sorted(want_l)
    for k in got_l:
        assert got_l[k].dtype == want_l[k].dtype, k
        np.testing.assert_array_equal(got_l[k], want_l[k], err_msg=k)
    assert qp["embedding"]["q"].dtype == np.int8
    assert cfg.vocab_size == CFG.vocab_size


@pytest.mark.parametrize("int8", [False, True])
def test_import_reference_weights(capsys, tmp_path, int8):
    """The counterpart of ``test_import_reference_weights_cli``: a TF-style
    export imports to the checkpoint the original writes (the same arrays
    and ``config.json``), and its last stdout line is the path."""
    from jlm_tpu.train.checkpoint import load_checkpoint
    from jlm_tpu_torch.scripts import import_reference_weights as cli
    from scripts import import_reference_weights as ref

    params = init_params(CFG)
    export = {"embedding": np.asarray(params["embedding"]),
              "lstm/kernel": np.asarray(params["lstm"][0]["W"]),
              "lstm/bias": np.asarray(params["lstm"][0]["b"]),
              "softmax_w": np.asarray(params["head"]["W"]),
              "softmax_b": np.asarray(params["head"]["b"])}
    path = tmp_path / "export.pkl"
    with open(path, "wb") as f:
        pickle.dump(export, f)
    args = ["--export", str(path), "--vocab-size", str(CFG.vocab_size),
            "--embed", str(CFG.embed_size), "--hidden", str(CFG.hidden_size)]
    args += ["--int8"] if int8 else []
    exps = [str(tmp_path / "port"), str(tmp_path / "jax")]
    outs = [_run(main, args + ["--exp", e], capsys) for main, e in zip((cli.main, ref.main), exps)]
    assert [o[-1] for o in outs] == [os.path.join(e, "ckpt-latest.npz") for e in exps]
    (p_got, c_got), (_, c_want) = (load_checkpoint(e) for e in exps)
    assert c_got == c_want and c_got.quantize == int8
    with np.load(outs[0][-1]) as got, np.load(outs[1][-1]) as want:
        assert sorted(got.files) == sorted(want.files)
        for k in got.files:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if not int8:
        np.testing.assert_array_equal(p_got["embedding"], params["embedding"])


def test_quality_ceiling(capsys):
    import quality_ceiling as ref
    from jlm_tpu_torch.scripts import quality_ceiling

    argv = ["--n", "60", "--seed", "777"]
    got = _run(quality_ceiling.main, argv, capsys)
    assert got == _run(ref.main, argv, capsys) and len(got) == 5
