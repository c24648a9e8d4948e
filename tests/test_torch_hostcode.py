"""The port's copies of the JAX package's host code vs the originals.

``jlm_tpu_torch`` keeps its own copies of ``config``, ``data`` (with
``realistic`` and ``synthetic_ctx``), ``decoder.lattice``, the ``native``
lattice builder, ``oracle`` (with ``ngram``), ``ops.quant``,
``init_params``, ``eval`` (``conversion``, ``ceiling``), ``utils.logging``,
``train.import_reference`` and ``parallel.comms_model``; each case here builds the same thing
through both and asserts equality (bit-equal arrays, equal files).
"""

import dataclasses
import os

import numpy as np
import pytest

import jlm_tpu.config as j_config
import jlm_tpu.data as j_data
import jlm_tpu.data.io as j_io
import jlm_tpu.data.streaming as j_streaming
import jlm_tpu.decoder.lattice as j_lattice
import jlm_tpu.models.params as j_params
import jlm_tpu.native as j_native
import jlm_tpu.oracle as j_oracle
import jlm_tpu.ops.quant as j_quant
import jlm_tpu_torch.config as p_config
import jlm_tpu_torch.data as p_data
import jlm_tpu_torch.data.io as p_io
import jlm_tpu_torch.decoder.lattice as p_lattice
import jlm_tpu_torch.models.params as p_params
import jlm_tpu_torch.native as p_native
import jlm_tpu_torch.oracle as p_oracle
import jlm_tpu_torch.ops.quant as p_quant
from jlm_tpu_torch.decoder.engine import pack_lattice_batch

ARGS = dict(vocab_size=256, embed_size=32, hidden_size=64, beam_width=4,
            max_kana_len=30, max_lookahead=48, seed=42)
DS_ARGS = dict(ARGS, head="dsoftmax", num_layers=2)


def _configs(**kw):
    j = j_config.Config(**kw)
    if kw.get("head") == "dsoftmax":
        blocks = j_config.default_dsoftmax_blocks(kw["vocab_size"], kw["hidden_size"])
        j = j.replace(dsoftmax=blocks)
        return j, p_config.Config(**{**kw, "dsoftmax": p_config.DSoftmaxConfig(
            blocks.block_sizes, blocks.block_dims, blocks.mode)})
    return j, p_config.Config(**kw)


def _both(lines_seed=1234):
    """(vocab, lexicon) from the same synthetic corpus, by each package."""
    out = []
    for data in (j_data, p_data):
        lines = data.generate_corpus(800, seed=lines_seed)
        vocab = data.build_vocab(lines, ARGS["vocab_size"])
        out.append((lines, vocab, data.Lexicon.from_vocab(vocab)))
    return out


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    else:
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def case_vocab_lexicon(tmp_path):
    (lj, vj, xj), (lp, vp, xp) = _both()
    assert lj == lp
    assert [t.key for t in vj.tokens] == [t.key for t in vp.tokens]
    assert vj.id_of == vp.id_of
    np.testing.assert_array_equal(vj.counts, vp.counts)
    assert xj.by_reading == xp.by_reading and xj.max_reading_len == xp.max_reading_len
    ids_j, ids_p = j_data.encode_corpus(lj, vj), p_data.encode_corpus(lp, vp)
    np.testing.assert_array_equal(ids_j, ids_p)
    for a, b in zip(j_data.split_corpus(ids_j), p_data.split_corpus(ids_p)):
        np.testing.assert_array_equal(a, b)
    for (xa, ya), (xb, yb) in zip(j_data.bptt_batches(ids_j, 4, 8),
                                  p_data.bptt_batches(ids_p, 4, 8)):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
    assert j_data.generate_test_set(12, seed=777) == p_data.generate_test_set(12, seed=777)


def case_lattices(tmp_path):
    (_, vj, xj), (_, vp, xp) = _both()
    cj, cp = _configs(**ARGS)
    kanas = [k for k, _ in p_data.generate_test_set(12, seed=777)] + ["ゑ", "きょうはいい"]
    lats_p = []
    for kana in kanas:
        a = j_lattice.build_lattice(kana, xj, vj, cj)
        b = p_lattice.build_lattice(kana, xp, vp, cp)
        assert [[dataclasses.astuple(n) for n in f] for f in a.frames] == \
            [[dataclasses.astuple(n) for n in f] for f in b.frames]
        for field in ("node_word", "node_start", "node_mask", "node_cand_idx",
                      "lookahead_words", "lookahead_mask"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=field)
        assert (a.length, a.dropped_nodes) == (b.length, b.dropped_nodes)
        lats_p.append(b)
    packed, lengths = pack_lattice_batch(lats_p)
    assert j_native.available() == p_native.available()
    if p_native.available():
        nj = j_native.NativeLatticeBuilder(xj, cj).pack_batch(kanas)
        np_ = p_native.NativeLatticeBuilder(xp, cp).pack_batch(kanas)
        for a, b, c in zip(nj, np_, (packed, lengths)):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(b, c)


def case_init_params(tmp_path):
    for kw in (ARGS, DS_ARGS):
        cj, cp = _configs(**kw)
        pj, pp = j_params.init_params(cj), p_params.init_params(cp)
        _assert_tree_equal(pj, pp)
        assert j_params.param_spec(pj) == p_params.param_spec(pp)
        _assert_tree_equal(j_params.init_params(cj, seed=3), p_params.init_params(cp, seed=3))


def case_quantize_params(tmp_path):
    for kw in (ARGS, DS_ARGS):
        cj, cp = _configs(**kw)
        qj = j_quant.quantize_params(j_params.init_params(cj))
        qp = p_quant.quantize_params(p_params.init_params(cp))
        _assert_tree_equal(qj, qp)
        _assert_tree_equal(j_quant.dequantize_params(qj), p_quant.dequantize_params(qp))


def case_oracle(tmp_path):
    (_, vj, xj), (_, vp, xp) = _both()
    cj, cp = _configs(**ARGS)
    pj = j_params.init_params(cj)
    dj = j_oracle.OracleDecoder(j_oracle.OracleLM(pj, cj), xj, vj, cj)
    dp = p_oracle.OracleDecoder(p_oracle.OracleLM(p_params.init_params(cp), cp), xp, vp, cp)
    for kana, _ in p_data.generate_test_set(8, seed=777):
        for a, b in zip(dj.decode(kana, n_best=3), dp.decode(kana, n_best=3)):
            assert (a.surface, a.score, a.segments) == (b.surface, b.score, b.segments)


def case_config_json(tmp_path):
    for kw in (ARGS, DS_ARGS, dict(ARGS, use_pallas_scan=True, compute_dtype="bfloat16")):
        cj, cp = _configs(**kw)
        assert cj.to_json() == cp.to_json()
        assert p_config.Config.from_json(cj.to_json()) == cp
        assert j_config.Config.from_json(cp.to_json()) == cj
        assert cj.beam_pad == cp.beam_pad
    for n in range(1, 6):
        assert j_config.baseline_config(n).to_json() == p_config.baseline_config(n).to_json()
    assert j_config.pad_vocab_size(50_001, 4) == p_config.pad_vocab_size(50_001, 4)


def case_data_dirs(tmp_path):
    """A data dir saved by the JAX package, in-memory and streamed, loads
    through the port's ``load_dataset`` to the same arrays."""
    lines, vocab, _ = _both()[0]
    ids = j_data.encode_corpus(lines, vocab)
    train, dev, test = j_data.split_corpus(ids)
    npz_dir = str(tmp_path / "npz")
    j_io.save_dataset(npz_dir, vocab, train, dev, test)
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("\n".join(lines) + "\n", encoding="utf-8")
    bin_dir = str(tmp_path / "bin")
    j_streaming.save_dataset_streamed(bin_dir, str(corpus), ARGS["vocab_size"], use_native=False)
    for d in (npz_dir, bin_dir):
        want = j_io.load_dataset(d)
        got = p_io.load_dataset(d)
        assert [t.key for t in want[0].tokens] == [t.key for t in got[0].tokens]
        for a, b in zip(want[1:], got[1:]):
            np.testing.assert_array_equal(a, b)
    assert os.path.exists(os.path.join(bin_dir, "meta.json"))


def case_eval_conversion(tmp_path):
    """``evaluate_conversion`` over each package's oracle decoder: equal
    counts and n-best accuracy, the same summary up to the timing."""
    import jlm_tpu.eval as j_eval
    import jlm_tpu_torch.eval as p_eval

    (_, vj, xj), (_, vp, xp) = _both()
    cj, cp = _configs(**ARGS)
    tests = j_data.generate_test_set(8, seed=777)
    reps = []
    for ev, orc, params, cfg, x, v in ((j_eval, j_oracle, j_params, cj, xj, vj),
                                       (p_eval, p_oracle, p_params, cp, xp, vp)):
        dec = orc.OracleDecoder(orc.OracleLM(params.init_params(cfg), cfg), x, v, cfg)
        reps.append(ev.evaluate_conversion(dec, tests, n_best=2))
    a, b = (dataclasses.replace(r, seconds=0.0, chars_per_sec=0.0) for r in reps)
    assert dataclasses.asdict(a) == dataclasses.asdict(b) and a.exact_match > 0
    assert a.summary() == b.summary()
    from jlm_tpu.eval.conversion import _char_correct as cj_
    from jlm_tpu_torch.eval.conversion import _char_correct as cp_
    for hyp, ref in (("今日は", "今日も"), ("", "あ"), ("京都", "東京都")):
        assert cj_(hyp, ref) == cp_(hyp, ref)


def case_eval_ceiling(tmp_path):
    """The exact Bayes ceilings, context-free and topic-conditioned."""
    from jlm_tpu.data.synthetic_ctx import generate_test_set_ctx
    from jlm_tpu.eval import ceiling as j_ceiling
    from jlm_tpu_torch.eval import ceiling as p_ceiling

    tests = j_data.generate_test_set(40, seed=777)
    assert j_ceiling.bayes_ceiling(tests) == p_ceiling.bayes_ceiling(tests)
    ctx = generate_test_set_ctx(12, seed=11)
    assert j_ceiling.bayes_ceiling_ctx(ctx) == p_ceiling.bayes_ceiling_ctx(ctx)
    kana = ctx[0][0]
    assert j_ceiling.surface_posteriors_ctx(kana) == p_ceiling.surface_posteriors_ctx(kana)


def case_oracle_ngram(tmp_path):
    """The n-gram baseline: the same rows, sequence NLL and exact Viterbi
    decodes through each package's oracle decoder."""
    from jlm_tpu.oracle import ngram as j_ngram
    from jlm_tpu_torch.oracle import ngram as p_ngram

    (lj, vj, xj), (lp, vp, xp) = _both()
    cj, cp = _configs(**ARGS)
    ids = j_data.encode_corpus(lj[:50], vj)
    for order in (1, 2):
        mj = j_ngram.NgramLM(vj, order=order).fit_lines(lj, vj)
        mp = p_ngram.NgramLM(vp, order=order).fit_lines(lp, vp)
        words = np.asarray([0, 5, 9, 17])
        for a, b in zip(mj.step(words, mj.initial_state(4)), mp.step(words, mp.initial_state(4))):
            _assert_tree_equal(a, b)
        assert mj.sequence_nll(ids) == mp.sequence_nll(ids)
        dj = j_oracle.OracleDecoder(mj, xj, vj, j_ngram.ngram_config(cj))
        dp = p_oracle.OracleDecoder(mp, xp, vp, p_ngram.ngram_config(cp))
        for kana, _ in j_data.generate_test_set(6, seed=777):
            for a, b in zip(dj.decode(kana, n_best=2), dp.decode(kana, n_best=2)):
                assert (a.surface, a.score, a.segments) == (b.surface, b.score, b.segments)


def case_data_realistic(tmp_path):
    """The realistic lexicon (at 20,000 words here), its test set, corpus
    and lattice statistics."""
    import jlm_tpu.data.realistic as j_real
    import jlm_tpu_torch.data.realistic as p_real

    vj, vp = (m.generate_realistic_lexicon(20_000, seed=7) for m in (j_real, p_real))
    assert [t.key for t in vj.tokens] == [t.key for t in vp.tokens] and vj.id_of == vp.id_of
    np.testing.assert_array_equal(vj.counts, vp.counts)
    tj = j_real.generate_realistic_test_set(vj, 12, seed=99)
    assert tj == p_real.generate_realistic_test_set(vp, 12, seed=99)
    assert (j_real.generate_realistic_corpus(vj, 40, seed=5)
            == p_real.generate_realistic_corpus(vp, 40, seed=5))
    cj, cp = _configs(**dict(ARGS, vocab_size=20_000))
    kanas = [k for k, _ in tj]
    assert (j_real.lattice_density_stats(kanas, j_data.Lexicon.from_vocab(vj), vj, cj)
            == p_real.lattice_density_stats(kanas, p_data.Lexicon.from_vocab(vp), vp, cp))


def case_data_synthetic_ctx(tmp_path):
    """The topic-conditioned corpus, test sets and pool probabilities."""
    import jlm_tpu.data.synthetic_ctx as j_ctx
    import jlm_tpu_torch.data.synthetic_ctx as p_ctx

    assert j_ctx.generate_corpus_ctx(300, seed=7) == p_ctx.generate_corpus_ctx(300, seed=7)
    assert j_ctx.generate_test_set_ctx(40, seed=9) == p_ctx.generate_test_set_ctx(40, seed=9)
    assert (j_ctx.generate_test_tokens_ctx(40, seed=9)
            == p_ctx.generate_test_tokens_ctx(40, seed=9))
    assert j_ctx.TOPICS == p_ctx.TOPICS
    for topic in j_ctx.TOPICS:
        assert (j_ctx.pool_reading_probs(j_data.SYNTH_WORDS, topic)
                == p_ctx.pool_reading_probs(p_data.SYNTH_WORDS, topic))


def case_utils_logging(tmp_path):
    """JSONL records of ``log`` and ``timed_span``, up to their times."""
    import json

    import jlm_tpu.utils.logging as j_log
    import jlm_tpu_torch.utils as p_utils

    recs = []
    for mod in (j_log, p_utils):
        path = str(tmp_path / f"{mod.__name__}.jsonl")
        logger = mod.JsonlLogger(path, echo=False)
        rec = logger.log("eval", top1=0.5, n=3)
        with mod.timed_span(logger, "decode", chunk=2):
            pass
        with open(path) as f:
            lines = [json.loads(l) for l in f]
        assert lines[0] == rec
        recs.append([{k: v for k, v in l.items() if k not in ("ts", "seconds")} for l in lines])
    assert recs[0] == recs[1] and len(recs[0]) == 2


def case_train_import_reference(tmp_path):
    """A TF-style export (pickle and npz) re-keyed onto each package's
    weight spec: the same parameters and mapping."""
    import pickle

    import jlm_tpu.train.import_reference as j_imp
    import jlm_tpu_torch.train.import_reference as p_imp

    for kw in (ARGS, dict(ARGS, num_layers=2)):
        cj, cp = _configs(**kw)
        pj = j_params.init_params(cj, seed=4)
        export = {"model/embedding": np.asarray(pj["embedding"]),
                  "model/softmax_w": np.asarray(pj["head"]["W"]).T,  # [V, H]: transposed
                  "model/softmax_b": np.asarray(pj["head"]["b"]),
                  "global_step": np.asarray(7)}
        for l, layer in enumerate(pj["lstm"]):
            export[f"model/rnn/cell_{l}/kernel"] = np.asarray(layer["W"])
            export[f"model/rnn/cell_{l}/bias"] = np.asarray(layer["b"])
        pkl, npz = tmp_path / "export.pkl", str(tmp_path / "export.npz")
        with open(pkl, "wb") as f:
            pickle.dump(export, f)
        np.savez(npz, **export)
        for path in (str(pkl), npz):
            got_j = j_imp.import_reference_weights(j_imp.load_export(path), cj)
            got_p = p_imp.import_reference_weights(p_imp.load_export(path), cp)
            assert got_j[1] == got_p[1]
            _assert_tree_equal(got_j[0], got_p[0])
            _assert_tree_equal(got_p[0], pj)


def case_parallel_comms_model(tmp_path):
    """The analytic collective-traffic model: the same payloads and
    projections from both copies."""
    import jlm_tpu.parallel.comms_model as j_cm
    import jlm_tpu_torch.parallel.comms_model as p_cm

    for kw in (dict(vocab_size=50_000), dict(vocab_size=100_000, beam_width=4)):
        cj, cp = j_config.Config(**kw), p_config.Config(**kw)
        for S, n, nd, seq in ((512, 4, 1, False), (2048, 4, 2, True), (64, 8, 1, True)):
            for hb in (2, 4):
                assert (j_cm.decode_collective_bytes_per_frame(cj, S, n, nd, seq, hb)
                        == p_cm.decode_collective_bytes_per_frame(cp, S, n, nd, seq, hb))
                for gbps in (100.0, 12.5):
                    args = (S, 8.0, 0.55)
                    opts = dict(n_vocab=n, n_data=nd, gbps=gbps, seq_shard=seq, htop_bytes=hb)
                    assert (j_cm.decode_scaling_projection(cj, *args, **opts)
                            == p_cm.decode_scaling_projection(cp, *args, **opts))
    assert (j_cm.ICI_GBPS, j_cm.DCN_GBPS) == (p_cm.ICI_GBPS, p_cm.DCN_GBPS)


CASES = {name[len("case_"):]: fn for name, fn in globals().items() if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_copy_matches_jax_original(case, tmp_path):
    CASES[case](tmp_path)
