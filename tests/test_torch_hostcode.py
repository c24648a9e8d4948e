"""The port's copies of the JAX package's host code vs the originals.

``jlm_tpu_torch`` keeps its own copies of ``config``, ``data``,
``decoder.lattice``, the ``native`` lattice builder, ``oracle``,
``ops.quant`` and ``init_params``; each case here builds the same thing
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


CASES = {name[len("case_"):]: fn for name, fn in globals().items() if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_copy_matches_jax_original(case, tmp_path):
    CASES[case](tmp_path)
