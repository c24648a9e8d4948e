"""The native chunk packer (``NativeLatticeBuilder.pack_batch``: one C call a
chunk) against the Python builder and the JAX package's native builder, on
a seeded dense lexicon (readings of 1-5 kana, many homophones)."""

import numpy as np
import pytest

import jlm_tpu.config as j_config
import jlm_tpu.data.corpus as j_corpus
import jlm_tpu.data.lexicon as j_lexicon
import jlm_tpu.native as j_native
import jlm_tpu_torch.data.corpus as p_corpus
from jlm_tpu_torch import native
from jlm_tpu_torch.config import Config, UNK_ID
from jlm_tpu_torch.data.lexicon import Lexicon
from jlm_tpu_torch.decoder.engine import pack_lattice_batch
from jlm_tpu_torch.decoder.lattice import build_lattice
from jlm_tpu_torch.utils import profiling

pytestmark = pytest.mark.skipif(not native.available(), reason="no native toolchain")

KANA = "あいうえおかきくけこ"  # the lexicon's alphabet
PREFIX_ONLY = "ぬ"  # starts longer readings, never a reading of its own
OUTSIDE = "ゑ"  # in no reading: the <unk> fallback
T_MAX = 40
ARGS = dict(vocab_size=4096, max_kana_len=T_MAX, max_word_len=5)


def _words(seed=11):
    """(display, reading, pos) of a dense lexicon: every kana a reading, many
    longer ones, 1-6 homophones each."""
    rng = np.random.default_rng(seed)
    readings = list(KANA)
    for n, count in ((2, 70), (3, 160), (4, 100), (5, 60)):
        for _ in range(count):
            readings.append("".join(rng.choice(list(KANA + PREFIX_ONLY), size=n)))
    readings = list(dict.fromkeys(r for r in readings if r != PREFIX_ONLY))
    return [(f"W{len(readings)}_{i}_{h}", r, "名詞") for i, r in enumerate(readings)
            for h in range(int(rng.integers(1, 7)))]


def _vocab(corpus, words):
    tokens = [corpus.Token("<eos>", "", ""), corpus.Token("<unk>", "", "")]
    tokens += [corpus.Token(*w) for w in words]
    return corpus.Vocab(tokens=tokens, id_of={t.key: i for i, t in enumerate(tokens)},
                        counts=np.arange(len(tokens), 0, -1))


@pytest.fixture(scope="module")
def lex():
    words = _words()
    vj, vp = _vocab(j_corpus, words), _vocab(p_corpus, words)
    return {"j": (vj, j_lexicon.Lexicon.from_vocab(vj)), "p": (vp, Lexicon.from_vocab(vp))}


@pytest.fixture(scope="module")
def kanas():
    """300 sentences of every length 1..T_MAX, some with kana outside the
    lexicon or that only start readings."""
    rng = np.random.default_rng(5)
    lengths = np.concatenate([np.arange(1, T_MAX + 1), rng.integers(1, T_MAX + 1, 260)])
    alphabet = list(KANA * 4 + PREFIX_ONLY + OUTSIDE)
    return ["".join(rng.choice(alphabet, size=n)) for n in lengths]


def _shared(lexicon, case):
    """``lexicon`` with ``<unk>`` as a word and, for ``shared_ids``, words under
    two readings and twice under one: one start meets such a word twice."""
    by = {r: list(w) for r, w in lexicon.by_reading.items()}
    for r in list(by) if case == "shared_ids" else []:
        if len(r) == 2 and r[0] in by:
            by[r].append(by[r[0]][0])
        elif len(r) == 3:
            by[r].append(by[r][0])
    by[PREFIX_ONLY + KANA[0]] = by.get(PREFIX_ONLY + KANA[0], []) + [UNK_ID]
    return type(lexicon)(by_reading=by, max_reading_len=lexicon.max_reading_len)


def _python(kanas, vocab, lexicon, cfg):
    return pack_lattice_batch([build_lattice(k, lexicon, vocab, cfg) for k in kanas])


def _traced_drops(fn):
    profiling.reset()
    profiling.enable(True)
    try:
        out = fn()
    finally:
        profiling.enable(False)
    drops = profiling.snapshot()["counters"].get("decode.dropped_nodes", 0)
    profiling.reset()
    return out, drops


@pytest.mark.parametrize("case", ["lossless", "drops", "overflow", "width", "shared_ids",
                                  "unk_word"])
def test_chunk_entry_matches_the_builders(case, lex, kanas):
    (vj, xj), (vp, xp) = lex["j"], lex["p"]
    if case in ("shared_ids", "unk_word"):
        xj, xp = _shared(xj, case), _shared(xp, case)
    nodes = {"lossless": 64, "drops": 6}.get(case, 64)
    look = 10 if case == "overflow" else 64
    overflow = "ignore" if case == "drops" else "raise"
    cfg = Config(**ARGS, max_nodes_per_frame=nodes, max_lookahead=look, node_overflow=overflow)
    cj = j_config.Config(**ARGS, max_nodes_per_frame=nodes, max_lookahead=look,
                         node_overflow=overflow)
    builder = native.NativeLatticeBuilder(xp, cfg)

    if case == "overflow":
        faults = []
        for s, k in enumerate(kanas):
            try:
                build_lattice(k, xp, vp, cfg)
            except AssertionError:
                faults.append(s)
        assert 0 < faults[0] and len(faults) < len(kanas)
        with pytest.raises(ValueError, match=f"sentence {faults[0]}\\)"):
            builder.pack_batch(kanas)
        ok = [k for s, k in enumerate(kanas) if s not in set(faults)]
        np.testing.assert_array_equal(builder.pack_batch(ok)[0], _python(ok, vp, xp, cfg)[0])
        return

    (packed, lengths), drops = _traced_drops(lambda: builder.pack_batch(kanas))
    assert packed.shape == (len(kanas), T_MAX, nodes)
    want, want_len = _python(kanas, vp, xp, cfg)
    np.testing.assert_array_equal(packed, want)
    np.testing.assert_array_equal(lengths, want_len)
    got_j = j_native.NativeLatticeBuilder(xj, cj).pack_batch(kanas)
    np.testing.assert_array_equal(packed, got_j[0])
    np.testing.assert_array_equal(lengths, got_j[1])
    words = packed & ((1 << 17) - 1)
    live = (packed >> 29) & 1 == 1
    assert (words[live] == UNK_ID).any() and ((packed >> 17) & 0x3F)[live].max() == T_MAX - 1

    if case == "drops":
        each = sum(_traced_drops(lambda: builder.pack_batch([k]))[1] for k in kanas)
        assert drops == each == sum(build_lattice(k, xp, vp, cfg).dropped_nodes
                                    for k in kanas) > 0
    else:
        assert drops == 0
    if case == "width":
        for width in (1, 17, T_MAX - 1):
            narrow, narrow_len = builder.pack_batch(kanas, width=width)
            assert narrow.shape == (len(kanas), width, nodes)
            np.testing.assert_array_equal(narrow, packed[:, :width])
            np.testing.assert_array_equal(narrow_len, lengths)
