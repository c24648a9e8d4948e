"""The traffic generators are deterministic by seed, and the frozen copies
still equal the program's generators they were copied from."""

import numpy as np

from benchmark.core import registry
from benchmark.data.lexicon import realistic_lexicon, realistic_sentences, synthetic_lexicon
from benchmark.data.synthetic import generate_corpus, generate_test_set


def test_serve_traffic_is_deterministic_by_seed():
    kind = registry.traffic("serve_stream")
    for name in ("serve.jlm50k.synthetic.s2048", "serve.jlm100k.realistic.s2048"):
        tp = dict(registry.workload(name)["traffic"], pool_sentences=500, job_sentences=64,
                  lexicon_words=3000)
        model = {"vocab_size": 50000}
        a, b = kind.build(tp, model, 2**31 + 7), kind.build(tp, model, 2**31 + 7)
        c = kind.build(tp, model, 2**31 + 8)
        assert a.pool == b.pool and a.job(3) == b.job(3) and a.job(-1) == b.job(-1)
        assert a.pool != c.pool and a.job(3) != a.job(4)
        assert list(a.pick(2, 8)) == list(b.pick(2, 8))


def test_train_traffic_is_deterministic_by_seed():
    kind = registry.traffic("train_bptt")
    tp = registry.workload("train.jlm50k.b256x32")["traffic"]
    a, b, c = (kind.build(tp, {"vocab_size": 50000}, s) for s in (5, 5, 6))
    np.testing.assert_array_equal(a.ids(0, 3), b.ids(0, 3))
    assert not np.array_equal(a.ids(0, 3), c.ids(0, 3))
    ids = a.ids(-1, 3)
    assert len(ids) == 3 * 256 * 32 + 1 and ids.min() >= 0 and ids.max() < 50000
    assert (ids == 0).mean() > 0.05  # sentence ends


def test_frozen_copies_equal_the_programs_generators():
    from jlm_tpu_torch.data.corpus import build_vocab
    from jlm_tpu_torch.data.realistic import (generate_realistic_lexicon,
                                              generate_realistic_test_set)
    from jlm_tpu_torch.data.synthetic import generate_corpus as prog_corpus
    from jlm_tpu_torch.data.synthetic import generate_test_set as prog_tests

    assert generate_corpus(300, 11) == prog_corpus(300, 11)
    assert generate_test_set(300, 12) == prog_tests(300, 12)
    lex = synthetic_lexicon(50000)
    vocab = build_vocab(prog_corpus(2000, 1234), 50000)
    assert [(t.display, t.reading, t.pos) for t in vocab.tokens] == lex.words
    rl = realistic_lexicon(5000, seed=7)
    rv = generate_realistic_lexicon(5000, seed=7)
    assert [(t.display, t.reading, t.pos) for t in rv.tokens] == rl.words
    np.testing.assert_array_equal(rv.counts, rl.counts)
    assert realistic_sentences(rl, 40, seed=99) == [k for k, _ in
                                                    generate_realistic_test_set(rv, 40, seed=99)]
