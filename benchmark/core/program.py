"""Everything the benchmark takes from the program under test.

The program is ``jlm_tpu_torch`` (never the JAX package beside it).  It is
imported here and in each model family's adapter (``families/<family>.py``)
only, inside functions, so that the reference, the traffic generators and
the metrics stay free of it and a checkout without the program fails when a
cell starts.  What is the same for every family lives here: the program's
presence, its build directory, its vocabulary over the raw lexicon.  The
benchmark hands the program the inputs it made (weights, the raw lexicon's
words, the kana) and takes back its outputs.
"""

from __future__ import annotations

import tempfile

from benchmark.data.lexicon import RawLexicon


def require() -> None:
    """Fail unless the program is there to run (a checkout of the benchmark
    alone measures nothing)."""
    import jlm_tpu_torch  # noqa: F401


def use_build_dir(root: str) -> None:
    """Keep the program's native (g++) lattice library in a fixed directory
    of the checkout: it builds into ``tempfile.gettempdir()``."""
    import os

    os.makedirs(root, exist_ok=True)
    tempfile.tempdir = root


def make_vocab(lex: RawLexicon):
    """The program's ``Vocab`` and ``Lexicon`` over the raw lexicon's words."""
    from jlm_tpu_torch.data.corpus import Token, Vocab
    from jlm_tpu_torch.data.lexicon import Lexicon

    tokens = [Token(*w) for w in lex.words]
    vocab = Vocab(tokens=tokens, id_of={t.key: i for i, t in enumerate(tokens)},
                  counts=lex.counts)
    return vocab, Lexicon.from_vocab(vocab)


ADAM_B1 = 0.9  # Adam's b1: the first gradient is mu / (1 - b1) after one step
