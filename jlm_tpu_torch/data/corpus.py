"""Corpus parsing, frequency vocab, and id encoding.

The port's copy of :mod:`jlm_tpu.data.corpus`.

TPU-native rebuild of the reference's corpus prep (ref: JLM:data/data.py —
SURVEY.md §3.1 "Corpus prep", §4.1 "Data formats", §5.1 call stack):

- corpus lines are space-separated tokens, each a ``display/reading/POS``
  triple (readings in hiragana);
- the vocab is the top-N tokens by corpus frequency, **frequency-ordered**
  (load-bearing: D-softmax block membership is by frequency rank), with
  specials ``<eos>``/``<unk>`` at the front;
- sentences are encoded to flat int32 id arrays with ``<eos>`` terminators,
  split into train/dev/test.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from jlm_tpu_torch.config import EOS_ID, EOS_TOKEN, NUM_SPECIALS, UNK_ID, UNK_TOKEN


@dataclasses.dataclass(frozen=True)
class Token:
    """One lexical entry: surface form, hiragana reading, POS tag."""

    display: str
    reading: str
    pos: str

    @property
    def key(self) -> str:
        return f"{self.display}/{self.reading}/{self.pos}"


def parse_token(s: str) -> Token:
    """Parse ``display/reading/POS``.

    The display form itself may not contain ``/`` in our corpora; split from
    the right so a missing POS degrades gracefully.
    """
    parts = s.split("/")
    if len(parts) >= 3:
        return Token("/".join(parts[:-2]), parts[-2], parts[-1])
    if len(parts) == 2:
        return Token(parts[0], parts[1], "")
    return Token(s, s, "")


def parse_line(line: str) -> List[Token]:
    return [parse_token(t) for t in line.strip().split() if t]


@dataclasses.dataclass
class Vocab:
    """Frequency-ordered vocabulary.

    ``tokens[i]`` is the Token with id ``i``; ids 0/1 are ``<eos>``/``<unk>``
    sentinels (their Token has empty reading so they never enter the lattice
    as dictionary words).  ``id_of`` maps the full ``display/reading/POS``
    key to id.
    """

    tokens: List[Token]
    id_of: Dict[str, int]
    counts: np.ndarray  # corpus frequency per id (specials get +inf rank)

    def __len__(self) -> int:
        return len(self.tokens)

    def lookup(self, tok: Token) -> int:
        return self.id_of.get(tok.key, UNK_ID)

    def display(self, wid: int) -> str:
        return self.tokens[wid].display

    def reading(self, wid: int) -> str:
        return self.tokens[wid].reading


def build_vocab(lines: Iterable[str], vocab_size: int) -> Vocab:
    """Count token triples over the corpus; keep the top ``vocab_size - 2``.

    Mirrors the reference's vocab build (ref: JLM:data/ — SURVEY.md §5.1):
    Counter over full triples → frequency-sorted top-N → specials prepended.
    Ties in frequency are broken lexicographically by key for determinism.
    """
    counter: collections.Counter = collections.Counter()
    for line in lines:
        for tok in parse_line(line):
            counter[tok.key] += 1

    ranked = sorted(counter.items(), key=lambda kv: (-kv[1], kv[0]))
    ranked = ranked[: vocab_size - NUM_SPECIALS]

    tokens: List[Token] = [Token(EOS_TOKEN, "", ""), Token(UNK_TOKEN, "", "")]
    counts = [0, 0]
    for key, c in ranked:
        tokens.append(parse_token(key))
        counts.append(c)
    id_of = {t.key: i for i, t in enumerate(tokens)}
    return Vocab(tokens=tokens, id_of=id_of, counts=np.asarray(counts, np.int64))


def encode_corpus(lines: Iterable[str], vocab: Vocab) -> np.ndarray:
    """Encode to one flat int32 array; each sentence ends with ``<eos>``."""
    ids: List[int] = []
    for line in lines:
        toks = parse_line(line)
        if not toks:
            continue
        ids.extend(vocab.lookup(t) for t in toks)
        ids.append(EOS_ID)
    return np.asarray(ids, np.int32)


def split_corpus(
    ids: np.ndarray, dev_frac: float = 0.05, test_frac: float = 0.05
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Contiguous train/dev/test split of the encoded id stream."""
    n = len(ids)
    n_dev = int(n * dev_frac)
    n_test = int(n * test_frac)
    n_train = n - n_dev - n_test
    return ids[:n_train], ids[n_train : n_train + n_dev], ids[n_train + n_dev :]
