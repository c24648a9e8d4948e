"""The benchmark's raw lexicons: frequency-ranked (display, reading, POS) words.

Frozen copies of the program's vocabulary build (``jlm_tpu_torch/data/corpus.py``
``build_vocab``) and of its realistic-density lexicon generator
(``jlm_tpu_torch/data/realistic.py``), so the traffic cannot move with the
program.  A :class:`RawLexicon` is what both sides are handed: the program
builds its own ``Vocab`` and ``Lexicon`` from ``words``, the reference its
own lattices.  Word id ``i`` is ``words[i]``; ids 0 and 1 are ``<eos>`` and
``<unk>`` with empty readings.
"""

from __future__ import annotations

import collections
import dataclasses
import random
from typing import Dict, List, Tuple

import numpy as np

from benchmark.data.synthetic import generate_corpus

EOS_ID, UNK_ID, NUM_SPECIALS = 0, 1, 2
EOS_TOKEN, UNK_TOKEN = "<eos>", "<unk>"

Word = Tuple[str, str, str]  # (display, reading, POS)


@dataclasses.dataclass
class RawLexicon:
    words: List[Word]
    counts: np.ndarray

    def __len__(self) -> int:
        return len(self.words)

    def by_reading(self) -> Dict[str, List[int]]:
        """``reading -> word ids`` in id (frequency) order; specials left out."""
        out: Dict[str, List[int]] = {}
        for wid, (_, reading, _) in enumerate(self.words):
            if reading:
                out.setdefault(reading, []).append(wid)
        return out


def _parse_token(s: str) -> Word:
    parts = s.split("/")
    if len(parts) >= 3:
        return ("/".join(parts[:-2]), parts[-2], parts[-1])
    if len(parts) == 2:
        return (parts[0], parts[1], "")
    return (s, s, "")


def build_lexicon(lines: List[str], vocab_size: int) -> RawLexicon:
    """Count ``display/reading/POS`` triples; keep the top ``vocab_size - 2``
    by frequency (ties by key), specials first."""
    counter: collections.Counter = collections.Counter()
    for line in lines:
        for tok in line.strip().split():
            counter[tok] += 1
    ranked = sorted(counter.items(), key=lambda kv: (-kv[1], kv[0]))[:vocab_size - NUM_SPECIALS]
    words = [(EOS_TOKEN, "", ""), (UNK_TOKEN, "", "")] + [_parse_token(k) for k, _ in ranked]
    return RawLexicon(words, np.asarray([0, 0] + [c for _, c in ranked], np.int64))


def synthetic_lexicon(vocab_size: int, corpus_sentences: int = 2000,
                      corpus_seed: int = 1234) -> RawLexicon:
    """The bench lexicon: ``build_vocab(generate_corpus(2000, seed=1234))``."""
    return build_lexicon(generate_corpus(corpus_sentences, corpus_seed), vocab_size)


# ---- realistic-density lexicon (frozen from jlm_tpu_torch/data/realistic.py) ----

_KANA = (
    "いうんしかのたとにてるなくはこがきっでもすま"
    "りさらだおれあよじつせそけむわどえゆみちばへ"
    "やほめぶねずべびげござぼぱぴぷぺぽぬぃぅろひふ"
)
_LEN_P = {1: 0.005, 2: 0.155, 3: 0.34, 4: 0.30, 5: 0.20}
_HOMO_CAP = {1: 14, 2: 12, 3: 6, 4: 3, 5: 2}
_POS = ("名詞", "動詞", "形容詞", "副詞", "助詞")


def _kana_weights(alpha: float) -> np.ndarray:
    r = np.arange(1, len(_KANA) + 1, dtype=np.float64)
    w = 1.0 / r**alpha
    return w / w.sum()


def realistic_lexicon(n_words: int, seed: int = 7, alpha: float = 0.3) -> RawLexicon:
    """``n_words`` words (specials included) at a real dictionary's homophone
    density: rank-weighted kana readings of 1-5 kana, homophones capped per
    reading length, Zipf counts by rank."""
    rng = np.random.default_rng(seed)
    n_real = n_words - NUM_SPECIALS
    kw = _kana_weights(alpha)
    lens = rng.choice(list(_LEN_P.keys()), size=n_real, p=list(_LEN_P.values()))
    total_chars = int(lens.sum())
    chars = rng.choice(len(_KANA), size=2 * total_chars, p=kw)
    spare = total_chars
    homo_count: Dict[str, int] = {}
    readings: List[str] = []
    off = 0
    for L in lens:
        r = "".join(_KANA[c] for c in chars[off:off + L])
        off += int(L)
        while homo_count.get(r, 0) >= _HOMO_CAP[min(len(r), 5)]:
            if len(r) >= 5:
                r = r[1:]
            r = r + _KANA[chars[spare % len(chars)]]
            spare += 1
        homo_count[r] = homo_count.get(r, 0) + 1
        readings.append(r)
    words: List[Word] = [(EOS_TOKEN, "", ""), (UNK_TOKEN, "", "")]
    counts = [0, 0]
    base, span = 0x4E00, 0x9FFF - 0x4E00
    for i, r in enumerate(readings):
        n_chars = max(1, (len(r) + 1) // 2)
        disp = "".join(chr(base + (i * 2654435761 + k * 40503) % span) for k in range(n_chars))
        pos = _POS[i % len(_POS)] if len(r) > 1 else _POS[i % 2 + 3]
        words.append((disp, r, pos))
        counts.append(max(1, int(2e7 / (i + 3) ** 1.05)))
    return RawLexicon(words, np.asarray(counts, np.int64))


def realistic_sentences(lex: RawLexicon, n: int, seed: int, min_words: int = 3,
                        max_words: int = 6) -> List[str]:
    """Kana of ``n`` sentences of ``min_words``-``max_words`` Zipf-drawn words
    (``generate_realistic_test_set``'s draw)."""
    rng = random.Random(seed)
    n_real = len(lex) - NUM_SPECIALS
    out = []
    for _ in range(n):
        k = rng.randint(min_words, max_words)
        wids = [NUM_SPECIALS + int(n_real * (rng.random() ** 3.0)) % n_real for _ in range(k)]
        out.append("".join(lex.words[w][1] for w in wids))
    return out
