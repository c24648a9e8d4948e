"""Realistic-scale synthetic lexicon: 100k words at real homophone density.

The port's copy of :mod:`jlm_tpu.data.realistic`.

The built-in test lexicon (:mod:`jlm_tpu_torch.data.synthetic`) has 147 words —
fine for parity fixtures, but it cannot exercise the engine's packing
limits the way a real IME dictionary does (VERDICT r4 missing #3): a real
lexicon at V=100k produces lattices with ~O(10·T) nodes per sentence
(SURVEY.md §4.5), per-frame node counts that press against
``max_nodes_per_frame``, and per-start lookahead sets that press against
``max_lookahead``.

This generator builds a deterministic 100k-word lexicon whose LATTICE
STATISTICS match that regime, without shipping a real dictionary (the
repository bundles no BCCWJ/mozc dictionary):

- readings are sampled from a rank-weighted hiragana alphabet (common
  kana are much more likely, like real Japanese sound statistics), with
  a reading-length distribution centered on 2–3 kana;
- homophones arise NATURALLY from sampling collisions: high-probability
  sound patterns collect many distinct displays, mirroring how こう /
  しょう style readings collect dozens of kanji words.  The homophone
  count per reading is therefore long-tailed rather than uniform;
- word frequencies are Zipf by rank (the vocab is frequency-ordered,
  load-bearing for D-softmax block membership, SURVEY.md §4.1);
- displays are unique synthetic CJK strings (uniqueness is what matters
  for conversion-accuracy bookkeeping, not real orthography).

Calibration (pinned by tests/test_realistic.py): at n_words=100_000 the
generated test sentences measure ≈8–14 lattice nodes per kana with the
default ``max_word_len=5``, matching SURVEY.md §4.5's O(10·T) estimate.
"""

from __future__ import annotations

import random
from typing import Dict, List, Tuple

import numpy as np

from jlm_tpu_torch.config import Config, EOS_TOKEN, NUM_SPECIALS, UNK_TOKEN
from jlm_tpu_torch.data.corpus import Token, Vocab

# Hiragana ordered roughly by real-text commonness (the head of this list
# dominates samples; exact order is a modeling choice, pinned for
# determinism).
_KANA = (
    "いうんしかのたとにてるなくはこがきっでもすま"
    "りさらだおれあよじつせそけむわどえゆみちばへ"
    "やほめぶねずべびげござぼぱぴぷぺぽぬぃぅろひふ"
)

# Reading-length distribution (1..5 kana).  Real IME dictionaries are
# dominated by 3–4 kana readings; 1-kana entries are few but extremely
# ambiguous (particles + single-char nouns).
_LEN_P = {1: 0.005, 2: 0.155, 3: 0.34, 4: 0.30, 5: 0.20}

# Homophone cap per reading length: short readings collect many homophones
# (real こう/しょう-style clusters), long readings few.  Collided words
# beyond the cap get their reading EXTENDED (a real dictionary would hold
# a longer compound), keeping n_words fixed.
_HOMO_CAP = {1: 14, 2: 12, 3: 6, 4: 3, 5: 2}

_POS = ("名詞", "動詞", "形容詞", "副詞", "助詞")


def _kana_weights(alpha: float = 1.0) -> np.ndarray:
    r = np.arange(1, len(_KANA) + 1, dtype=np.float64)
    w = 1.0 / r**alpha
    return w / w.sum()


def generate_realistic_lexicon(
    n_words: int = 100_000, seed: int = 7, alpha: float = 0.3
) -> Vocab:
    """Deterministic ``Vocab`` of ``n_words`` (incl. specials) at real
    homophone density; frequency-ordered with Zipf counts."""
    rng = np.random.default_rng(seed)
    n_real = n_words - NUM_SPECIALS
    kw = _kana_weights(alpha)
    lens = rng.choice(
        list(_LEN_P.keys()), size=n_real, p=list(_LEN_P.values())
    )
    # sample all reading characters in one draw (plus spare chars for
    # cap-overflow extensions)
    total_chars = int(lens.sum())
    chars = rng.choice(len(_KANA), size=2 * total_chars, p=kw)
    spare = total_chars
    homo_count: Dict[str, int] = {}
    readings: List[str] = []
    off = 0
    for L in lens:
        r = "".join(_KANA[c] for c in chars[off:off + L])
        off += int(L)
        # enforce the per-length homophone cap: extend collided readings
        # (bounded walk through the spare char stream keeps determinism)
        while homo_count.get(r, 0) >= _HOMO_CAP[min(len(r), 5)]:
            if len(r) >= 5:
                r = r[1:]  # rotate: drop the head, keep length bounded
            r = r + _KANA[chars[spare % len(chars)]]
            spare += 1
        homo_count[r] = homo_count.get(r, 0) + 1
        readings.append(r)

    # Unique displays: synthetic CJK strings indexed by word rank.  One
    # char per ~2 kana of reading keeps surfaces plausibly short.
    tokens: List[Token] = [Token(EOS_TOKEN, "", ""), Token(UNK_TOKEN, "", "")]
    counts = [0, 0]
    base = 0x4E00
    span = 0x9FFF - base  # ~20k distinct CJK codepoints
    for i, r in enumerate(readings):
        n_chars = max(1, (len(r) + 1) // 2)
        disp = "".join(
            chr(base + (i * 2654435761 + k * 40503) % span)
            for k in range(n_chars)
        )
        pos = _POS[i % len(_POS)] if len(r) > 1 else _POS[i % 2 + 3]
        tokens.append(Token(disp, r, pos))
        counts.append(max(1, int(2e7 / (i + 3) ** 1.05)))
    id_of = {t.key: i for i, t in enumerate(tokens)}
    return Vocab(tokens=tokens, id_of=id_of,
                 counts=np.asarray(counts, np.int64))


def _zipf_word_ids(vocab: Vocab, rng: random.Random, n: int) -> List[int]:
    """Sample ``n`` word ids with Zipf bias toward low (frequent) ids."""
    n_real = len(vocab) - NUM_SPECIALS
    out = []
    for _ in range(n):
        r = rng.random()
        out.append(NUM_SPECIALS + int(n_real * (r ** 3.0)) % n_real)
    return out


def generate_realistic_test_set(
    vocab: Vocab, n_sentences: int = 50, seed: int = 99,
    min_words: int = 3, max_words: int = 6,
) -> List[Tuple[str, str]]:
    """(kana, gold display) pairs of frequency-sampled lexicon words."""
    rng = random.Random(seed)
    out = []
    for _ in range(n_sentences):
        wids = _zipf_word_ids(
            vocab, rng, rng.randint(min_words, max_words)
        )
        out.append((
            "".join(vocab.reading(w) for w in wids),
            "".join(vocab.display(w) for w in wids),
        ))
    return out


def generate_realistic_corpus(
    vocab: Vocab, n_sentences: int = 20_000, seed: int = 5,
    min_words: int = 4, max_words: int = 10,
) -> List[str]:
    """Training corpus lines (display/reading/POS) over the lexicon."""
    rng = random.Random(seed)
    lines = []
    for _ in range(n_sentences):
        wids = _zipf_word_ids(
            vocab, rng, rng.randint(min_words, max_words)
        )
        lines.append(" ".join(
            vocab.tokens[w].key for w in wids
        ))
    return lines


def lattice_density_stats(
    kanas: List[str], lexicon, vocab: Vocab, config: Config
) -> Dict[str, float]:
    """Measured lattice statistics over ``kanas`` (SURVEY.md §4.5 check).

    Returns nodes-per-kana (the O(10·T) figure), the max per-frame node
    count BEFORE truncation, the max per-start lookahead set size, and
    the fraction of nodes dropped under the configured budgets.
    """
    from jlm_tpu_torch.decoder.lattice import build_lattice

    total_nodes = 0
    total_kana = 0
    total_dropped = 0
    max_frame = 0
    max_look = 0
    uncapped = config.replace(
        max_nodes_per_frame=4096, max_lookahead=4096, node_overflow="ignore"
    )
    for kana in kanas:
        lat = build_lattice(kana, lexicon, vocab, uncapped)
        n_nodes = sum(len(f) for f in lat.frames)
        total_nodes += n_nodes
        total_kana += len(kana)
        max_frame = max(max_frame, max(len(f) for f in lat.frames))
        per_start: Dict[int, set] = {}
        for f in lat.frames:
            for nd in f:
                per_start.setdefault(nd.start, set()).add(nd.word_id)
        max_look = max(
            max_look, max(len(s) for s in per_start.values())
        )
        capped = build_lattice(
            kana, lexicon, vocab, config.replace(node_overflow="ignore")
        )
        total_dropped += capped.dropped_nodes
    return {
        "nodes_per_kana": total_nodes / max(total_kana, 1),
        "max_frame_nodes": float(max_frame),
        "max_lookahead": float(max_look),
        "dropped_frac": total_dropped / max(total_nodes, 1),
    }
