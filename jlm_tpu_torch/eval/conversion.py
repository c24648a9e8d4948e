"""Conversion-accuracy + latency evaluation.

The port's copy of :mod:`jlm_tpu.eval.conversion`.

Rebuild of the reference's eval loop (ref: JLM:decoder/ eval script —
SURVEY.md §3.1 "Conversion evaluator", §5.5): decode every test sentence's
reading, compare against the gold display string, report top-1 exact-match
sentence accuracy, character accuracy, and throughput (chars/sec).

Works with any decoder exposing ``decode(kana, n_best) -> [DecodeResult]``
(oracle, device engine, sharded engine), plus a batched fast path when the
decoder has ``decode_batch``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Sequence, Tuple


@dataclasses.dataclass
class ConversionReport:
    sentences: int
    exact_match: int
    char_correct: int
    char_total: int
    seconds: float
    chars_per_sec: float
    # gold surface appears anywhere in the n-best list (IME "oracle"
    # accuracy: the candidate window the user actually sees); 0 when the
    # eval ran with n_best=1.
    nbest_match: int = 0
    n_best: int = 1

    @property
    def sentence_accuracy(self) -> float:
        return self.exact_match / max(1, self.sentences)

    @property
    def char_accuracy(self) -> float:
        return self.char_correct / max(1, self.char_total)

    @property
    def nbest_accuracy(self) -> float:
        return self.nbest_match / max(1, self.sentences)

    def summary(self) -> str:
        return (
            f"sentences={self.sentences} "
            f"top1_acc={self.sentence_accuracy:.3f} "
            f"char_acc={self.char_accuracy:.3f} "
            + (f"top{self.n_best}_acc={self.nbest_accuracy:.3f} "
               if self.n_best > 1 else "")
            + f"chars/s={self.chars_per_sec:.1f}"
        )


def _char_correct(hyp: str, ref: str) -> int:
    """Longest-common-subsequence character overlap (order-preserving)."""
    m, n = len(hyp), len(ref)
    if m == 0 or n == 0:
        return 0
    prev = [0] * (n + 1)
    for i in range(1, m + 1):
        cur = [0] * (n + 1)
        hi = hyp[i - 1]
        for j in range(1, n + 1):
            if hi == ref[j - 1]:
                cur[j] = prev[j - 1] + 1
            else:
                cur[j] = max(prev[j], cur[j - 1])
        prev = cur
    return prev[n]


def evaluate_conversion(
    decoder,
    test_set: Sequence[Tuple[str, str]],  # (kana reading, gold display)
    batched: bool = True,
    n_best: int = 1,
) -> ConversionReport:
    """With ``n_best > 1`` also reports oracle accuracy: the
    fraction of sentences whose gold surface appears anywhere in the
    n-best list (the IME candidate window the user actually sees)."""
    kanas = [k for k, _ in test_set]
    golds = [g for _, g in test_set]
    t0 = time.time()
    if batched and hasattr(decoder, "decode_batch"):
        nbests = decoder.decode_batch(kanas, n_best)
    else:
        nbests = [decoder.decode(k, n_best) or [] for k in kanas]
    dt = time.time() - t0

    exact = 0
    nbest_hit = 0
    char_ok = 0
    char_total = 0
    for nb, gold in zip(nbests, golds):
        hyp = nb[0].surface if nb else ""
        exact += hyp == gold
        nbest_hit += any(r.surface == gold for r in nb)
        char_ok += _char_correct(hyp, gold)
        char_total += len(gold)
    n_chars = sum(len(k) for k in kanas)
    return ConversionReport(
        sentences=len(test_set),
        exact_match=exact,
        char_correct=char_ok,
        char_total=char_total,
        seconds=dt,
        chars_per_sec=n_chars / max(dt, 1e-9),
        nbest_match=nbest_hit,
        n_best=n_best,
    )
