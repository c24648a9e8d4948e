"""Traffic kind ``train_bptt``: truncated-BPTT training over a Zipf corpus.

The corpus is a stream of sentences of ``min_words``-``max_words`` word ids
drawn Zipf by frequency rank (``2 + floor(n * u**3)`` over the ``n`` real
words: the draw of the realistic corpus generator,
``jlm_tpu_torch/data/realistic.py::_zipf_word_ids``), each ended by
``<eos>``.  Set-up feeds ``setup_steps`` windows of ``batch`` rows of
``window`` tokens; the timed window then feeds calls of ``steps_per_call``
windows each (the trainer starts each call from a zero state).  Every call's
ids come from a generator seeded from (seed, call).

Parameters: ``batch``, ``window``, ``setup_steps``, ``steps_per_call``,
``min_words``, ``max_words``, ``profile_steps`` (steps the traced run
profiles after its window).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np

from benchmark.data.lexicon import EOS_ID, NUM_SPECIALS

RUNNER = "train"


@dataclasses.dataclass
class TrainTraffic:
    params: Dict[str, Any]
    seed: int
    vocab_size: int

    def ids(self, call: int, steps: int) -> np.ndarray:
        """The ids of ``steps`` windows (``batch * window * steps + 1``
        tokens) for call ``call`` (``-1``: set-up's)."""
        p = self.params
        n = p["batch"] * p["window"] * steps + 1
        rng = np.random.default_rng([self.seed % (1 << 63), 3, call + 1])
        words = rng.integers(p["min_words"], p["max_words"] + 1,
                             size=n // p["min_words"] + 1)
        ends = np.cumsum(words + 1)  # a sentence's words and its <eos>
        n_real = self.vocab_size - NUM_SPECIALS
        ids = NUM_SPECIALS + (n_real * rng.random(int(ends[-1])) ** 3.0).astype(np.int64) % n_real
        ids[ends - 1] = EOS_ID
        return ids[:n]


def build(params: Dict[str, Any], model: Dict[str, Any], seed: int) -> TrainTraffic:
    return TrainTraffic(params, seed, model["vocab_size"])
