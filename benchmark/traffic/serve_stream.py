"""Traffic kind ``serve_stream``: one client converting jobs of sentences.

A job is ``job_sentences`` kana sentences handed to one
``BeamDecoder.decode_stream`` call in ``chunk_size`` lattices a chunk; the
client sends its next job when the last one's results are in host memory
(a closed loop).  Set-up draws a pool of ``pool_sentences`` sentences from
the seed; job ``j`` draws its sentences from the pool (with replacement) by
a generator seeded from (seed, j), so every seed brings the same sentence
lengths in the same proportions and every job differs.

Parameters (the workload file's ``traffic``): ``lexicon`` (``synthetic``:
the bench's 147 words; ``realistic``: ``lexicon_words`` words at a real
dictionary's homophone density, from ``lexicon_seed``), ``pool_sentences``,
``job_sentences``, ``chunk_size``, ``n_best``, ``latency_quantile`` (the
jobs' latency quantile reported, as ``job_p<100 q>_ms``: one with ten jobs
of a window or more beyond it), ``max_nodes_per_frame`` (the
lattice's node budget a frame, sized so the lexicon drops no node),
``warm_jobs``, ``profile_jobs`` (jobs the traced run profiles after its
window) and ``check_sentences`` (the sample the reference converts, drawn
from as many positions of every job).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np

from benchmark.data.lexicon import RawLexicon, realistic_lexicon, realistic_sentences, \
    synthetic_lexicon
from benchmark.data.synthetic import generate_test_set

RUNNER = "serve"


@dataclasses.dataclass
class ServeTraffic:
    params: Dict[str, Any]
    seed: int
    lexicon: RawLexicon
    pool: List[str]

    def job(self, j: int) -> List[str]:
        """Job ``j``'s sentences (``j < 0``: the warm-up's)."""
        rng = np.random.default_rng([self.seed % (1 << 63), 1 if j < 0 else 0, abs(j)])
        idx = rng.integers(0, len(self.pool), size=self.params["job_sentences"])
        return [self.pool[i] for i in idx]

    def pick(self, j: int, n: int) -> np.ndarray:
        """``n`` positions of job ``j`` for the output check's sample."""
        rng = np.random.default_rng([self.seed % (1 << 63), 2, j])
        return rng.choice(self.params["job_sentences"], size=n, replace=False)


def build(params: Dict[str, Any], model: Dict[str, Any], seed: int) -> ServeTraffic:
    n = params["pool_sentences"]
    if params["lexicon"] == "synthetic":
        lex = synthetic_lexicon(model["vocab_size"])
        pool = [k for k, _ in generate_test_set(n, seed=seed % (1 << 63))]
    elif params["lexicon"] == "realistic":
        lex = realistic_lexicon(params["lexicon_words"], seed=params["lexicon_seed"])
        pool = realistic_sentences(lex, n, seed=seed % (1 << 63))
    else:
        raise ValueError(f"unknown lexicon {params['lexicon']!r}")
    if len(lex) > model["vocab_size"]:
        raise ValueError(f"lexicon of {len(lex)} words over vocab_size {model['vocab_size']}")
    return ServeTraffic(params, seed, lex, pool)
