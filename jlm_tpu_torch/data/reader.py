"""Truncated-BPTT batch reader.

The port's copy of :mod:`jlm_tpu.data.reader`.

PTB-reader-style batching, matching the reference's scheme (ref:
JLM:train/data.py [C-med filename] — SURVEY.md §3.1 "Batch reader", §4.1):
reshape the flat id stream to ``[batch_size, -1]``, then slide
``num_steps``-wide windows; LSTM state is carried across windows within an
epoch by the trainer.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def bptt_batches(
    ids: np.ndarray, batch_size: int, num_steps: int
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield ``(inputs, targets)`` of shape ``[batch_size, num_steps]``.

    ``targets`` is ``inputs`` shifted left by one along time.  The stream is
    truncated to a multiple of ``batch_size``; windows step without overlap
    so state carry across consecutive yields is exact truncated BPTT.
    """
    n = (len(ids) - 1) // batch_size * batch_size
    if n <= 0:
        return
    xs = ids[:n].reshape(batch_size, -1)
    ys = ids[1 : n + 1].reshape(batch_size, -1)
    total = xs.shape[1]
    for start in range(0, total - num_steps + 1, num_steps):
        yield (
            xs[:, start : start + num_steps],
            ys[:, start : start + num_steps],
        )


def num_bptt_batches(n_ids: int, batch_size: int, num_steps: int) -> int:
    n = (n_ids - 1) // batch_size * batch_size
    if n <= 0:
        return 0
    total = n // batch_size
    return max(0, (total - num_steps) // num_steps + 1)
