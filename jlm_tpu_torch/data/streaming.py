"""Reading a streamed data directory.

The part of :mod:`jlm_tpu.data.streaming` that
:func:`jlm_tpu_torch.data.io.load_dataset` reaches: a data dir written by
the reference's streaming prep holds ``vocab.tsv`` + ``corpus.bin`` (raw
int32 ids) + ``meta.json`` (split offsets), and is memory-mapped here, so
training reads windows straight from the page cache.
"""

from __future__ import annotations

import json
import os

import numpy as np


def load_dataset_bin(data_dir: str):
    """Memory-mapped (vocab, train, dev, test) from a streamed data dir."""
    from jlm_tpu_torch.data.io import load_vocab

    vocab = load_vocab(os.path.join(data_dir, "vocab.tsv"))
    with open(os.path.join(data_dir, "meta.json")) as f:
        meta = json.load(f)
    ids = np.memmap(
        os.path.join(data_dir, "corpus.bin"), dtype=meta["dtype"], mode="r",
        shape=(meta["total"],),
    )
    return (
        vocab,
        ids[meta["train"][0] : meta["train"][1]],
        ids[meta["dev"][0] : meta["dev"][1]],
        ids[meta["test"][0] : meta["test"][1]],
    )
