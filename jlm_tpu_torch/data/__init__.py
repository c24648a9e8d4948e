"""Corpus & lexicon prep layer (ref: JLM:data/ — SURVEY.md §2 L0, §5.1).

The port's copy of :mod:`jlm_tpu.data` (without the streaming prep
writers: the port only reads a streamed data dir).

Token format: ``display/reading/POS`` triples, one sentence per line,
space-separated (SURVEY.md §4.1).  Outputs: frequency-ordered vocab,
reading→word-ids lexicon, encoded int32 corpus arrays.
"""

from jlm_tpu_torch.data.corpus import (  # noqa: F401
    Token,
    Vocab,
    parse_line,
    build_vocab,
    encode_corpus,
    split_corpus,
)
from jlm_tpu_torch.data.lexicon import Lexicon  # noqa: F401
from jlm_tpu_torch.data.reader import bptt_batches  # noqa: F401
from jlm_tpu_torch.data.synthetic import (  # noqa: F401
    SYNTH_WORDS,
    generate_corpus,
    generate_test_set,
)
