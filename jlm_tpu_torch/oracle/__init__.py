"""Pure-numpy CPU reference implementation (the parity oracle).

The port's copy of :mod:`jlm_tpu.oracle` (``lm`` and ``decoder``).

Independent re-implementation of SURVEY.md §4.2–§4.7 standing in for the
reference's numpy inference engine (ref: JLM:decoder/ model file +
decoder.py).  With frozen seeded weights and the fixed synthetic test set it
defines the golden top-1 conversion paths and LM scores every TPU path is
parity-checked against (SURVEY.md §6.1), and its measured chars/sec is the
de-facto BASELINE config-1 number.
"""

from jlm_tpu_torch.oracle.lm import OracleLM  # noqa: F401
from jlm_tpu_torch.oracle.decoder import OracleDecoder, DecodeResult  # noqa: F401
