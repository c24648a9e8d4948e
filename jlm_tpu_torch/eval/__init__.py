"""Evaluation harness (ref: JLM:decoder/ eval script — SURVEY.md §5.5).

The port's copy of :mod:`jlm_tpu.eval` (``conversion`` and ``ceiling``).
"""

from jlm_tpu_torch.eval.conversion import evaluate_conversion, ConversionReport  # noqa: F401
