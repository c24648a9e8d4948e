"""Observability utilities (SURVEY.md §7: tracing/metrics/logging).

The port's copy of :mod:`jlm_tpu.utils.logging`; on the card, time with
CUDA events or ``torch.profiler`` (``chip_smoke.py``, ``profile_serve.py``).
"""

from jlm_tpu_torch.utils.logging import JsonlLogger, timed_span  # noqa: F401
