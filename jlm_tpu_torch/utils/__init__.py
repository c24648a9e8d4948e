"""Observability utilities (SURVEY.md §7: tracing/metrics/logging).

The port's copy of :mod:`jlm_tpu.utils`: ``trace`` records with
``torch.profiler``, ``device_timer`` times a call to its finish.
"""

from jlm_tpu_torch.utils.logging import JsonlLogger, timed_span  # noqa: F401
from jlm_tpu_torch.utils.profiling import device_timer, trace  # noqa: F401
