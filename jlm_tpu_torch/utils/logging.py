"""Structured logging: stdout + JSONL records.

The port's copy of :mod:`jlm_tpu.utils.logging`.

An upgrade of the reference's print-statement observability
(SURVEY.md §7 "Metrics / logging"): every metric event is one JSON object
appended to a run log, so scaling-efficiency and accuracy numbers are
machine-readable across runs.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from typing import Any, Dict, Optional


class JsonlLogger:
    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self.path = path
        self.echo = echo

    def log(self, event: str, **fields: Any) -> Dict[str, Any]:
        rec = {"event": event, "ts": time.time(), **fields}
        line = json.dumps(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")
        if self.echo:
            print(line, file=sys.stderr, flush=True)
        return rec


@contextlib.contextmanager
def timed_span(logger: JsonlLogger, name: str, **fields):
    """Wall-clock span logging — the reference's ``time.time()`` prints,
    structured (SURVEY.md §7 "Tracing")."""
    t0 = time.time()
    yield
    logger.log("span", name=name, seconds=time.time() - t0, **fields)
