"""The card's peaks and the roofline arithmetic.

Frozen from ``chip_smoke.py`` (``PEAK``, ``SFU_RATE``, ``bound_of``):
NVIDIA's dense H100 SXM figures at 700 W, and the special-function units'
exponential rate, 16 a clock on each SM at the card's maximum SM clock as
``nvidia-smi`` reads it.  A bound is the largest of the bytes over the
memory rate, the operations over the peak of their type and, where a
kernel takes exponentials, their count over the exponential rate.
"""

from __future__ import annotations

import subprocess
from typing import Dict, Optional, Tuple

PEAK = {"int8": 1979e12, "bf16": 989e12, "fp32": 67e12, "bytes": 3.35e12}
SFU_PER_CLOCK = 16


def _smi(query: str) -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def card() -> Dict[str, Optional[str]]:
    """The card's name, power limit and maximum SM clock, as nvidia-smi reads them."""
    got = _smi("name,power.limit,clocks.max.sm")
    parts = [p.strip() for p in got.split(",")] if got else [None] * 3
    return dict(zip(("name", "power_limit", "max_sm_clock"), parts))


def peaks(device_index: int = 0) -> Dict[str, float]:
    """``PEAK`` and, where the clock can be read, ``exp`` (exponentials/s)."""
    import torch

    out = dict(PEAK)
    clock = card()["max_sm_clock"]
    if clock:
        mhz = float(clock.split()[0])
        sms = torch.cuda.get_device_properties(device_index).multi_processor_count
        out["exp"] = SFU_PER_CLOCK * sms * mhz * 1e6
    return out


def bound_s(nbytes: float, ops: float, kind: str, peak: Dict[str, float],
            exps: float = 0.0) -> Tuple[float, str]:
    """(least seconds the card could take, what bounds it)."""
    terms = [(nbytes / peak["bytes"], "bytes"), (ops / peak[kind], "operations")]
    if exps and "exp" in peak:
        terms.append((exps / peak["exp"], "exp"))
    return max(terms)
