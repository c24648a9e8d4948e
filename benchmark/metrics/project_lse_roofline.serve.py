"""``project_lse``'s share of its roofline: for every call in the profiled
window, the least time the card could take for the head's normalizer over
the call's R rows (``work``), summed, over the device time launched inside
the ``project_lse`` range (the activation quantization, the product, the
blocks' merge: whatever kernels implement it)."""

from benchmark.core.peaks import bound_s

LAYER = "kernels"
UNIT = "%"


def work(R: int, blocks, int8: bool = True):
    """(bytes, operations, type, exponentials) of the head's log-normalizer
    over R rows and the head's ``blocks`` (``(d, s)``: d inputs, s columns):
    h read in bf16 at the head's input width (the widest block's d), the
    weights (int8, or bf16), a scale and a bias a column, the lse written in
    fp32; 2 R d s operations and R s exponentials over every block."""
    w = 1 if int8 else 2
    cols = sum(s for _, s in blocks)
    width = max(d for d, _ in blocks)
    weights = sum(d * s for d, s in blocks)
    nbytes = R * width * 2 + weights * w + cols * (8 if int8 else 4) + R * 4
    return nbytes, 2 * R * weights, ("int8" if int8 else "bf16"), R * cols


def read(trace):
    if trace.kind != "serve":
        return None
    dev = trace.device.device_s_by_range.get("project_lse")
    calls = trace.calls.get("project_lse")
    if not dev or not calls:
        return None
    least = 0.0
    for R, n in calls.items():
        nbytes, ops, kind, exps = work(R, trace.head_blocks)
        least += n * bound_s(nbytes, ops, kind, trace.peaks, exps)[0]
    return least / dev * 100.0
