"""``lstm_cell_step``'s share of its roofline: for every call in the
profiled window, the least time for one bf16 LSTM step over the call's
(R, E, H) (``work``), summed, over the device time launched inside the
``lstm_cell`` range."""

from benchmark.core.peaks import bound_s

LAYER = "kernels"
UNIT = "%"


def work(R: int, E: int, H: int):
    """(bytes, operations, type): x, h, c read in bf16, W bf16, b fp32;
    c', h' written in bf16; 2 R (E + H) 4H operations."""
    nbytes = R * (E + 4 * H) * 2 + (E + H) * 4 * H * 2 + 4 * H * 4
    return nbytes, 2 * R * (E + H) * 4 * H, "bf16"


def read(trace):
    if trace.kind != "serve":
        return None
    dev = trace.device.device_s_by_range.get("lstm_cell")
    calls = trace.calls.get("lstm_cell")
    if not dev or not calls:
        return None
    least = sum(n * bound_s(*work(*key), trace.peaks)[0] for key, n in calls.items())
    return least / dev * 100.0
