"""The fused CE's share of its roofline: for every forward and backward
call in the profiled window, the least time for what its inputs need
(``work``: the logits once in the forward; dh and dW once each in the
backward, the logits they need not counted again), summed, over the device
time launched inside the ``softmax_ce`` ranges (the step's W^T cast, the
forward, the two backward products)."""

from benchmark.core.peaks import bound_s

LAYER = "trainer and CE"
UNIT = "%"


def work(tag: str, N: int, D: int, V: int):
    """(bytes, operations, type) of an N x D by D x V softmax CE in bf16
    products: h, W (fp32 masters), b and the int64 targets read once, the
    row losses (forward) or the row terms, dh, dW and db (backward)."""
    io = N * D * 4 + D * V * 4 + V * 4 + N * 8
    if tag == "fwd":
        return io + N * 4, 2 * N * D * V, "bf16"
    return io + N * 8 + N * D * 4 + D * V * 4 + V * 4, 4 * N * D * V, "bf16"


def read(trace):
    if trace.kind != "train":
        return None
    dev = trace.device.device_s_by_range.get("softmax_ce")
    calls = trace.calls.get("softmax_ce")
    if not dev or not calls:
        return None
    least = sum(n * bound_s(*work(*key), trace.peaks)[0] for key, n in calls.items())
    return least / dev * 100.0
