"""The expert sublayer's share of its roofline: for every call of ``moe``
in the profiled window, the least time the card could take for what its
rows need (``work``), summed, over the device time launched inside the
``moe`` range (the router, the dispatch, the routed and shared experts'
products, the combine: whatever kernels implement it)."""

LAYER = "kernels"
UNIT = "%"


def work(R: int, D: int, E: int, k: int, I: int, Is: int):
    """(bytes, bf16 operations, fp32 operations) of one call over R rows.
    Operations: the routed experts' SiLU-gated MLPs of the R k (row, pick)
    pairs and the shared experts' over the R rows (6 D I a row and expert:
    gate, up, down) in bf16, the router's logits in fp32.  Bytes: only what
    every implementation moves: the router's fp32 and the shared experts'
    bf16 weights, the rows in and out in bf16.  The routed experts' weights
    are left out: a call may leave an expert without rows."""
    nbytes = D * E * 4 + 3 * D * Is * 2 + 2 * R * D * 2
    return nbytes, 6 * D * (R * k * I + R * Is), 2 * R * D * E


def least_s(key, peaks) -> float:
    nbytes, bf16, fp32 = work(*key)
    return max(nbytes / peaks["bytes"], bf16 / peaks["bf16"] + fp32 / peaks["fp32"])


def read(trace):
    if trace.kind != "serve":
        return None
    dev = trace.device.device_s_by_range.get("moe")
    calls = trace.calls.get("moe")
    if not dev or not calls:
        return None
    least = sum(n * least_s(key, trace.peaks) for key, n in calls.items())
    return least / dev * 100.0
