"""The LSTM scan's share of its roofline: for every forward and backward
call in the profiled window, the least time for what its inputs need
(``work``, ``chip_smoke.py``'s scan arithmetic), summed, over the device
time launched inside the ``lstm_scan`` ranges."""

from benchmark.core.peaks import bound_s

LAYER = "scan"
UNIT = "%"


def work(tag: str, B: int, T: int, E: int, H: int):
    """(bytes, operations, type) in fp32.  Forward: xs, W, b, c0, h0 read;
    hs, cs, c_T, h_T written; 2 B T (E + H) 4H operations.  Backward: the
    same inputs and hs, cs, d_hs, d_cf, d_hf read; dz, dx, dc0, dh0
    written; the gates recomputed, the recurrence and dx, 4 B T (E + H) 4H."""
    scan_in = 4 * (B * T * E + (E + H) * 4 * H + 4 * H + 2 * B * H)
    if tag == "fwd":
        return scan_in + 4 * (2 * B * T * H + 2 * B * H), 2 * B * T * (E + H) * 4 * H, "fp32"
    nbytes = scan_in + 4 * (3 * B * T * H + 2 * B * H + B * T * 4 * H + B * T * E + 2 * B * H)
    return nbytes, 4 * B * T * (E + H) * 4 * H, "fp32"


def read(trace):
    if trace.kind != "train":
        return None
    dev = trace.device.device_s_by_range.get("lstm_scan")
    calls = trace.calls.get("lstm_scan")
    if not dev or not calls:
        return None
    least = sum(n * bound_s(*work(*key), trace.peaks)[0] for key, n in calls.items())
    return least / dev * 100.0
