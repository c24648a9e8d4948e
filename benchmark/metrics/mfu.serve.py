"""The whole serving step's share of the card's peak: the operations the
profiled jobs' inputs need (the model family's ``serve_ops``; the LSTM's:
beam rows through each layer's cell, the head, the candidate dots), each
precision's over its dense peak, summed, over the seconds that the timed
window, which runs without the profiler, took for as much work (by chars)."""

LAYER = "device"
UNIT = "%"


def read(trace):
    if trace.kind != "serve" or not trace.useful_ops:
        return None
    wall = trace.untraced_s("chars")
    if not wall:
        return None
    ideal = sum(ops / trace.peaks[k] for k, ops in trace.useful_ops.items())
    return ideal / wall * 100.0
