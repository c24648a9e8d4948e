"""The whole training step's share of the card's peak: each profiled
step's forward and backward by precision (the model family's
``train_ops``; the LSTM's: the cell in fp32, the head in bf16), each
precision's over its dense peak, summed, over the seconds that the timed
window, which runs without the profiler, took for as many steps."""

LAYER = "device"
UNIT = "%"


def read(trace):
    if trace.kind != "train" or not trace.useful_ops:
        return None
    wall = trace.untraced_s("steps")
    if not wall:
        return None
    ideal = sum(ops / trace.peaks[k] for k, ops in trace.useful_ops.items())
    return ideal / wall * 100.0
