"""Device milliseconds a step launched inside ``optim.apply_gradients``
(the clip and Adam) in the profiled window."""

LAYER = "optimizer"
UNIT = "ms/step"


def read(trace):
    if trace.kind != "train" or not trace.profiled_units.get("steps"):
        return None
    dev = trace.device.device_s_by_range.get("optimizer")
    if not dev:
        return None
    return dev * 1e3 / trace.profiled_units["steps"]
