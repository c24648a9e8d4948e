"""Share of the time in which no activity ran on the device: 1 - the
device's busy seconds in the profiled part over the seconds that the timed
window, which runs without the profiler, took for as much work (by steps).
The profiled window itself is slower on the host, by the profiler's cost."""

LAYER = "device"
UNIT = "%"


def read(trace):
    if trace.kind != "train":
        return None
    wall = trace.untraced_s("steps")
    if not wall:
        return None
    return (1.0 - trace.device.busy_s / wall) * 100.0
