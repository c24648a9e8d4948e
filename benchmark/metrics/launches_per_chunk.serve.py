"""Device activities (kernels, copies, fills) a chunk in the profiled window."""

LAYER = "frame loop"
UNIT = "launches/chunk"


def read(trace):
    if trace.kind != "serve" or not trace.profiled_units.get("chunks"):
        return None
    return trace.device.activities / trace.profiled_units["chunks"]
