"""Host milliseconds a chunk in ``engine._decode_scan`` (the frame loop's
enqueue of a chunk's search) over the traced run's timed window."""

LAYER = "frame loop"
UNIT = "ms/chunk"


def read(trace):
    if trace.kind != "serve" or not trace.timed_units.get("chunks"):
        return None
    return sum(trace.spans.get("decode_scan", [])) * 1e3 / trace.timed_units["chunks"]
