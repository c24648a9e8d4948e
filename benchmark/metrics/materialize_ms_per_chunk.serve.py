"""Host milliseconds a chunk in ``BeamDecoder.materialize`` (the result
blob's fetch, which waits for the device, and the surfaces built from it)
over the traced run's timed window."""

LAYER = "engine host"
UNIT = "ms/chunk"


def read(trace):
    if trace.kind != "serve" or not trace.timed_units.get("chunks"):
        return None
    return sum(trace.spans.get("materialize", [])) * 1e3 / trace.timed_units["chunks"]
