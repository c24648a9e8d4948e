"""Host milliseconds a chunk in ``BeamDecoder._pack`` (the native lattice
build, bit-packing and bucketing) over the traced run's timed window."""

LAYER = "engine host"
UNIT = "ms/chunk"


def read(trace):
    if trace.kind != "serve" or not trace.timed_units.get("chunks"):
        return None
    return sum(trace.spans.get("pack", [])) * 1e3 / trace.timed_units["chunks"]
