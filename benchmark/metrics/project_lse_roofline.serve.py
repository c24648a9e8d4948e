"""``project_lse``'s share of its roofline: for every call in the profiled
window, the least time the card could take for the head's normalizer over
the call's R rows (``work``), summed, over the device time launched inside
the ``project_lse`` range (the activation quantization, the product, the
blocks' merge: whatever kernels implement it)."""

from benchmark.core.peaks import bound_s

LAYER = "kernels"
UNIT = "%"


def work(R: int, model, int8: bool = True):
    """(bytes, operations, type, exponentials) of the head's log-normalizer
    over R rows: h read in bf16, the head's weights (int8, or bf16), a
    scale and a bias a column, the lse written in fp32; 2 R d s operations
    and R s exponentials over every block of d inputs and s columns."""
    H = model["hidden_size"]
    if model["head"] == "dsoftmax":
        ds = model["dsoftmax"]
        blocks = list(zip(ds["block_dims"], ds["block_sizes"]))
    else:
        blocks = [(H, model["vocab_size"])]
    w = 1 if int8 else 2
    cols = sum(s for _, s in blocks)
    nbytes = R * H * 2 + sum(d * s for d, s in blocks) * w + cols * (8 if int8 else 4) + R * 4
    ops = 2 * R * sum(d * s for d, s in blocks)
    return nbytes, ops, ("int8" if int8 else "bf16"), R * cols


def read(trace):
    if trace.kind != "serve":
        return None
    dev = trace.device.device_s_by_range.get("project_lse")
    calls = trace.calls.get("project_lse")
    if not dev or not calls:
        return None
    least = 0.0
    for R, n in calls.items():
        nbytes, ops, kind, exps = work(R, trace.model)
        least += n * bound_s(nbytes, ops, kind, trace.peaks, exps)[0]
    return least / dev * 100.0
