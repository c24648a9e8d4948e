"""The attention sublayer's share of its roofline: for every call of
``mla_attention`` in the profiled window, the least time the card could
take for what its rows need (``work``), summed, over the device time
launched inside the ``mla_attention`` range (the projections, the path
cache's write and gather, the scores, the softmax, the output)."""

LAYER = "kernels"
UNIT = "%"


def ancestors(pos: int, max_word_len: int) -> int:
    """The fewest words a path at frame ``pos`` attends, itself and the
    root included: ``ceil(pos / max_word_len) + 1`` (no path there is
    shorter)."""
    return -(-pos // max_word_len) + 1


def work(R: int, pos: int, M: int, D: int, H: int, dn: int, dr: int, dv: int, c: int):
    """(bytes, bf16 operations) of one call over R rows fed at frame
    ``pos``.  Operations: the projections (``q``, ``[c_kv | k_pe]``, the
    per-head ``W_kv_b`` products of a row's own latent, ``W_o``) and, over
    the fewest ancestors, the scores and the values in the decompressed
    form (``d_nope + d_rope`` and ``d_v`` a head), the smaller.  Bytes: the
    weights in bf16, the rows in and out, and each row's ancestors' latents
    (``c + d_rope`` bf16 values a word)."""
    A = ancestors(pos, M)
    weights = D * H * (dn + dr) + D * (c + dr) + c + c * H * (dn + dv) + H * dv * D
    proj = 2 * (D * H * (dn + dr) + D * (c + dr) + c * H * (dn + dv) + H * dv * D)
    nbytes = 2 * weights + 2 * R * D * 2 + R * A * (c + dr) * 2
    return nbytes, R * (proj + 2 * A * H * (dn + dr + dv))


def read(trace):
    if trace.kind != "serve":
        return None
    dev = trace.device.device_s_by_range.get("mla_attention")
    calls = trace.calls.get("mla_attention")
    if not dev or not calls:
        return None
    peaks = trace.peaks
    least = 0.0
    for key, n in calls.items():
        nbytes, ops = work(*key)
        least += n * max(nbytes / peaks["bytes"], ops / peaks["bf16"])
    return least / dev * 100.0
