"""DeepSeek-V2 on the card at the published widths: the bf16 program's
log-probs through the latent path cache against the plain fp32 reference.

One dense and one MoE layer (DeepSeek-V2-Lite's widths: hidden 2,048, MLA
with 16 heads and a 512-wide latent, 64 experts of 1,408 with top 6 and 2
shared, the int8 head over 102,400 words), 2,560 rows (256 sentences of
beam 10), 6 frames after the root in which every row forks from a random
row up to ``max_word_len`` positions back.  Marker ``cuda``; the file
imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_deepseek_v2_cuda.py
"""

import pytest
import torch

from benchmark.core import registry
from benchmark.core.weights import dequantize_params, make_weights, quantize_params
from benchmark.data.lexicon import EOS_ID
from jlm_tpu_torch.decoder.engine import _at
from jlm_tpu_torch.models import deepseek_v2 as dsv2

FAMILY = registry.family("deepseek_v2")
CFG = registry.config("deepseek-v2-lite-14l")
MODEL = dict(CFG["model"], num_hidden_layers=2)
SEED = 2**31 + 19
S, FRAMES, C = 256, 6, 64
# The largest |log-prob| gap over the rows' candidate columns.  The
# program's blocks round every product's operands, the residual stream and
# the path cache to bf16 (8 bits of mantissa), its routers may swap an
# expert near a tie, and its head quantizes each row to int8, through 2
# layers and a normaliser over 102,400 words.  On an H100 (700 W) the
# program read 0.6625 and the reference one precision lower (e4m3 operands
# in the blocks, an int4 head) 3.55-3.58 (PERF.md §6): the bound sits near
# their geometric mean, 2.3x above the one and 2.4x below the other.
TOL = 1.5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _full_forward(lm, seqs, device):
    """The reference's log-probs ``[n, V]`` after the last word of each
    word sequence, each fed from the initial state (paths of unequal
    length run in lockstep)."""
    n, T = seqs.shape[0], seqs.shape[1]
    lengths = (seqs >= 0).sum(1)
    state, out = lm.initial_state(n, device), None
    for t in range(T):
        logp, state = lm.step(seqs[:, t].clamp(min=0), state)
        out = logp if out is None else torch.where((lengths - 1 == t)[:, None], logp, out)
    return out


@pytest.mark.cuda
def test_the_path_cache_after_forks_at_the_published_widths(cuda):
    leaves = FAMILY.leaves(MODEL)
    w = make_weights(leaves, CFG["weights"], SEED, cuda)
    q = quantize_params(w, leaves)
    config = FAMILY.make_config(MODEL, CFG["serve"])
    fwd = dsv2.make_forward(config)  # bf16 blocks, the int8 x int8 head
    params = dict(q)
    params["_decode"] = fwd.build_head(params, config, fwd.compute_dtype)
    B, V, M = config.beam_pad, config.vocab_size, config.max_word_len
    gen = torch.Generator(device=cuda).manual_seed(5)
    look_w = torch.randint(2, V, (S, FRAMES + 1, C), generator=gen, device=cuda)
    payload = fwd.prepare(params, look_w)
    ring = fwd.path_state(params, S, B, FRAMES, cuda)
    words = torch.full((S, B), EOS_ID, dtype=torch.long, device=cuda)
    _, _, rows = fwd(params, words, ring.root(), _at(payload, 0))
    ring.write(0, rows)
    # every row's path: [S, B, frames + 1] word ids, -1 past its end
    paths = {0: torch.full((S, B, FRAMES + 1), -1, dtype=torch.long, device=cuda)}
    paths[0][..., 0] = EOS_ID
    s_idx = torch.arange(S, device=cuda)[:, None]
    for pos in range(1, FRAMES + 1):
        src = torch.randint(max(0, pos - M), pos, (S, B), generator=gen, device=cuda)
        sel = torch.randint(0, B, (S, B), generator=gen, device=cuda)
        words = torch.randint(2, V, (S, B), generator=gen, device=cuda)
        cand, eos, rows = fwd(params, words, ring.select(pos, src, sel), _at(payload, pos))
        ring.write(pos, rows)
        stacked = torch.stack([paths[p] for p in range(pos)])  # [pos, S, B, F+1]
        parent = stacked[src, s_idx, sel]  # [S, B, F+1]
        depth = rows.depth  # the words after <eos>
        paths[pos] = parent.scatter(2, depth[..., None], words[..., None])
    got = torch.cat([cand, eos[..., None]], dim=2).reshape(S * B, C + 1)
    cols = torch.cat([look_w[:, FRAMES], torch.full((S, 1), EOS_ID, device=cuda)], dim=1)
    cols = cols[:, None, :].expand(S, B, C + 1).reshape(S * B, C + 1)
    seqs = paths[FRAMES].reshape(S * B, -1)
    del params["_decode"], ring, payload
    torch.cuda.empty_cache()

    def gap(lm):
        want = _full_forward(lm, seqs, cuda).gather(1, cols)
        return float((got - want).abs().max())

    sound = gap(FAMILY.reference_lm(dequantize_params(q, leaves), MODEL))
    control = gap(FAMILY.control_lm(w, MODEL))
    print(f"deepseek_v2 card: program gap {sound!r}, control gap {control!r}, bound {TOL}")
    assert sound < TOL < control
