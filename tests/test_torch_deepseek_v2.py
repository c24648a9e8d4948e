"""DeepSeek-V2 as the lattice search's word LM, on the CPU at a tiny size
(hidden 64, 1 dense + 1 MoE layer of 8 experts, top 2 and 1 shared,
``kv_lora_rank`` 32, rope 16, 200 words), against the plain reference
``benchmark/reference/deepseek_v2.py``: a step's log-probs, the path cache
after forks, ``BeamDecoder``'s top paths, the router's and the combine's
repeatability, the LSTM-only entry points' refusal, and the tracer's spans
and counters.  Both sides compute in fp32 here, so they agree to fp32's
summation-order noise; the card test holds the bf16 program at the
published widths."""

import math

import numpy as np
import pytest
import torch

from benchmark.core import registry
from benchmark.core.program import make_vocab
from benchmark.core.weights import dequantize_params, make_weights, quantize_params
from benchmark.data.lexicon import EOS_ID, realistic_lexicon, realistic_sentences
from benchmark.reference.beam import beam_search
from jlm_tpu_torch.decoder.engine import BeamDecoder, _at
from jlm_tpu_torch.decoder.incremental import IncrementalDecoder
from jlm_tpu_torch.models import deepseek_v2 as dsv2
from jlm_tpu_torch.ops import moe as moe_ops
from jlm_tpu_torch.utils import profiling

FAMILY = registry.family("deepseek_v2")
CPU = torch.device("cpu")
SEED = 2**31 + 7
MODEL = dict(registry.config("deepseek-v2-lite-14l")["model"], vocab_size=200, hidden_size=64,
             num_hidden_layers=2, intermediate_size=96, moe_intermediate_size=32,
             n_routed_experts=8, n_shared_experts=1, num_experts_per_tok=2,
             num_attention_heads=4, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=16,
             v_head_dim=16)
# a = 3 / sqrt(fan-in) over a normed input, as the configuration's scales
SCALES = {"embed": 1.0, "norm": 1.0, "q_proj": 3 / 8, "kv_a_proj": 3 / 8,
          "kv_b_proj": 3 / math.sqrt(32), "o_proj": 1.732 / 8, "mlp_in": 3 / 8,
          "dense_down": 1.732 / (0.6 * math.sqrt(96)), "expert_down": 1.732 / (0.6 * math.sqrt(32)),
          "shared_down": 1.732 / (0.6 * math.sqrt(32)), "router": 0.5, "head_W": 0.8}
SERVE = dict(registry.config("deepseek-v2-lite-14l")["serve"], beam_width=8)
# fp32 on both sides: the absorbed attention, the path cache and the
# grouped expert products change the order of the sums only (~1e-6 of the
# log-probs' few-to-twenty nats)
TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny products: one thread beats a thread pool's synchronisation."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    leaves = FAMILY.leaves(MODEL)
    w = make_weights(leaves, SCALES, SEED, CPU)
    q = quantize_params(w, leaves)
    config = FAMILY.make_config(MODEL, SERVE, max_nodes_per_frame=32)
    lex = realistic_lexicon(MODEL["vocab_size"], seed=7)
    return {"q": q, "ref": FAMILY.reference_lm(dequantize_params(q, leaves), MODEL),
            "config": config, "lex": lex}


def _decoder(tiny, **kw):
    vocab, lexicon = make_vocab(tiny["lex"])
    fwd = dsv2.make_forward(tiny["config"], torch.float32, int8_mxu=False)
    return BeamDecoder(tiny["q"], lexicon, vocab, tiny["config"], forward_fn=fwd, device="cpu",
                       **kw)


def _full_forward(lm, seqs):
    """The reference's log-probs ``[n, V]`` after the last word of each word
    sequence (``<eos>`` first), each fed from the initial state."""
    n, T = len(seqs), max(len(s) for s in seqs)
    feed = torch.full((T, n), EOS_ID, dtype=torch.long)
    for i, s in enumerate(seqs):
        feed[:len(s), i] = torch.tensor(s)
    state, out = lm.initial_state(n, CPU), torch.zeros((n, MODEL["vocab_size"]))
    for t in range(T):
        logp, state = lm.step(feed[t], state)
        last = torch.tensor([len(s) - 1 == t for s in seqs])
        out[last] = logp[last]
    return out


@pytest.mark.parametrize("frames", [1, 6])
def test_the_path_cache_after_forks_gives_the_reference_forward_of_each_path(tiny, frames):
    """Frame 1 (one step after the root), and frame 6 after every row forked
    from a random row up to ``max_word_len`` positions back, each frame:
    every row's log-probs over the whole vocabulary against the reference
    fed the row's path from the start."""
    dec = _decoder(tiny)
    fwd, params, config = dec._fwd, dec.params, tiny["config"]
    S, B, V, M = 3, config.beam_pad, MODEL["vocab_size"], config.max_word_len
    look_w = torch.arange(V).repeat(S, frames + 1, 1)  # every word a candidate
    payload = fwd.prepare(params, look_w)
    ring = fwd.path_state(params, S, B, frames, CPU)
    words = torch.full((S, B), EOS_ID, dtype=torch.long)
    cand, eos, rows = fwd(params, words, ring.root(), _at(payload, 0))
    ring.write(0, rows)
    paths = {0: [[[EOS_ID] for _ in range(B)] for _ in range(S)]}
    gen = torch.Generator().manual_seed(11)
    for pos in range(1, frames + 1):
        lo = max(0, pos - M)
        src = torch.randint(lo, pos, (S, B), generator=gen)
        sel = torch.randint(0, B, (S, B), generator=gen)
        words = torch.randint(2, V, (S, B), generator=gen)
        cand, eos, rows = fwd(params, words, ring.select(pos, src, sel), _at(payload, pos))
        ring.write(pos, rows)
        paths[pos] = [[paths[int(src[s, b])][s][int(sel[s, b])] + [int(words[s, b])]
                       for b in range(B)] for s in range(S)]
    want = _full_forward(tiny["ref"], [p for ps in paths[frames] for p in ps])
    got = cand.reshape(S * B, V)
    assert torch.equal(eos.reshape(-1), got[:, EOS_ID])
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=0)
    depths = rows.depth.reshape(-1)
    assert depths.tolist() == [len(p) - 1 for ps in paths[frames] for p in ps]


def test_decode_batch_finds_the_reference_beam_searchs_top_paths(tiny):
    kanas = realistic_sentences(tiny["lex"], 12, seed=3)
    got = _decoder(tiny).decode_batch(kanas)
    want = beam_search(tiny["ref"], kanas, tiny["lex"], SERVE["beam_width"],
                       SERVE["max_word_len"], 32, CPU)
    for r, (score, nodes) in zip(got, want):
        assert [w for _, w in r[0].segments] == [w for w, _ in nodes]
        assert abs(r[0].score - score) < TOL * 10  # summed over a path's ~5 words


def test_the_router_and_the_combine_repeat_and_match_a_loop():
    gen = torch.Generator().manual_seed(5)
    R, D, E, k, I = 40, 64, 8, 2, 32
    x = torch.randn(R, D, generator=gen)
    Wg = torch.randn(D, E, generator=gen) * 0.3
    gate_up = torch.randn(E, D, 2 * I, generator=gen) * 0.2
    down = torch.randn(E, I, D, generator=gen) * 0.2
    w, idx = moe_ops.route(x, Wg, k)
    w2, idx2 = moe_ops.route(x, Wg, k)
    assert torch.equal(idx, idx2) and torch.equal(w, w2)
    probs = torch.softmax(x @ Wg, dim=-1)
    assert torch.equal(idx[:, 0], probs.argmax(-1)) and bool((w[:, 0] >= w[:, 1]).all())
    y = moe_ops.experts(x, w, idx, gate_up, down)
    assert torch.equal(y, moe_ops.experts(x, w, idx, gate_up, down))
    loop = torch.zeros(R, D)
    for r in range(R):
        for i in range(k):
            e = int(idx[r, i])
            loop[r] += w[r, i] * moe_ops.mlp(x[r:r + 1], gate_up[e], down[e])[0]
    np.testing.assert_allclose(y.numpy(), loop.numpy(), atol=1e-5, rtol=0)


def _refusals():
    """Each LSTM-only entry point, called for the DeepSeek-V2 forward."""
    from jlm_tpu_torch.decoder.engine import _decode_scan, make_fused_frame_forward
    from jlm_tpu_torch.decoder.server import SessionServer
    from jlm_tpu_torch.decoder.suggest import Suggester

    def scan(tiny, dec, vocab, lexicon):
        packed, lengths = dec._pack(["あい"])
        _decode_scan(dec.params, torch.from_numpy(packed), torch.from_numpy(lengths),
                     config=tiny["config"], forward_fn=dec._fwd, export_rings=True)

    return {
        "decode_long": lambda t, d, v, lx: d.decode_long("あ" * 70),
        "IncrementalDecoder": lambda t, d, v, lx: IncrementalDecoder(
            t["q"], lx, v, t["config"], device="cpu"),
        "SessionServer": lambda t, d, v, lx: SessionServer(t["q"], lx, v, t["config"],
                                                           device="cpu"),
        "Suggester": lambda t, d, v, lx: Suggester(t["q"], v, t["config"], device="cpu"),
        "the fused frame": lambda t, d, v, lx: make_fused_frame_forward(t["config"]),
        "chaining, seeding and export_rings": scan,
    }


@pytest.mark.parametrize("entry", ["decode_long", "IncrementalDecoder", "SessionServer",
                                   "Suggester", "the fused frame",
                                   "chaining, seeding and export_rings"])
def test_the_lstm_only_entry_points_refuse_a_model_without_c_h(tiny, entry):
    dec = _decoder(tiny)
    vocab, lexicon = make_vocab(tiny["lex"])
    with pytest.raises(ValueError, match=f"{entry} carries the LSTM's"):
        _refusals()[entry](tiny, dec, vocab, lexicon)


def test_the_tracer_counts_the_experts_and_the_ancestors(tiny):
    """Spans ``model.mla`` and ``model.moe`` once a layer and frame; the
    counters of the chunk: rows x k routed a MoE layer and frame, the
    experts' largest and smallest routed rows, the ancestors attended."""
    kanas = realistic_sentences(tiny["lex"], 3, seed=4)
    dec = _decoder(tiny)
    profiling.enable(True)
    profiling.reset()
    try:
        dec.decode_batch(kanas)
        snap = profiling.snapshot()
    finally:
        profiling.enable(False)
        profiling.reset()
    S, B, k = 4, dec.config.beam_pad, MODEL["num_experts_per_tok"]
    frames = max(4, max(len(s) for s in kanas)) + 1
    totals = {n: t["count"] for n, t in snap["totals"].items()}
    assert totals["model.mla"] == frames * MODEL["num_hidden_layers"]
    assert totals["model.moe"] == frames * 1
    c = snap["counters"]
    assert c["moe.rows"] == frames * S * B * k
    assert 0 <= c["moe.expert_rows_min"] <= frames * S * B * k / 8 <= c["moe.expert_rows_max"]
    assert frames * S * B < c["mla.ancestors"] <= sum(p + 1 for p in range(frames)) * S * B
