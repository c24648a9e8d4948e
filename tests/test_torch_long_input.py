"""The port's ``decode_long`` (inputs past ``max_kana_len``) vs the JAX
package and the uncapped numpy oracle.

Everything runs on the CPU at tests/test_long_input.py's size (V 256, E 32,
H 64, beam 4, ``max_kana_len`` 12, ``n_best_max`` 2): the port's kernel
forward takes its plain versions here, the JAX speed forward its Pallas
kernels in interpret mode.  Tolerances follow tests/test_torch_engine.py:
fp32 scores within 1e-3 (the seeded scan's rings within 1e-5), the speed
modes held by path identity.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jlm_tpu.config import Config, DSoftmaxConfig, EOS_ID
from jlm_tpu.data import Lexicon, build_vocab, generate_corpus, generate_test_set
from jlm_tpu.decoder import engine as jax_engine
from jlm_tpu.decoder.lattice import build_lattice
from jlm_tpu.models.params import init_params
from jlm_tpu.oracle import OracleDecoder, OracleLM
from jlm_tpu.ops.quant import quantize_params
from jlm_tpu_torch.decoder import engine as torch_engine
from jlm_tpu_torch.decoder.engine import (
    BeamDecoder, full_softmax_forward, make_full_softmax_forward, make_fused_frame_forward,
    make_kernel_forward)


@pytest.fixture(scope="module")
def setup():
    cfg = Config(vocab_size=256, embed_size=32, hidden_size=64, beam_width=4,
                 max_kana_len=12, n_best_max=2, seed=0)
    vocab = build_vocab(generate_corpus(800, seed=1234), cfg.vocab_size)
    lex = Lexicon.from_vocab(vocab)
    params = init_params(cfg)
    port = BeamDecoder(params, lex, vocab, cfg, precision="highest", device="cpu")
    jx = jax_engine.BeamDecoder(params, lex, vocab, cfg, precision="highest")
    return cfg, vocab, lex, params, port, jx


def _uncapped(params, cfg, lex, vocab):
    """The oracle plays the reference's uncapped lattice: no frame bound."""
    return OracleDecoder(OracleLM(params, cfg), lex, vocab, cfg.replace(max_kana_len=64))


def _oracle_score(params, cfg, words):
    """A word path's LM score as the engine sums it: ``<eos>`` then each
    word from a zero state, plus ``<eos>`` at the end."""
    lm = OracleLM(params, cfg)
    state = lm.initial_state(1)
    ids = [EOS_ID] + list(words)
    total = 0.0
    for t in range(len(ids) - 1):
        logp, state = lm.step(np.asarray(ids[t:t + 1]), state)
        total += float(logp[0, ids[t + 1]])
    logp, _ = lm.step(np.asarray(ids[-1:]), state)
    return total + float(logp[0, EOS_ID])


def _same(port_res, jax_res, tol=1e-3):
    """Equal n-best segments, scores within ``tol``."""
    assert [r.segments for r in port_res] == [r.segments for r in jax_res]
    np.testing.assert_allclose([r.score for r in port_res], [r.score for r in jax_res],
                               atol=tol)


def _long(seed=42, n=6, cut=30):
    return "".join(k for k, _ in generate_test_set(n, seed=seed))[:cut]


# --- the seven cases of tests/test_long_input.py, through the port --------

def test_exact_scores_and_coverage(setup):
    cfg, _, _, params, port, jx = setup
    kana = _long()
    assert len(kana) > cfg.max_kana_len
    res = port.decode(kana, n_best=1)
    _same(res, jx.decode(kana, n_best=1))
    top = res[0]
    assert top.segments and top.surface
    assert abs(top.score - _oracle_score(params, cfg, [w for _, w in top.segments])) < 1e-3
    again = port.decode(kana, n_best=1)[0]
    assert (again.segments, again.score) == (top.segments, top.score)


def test_single_chunk_takes_the_short_path(setup):
    cfg, _, _, _, port, jx = setup
    kana = generate_test_set(1, seed=7)[0][0][:cfg.max_kana_len]
    a, b = port.decode(kana, n_best=1)[0], port.decode_batch([kana], n_best=1)[0][0]
    assert (a.segments, a.score) == (b.segments, b.score)
    _same([a], jx.decode(kana, n_best=1))


def test_decode_batch_mixed_lengths(setup):
    _, _, _, _, port, jx = setup
    tests = generate_test_set(5, seed=44)
    short = [k for k, _ in tests][:3]
    long_kana = "".join(k for k, _ in tests)[:28]
    batch = [short[0], long_kana, short[1], short[2]]
    res = port.decode_batch(batch, n_best=1)
    for r, want in zip(res, jx.decode_batch(batch, n_best=1)):
        _same(r, want)
    plain = port.decode_batch(short, n_best=1)
    assert [res[i][0].segments for i in (0, 2, 3)] == [p[0].segments for p in plain]
    assert res[1][0].segments == port.decode_long(long_kana, 1)[0].segments


def test_nbest(setup):
    cfg, _, _, params, port, jx = setup
    kana = _long(seed=43, cut=26)
    res = port.decode(kana, n_best=2)
    _same(res, jx.decode(kana, n_best=2))
    assert len(res) == 2 and res[0].score >= res[1].score
    want = _oracle_score(params, cfg, [w for _, w in res[1].segments])
    assert abs(res[1].score - want) < 1e-3


def test_adversarial_boundary_exact(setup):
    """A multi-kana word across the cut at position 12: the seeded chunk
    admits words that start in the overlap, so the result equals the
    uncapped search's, path and score."""
    cfg, vocab, lex, params, port, jx = setup
    span = next(r for r in lex.by_reading if len(r) >= 3)
    pad = "のははのははのははのは"[:11]
    kana = pad + span + "のは"
    assert len(pad) < cfg.max_kana_len < len(pad) + len(span)
    res = port.decode_long(kana, n_best=1)
    _same(res, jx.decode_long(kana, n_best=1))
    ref = _uncapped(params, cfg, lex, vocab).decode(kana, n_best=1)[0]
    assert res[0].segments == ref.segments, (res[0].surface, ref.surface)
    np.testing.assert_allclose(res[0].score, ref.score, atol=1e-3)
    got = _oracle_score(params, cfg, [w for _, w in res[0].segments])
    np.testing.assert_allclose(res[0].score, got, atol=1e-3)


def test_matches_uncapped_oracle_stream(setup):
    """Three inputs, each 3+ chunks deep, equal the uncapped oracle and the
    JAX package."""
    cfg, vocab, lex, params, port, jx = setup
    orc = _uncapped(params, cfg, lex, vocab)
    tests = generate_test_set(10, seed=99)
    for i in range(3):
        kana = "".join(k for k, _ in tests[i * 3:(i + 1) * 3])[:30 + i * 4]
        assert len(kana) > 2 * (cfg.max_kana_len - cfg.max_word_len)
        res = port.decode(kana, n_best=1)
        _same(res, jx.decode(kana, n_best=1))
        ref = orc.decode(kana, n_best=1)[0]
        assert res[0].segments == ref.segments, (kana, res[0].surface, ref.surface)
        np.testing.assert_allclose(res[0].score, ref.score, atol=1e-3)


def test_multiroot_fp32_kernel_forward(setup):
    """The fp32 kernel forward's ``score_hidden`` (``cand_dot`` +
    ``project_lse`` on the seeds' h_top) against the JAX Pallas forward
    (interpret mode) and the uncapped oracle."""
    cfg, vocab, lex, params, _, _ = setup
    port = BeamDecoder(params, lex, vocab, cfg, device="cpu",
                       forward_fn=make_kernel_forward(cfg, torch.float32))
    jx = jax_engine.BeamDecoder(params, lex, vocab, cfg, forward_fn=jax_engine.make_pallas_forward(
        cfg, tile_v=128, interpret=True))
    kana = _long()
    res = port.decode(kana, n_best=1)
    _same(res, jx.decode(kana, n_best=1))
    ref = _uncapped(params, cfg, lex, vocab).decode(kana, n_best=1)[0]
    assert res[0].segments == ref.segments
    np.testing.assert_allclose(res[0].score, ref.score, atol=1e-3)


def test_chain_fallback(setup):
    """A forward without ``score_hidden`` chains single roots: it still
    converts, equal to the JAX package's chain, with exact scores."""
    cfg, vocab, lex, params, _, _ = setup
    port = BeamDecoder(params, lex, vocab, cfg, device="cpu",
                       forward_fn=lambda p, w, s, cw: full_softmax_forward(p, cfg, w, s, cw))
    jx = jax_engine.BeamDecoder(params, lex, vocab, cfg, forward_fn=lambda p, w, s, cw:
                                jax_engine.full_softmax_forward(p, cfg, w, s, cw))
    kana = "".join(k for k, _ in generate_test_set(3, seed=42))[:30]
    res = port.decode(kana, n_best=2)
    _same(res, jx.decode(kana, n_best=2))
    assert res[0].segments
    got = _oracle_score(params, cfg, [w for _, w in res[0].segments])
    np.testing.assert_allclose(res[0].score, got, atol=1e-3)


# --- the port's other forwards --------------------------------------------

@pytest.mark.parametrize("mode", ["bf16", "int8-MXU"])
def test_speed_modes_match_uncapped_oracle(setup, mode):
    """bf16 weights (bf16 rings) and int8 weights with the native int8 head
    in speed mode: top-1 paths equal the uncapped oracle's on 3-chunk
    inputs (the int8 oracle for int8)."""
    cfg, vocab, lex, params, _, _ = setup
    p = quantize_params(params) if mode == "int8-MXU" else params
    port = BeamDecoder(p, lex, vocab, cfg.replace(int8_mxu=True), precision="default",
                       device="cpu")
    orc = _uncapped(p, cfg, lex, vocab)
    tests = generate_test_set(10, seed=99)
    for i in range(2):
        kana = "".join(k for k, _ in tests[i * 3:(i + 1) * 3])[:30]
        assert port.decode(kana)[0].segments == orc.decode(kana)[0].segments, (mode, kana)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_forward_paths_equal_split(setup, dtype):
    """The fused frame forward (``cell_cand_step``) over a long input: its
    n-best paths equal the split forward's; scores within 1e-3."""
    cfg, vocab, lex, params, _, _ = setup
    kana = _long(seed=99, n=9)
    got = BeamDecoder(params, lex, vocab, cfg, device="cpu",
                      forward_fn=make_fused_frame_forward(cfg, dtype)).decode(kana, n_best=2)
    want = BeamDecoder(params, lex, vocab, cfg, device="cpu",
                       forward_fn=make_kernel_forward(cfg, dtype)).decode(kana, n_best=2)
    _same(got, want)


def _peaked(params, std=0.5):
    """``params`` with the embedding and every LSTM and head weight scaled to
    standard deviation ``std``: at init the 2-layer model's states are
    small and its D-softmax near uniform, so a 15-word path scores about
    -83.177 whichever words it takes and paths differ by 1e-5, which the
    fp32 sum order decides; scaled, they differ by the search."""
    def scale(w):
        w = np.asarray(w)
        return w * np.float32(std / w.std())

    return {**params, "embedding": scale(params["embedding"]),
            "lstm": [{**l, "W": scale(l["W"])} for l in params["lstm"]],
            "head": {"blocks": [{**b, "W": scale(b["W"])} for b in params["head"]["blocks"]]}}


def _embedding_head_peaked(params, emb=1.0, head=4.0):
    """``params`` with the embedding scaled to standard deviation ``emb``
    and the head to ``head``, the LSTM as initialised: log-probs spread by
    about a nat and move with the context by several, so paths do not tie
    (at init a path's words change its score by 1e-5), while the
    recurrence still contracts, so rounding does not grow along an input."""
    def scale(w, std):
        w = np.asarray(w)
        return w * np.float32(std / w.std())

    return {**params, "embedding": scale(params["embedding"], emb),
            "head": {**params["head"], "W": scale(params["head"]["W"], head)}}


def test_two_layer_dsoftmax_vs_jax(lexicon, vocab):
    """2 layers and a D-softmax head: the fp32 parity forward and the fp32
    kernel forward (against the JAX Pallas forward) over a long input, and
    the uncapped oracle's top-1."""
    cfg = Config(vocab_size=256, embed_size=32, hidden_size=64, num_layers=2, beam_width=4,
                 head="dsoftmax", dsoftmax=DSoftmaxConfig(block_sizes=(64, 192),
                                                          block_dims=(64, 32)),
                 max_kana_len=12, n_best_max=2, seed=3)
    params = _peaked(init_params(cfg))
    kana = _long(seed=99, n=9, cut=27)
    for port_fwd, jax_fwd in (
            (None, None),
            (make_kernel_forward(cfg, torch.float32),
             jax_engine.make_pallas_forward(cfg, tile_v=128, interpret=True))):
        port = BeamDecoder(params, lexicon, vocab, cfg, device="cpu", forward_fn=port_fwd)
        jx = jax_engine.BeamDecoder(params, lexicon, vocab, cfg, forward_fn=jax_fwd)
        res = port.decode(kana, n_best=2)
        _same(res, jx.decode(kana, n_best=2))
    ref = _uncapped(params, cfg, lexicon, vocab).decode(kana)[0]
    assert res[0].segments == ref.segments
    np.testing.assert_allclose(res[0].score, ref.score, atol=1e-3)


@pytest.mark.parametrize("forward", ["full", "kernel", "fused"])
def test_score_hidden_vs_reference_hook(setup, forward):
    """Each forward's ``score_hidden`` against the reference's hook on the
    same h_top at S = 3 sentences x M = 5 seeded rows, B = 4, fp32."""
    cfg, vocab, lex, params, _, _ = setup
    S, M, B, C = 3, 5, 4, cfg.max_lookahead
    rng = np.random.default_rng(5)
    h_top = rng.uniform(-1, 1, (S * M, B, cfg.hidden_size)).astype(np.float32)
    look_w = rng.integers(0, cfg.vocab_size, (S * M, 2, C)).astype(np.int32)
    if forward == "full":
        port_fwd, jax_fwd = make_full_softmax_forward(cfg), jax_engine.make_full_softmax_forward(cfg)
        got = port_fwd.score_hidden(BeamDecoder(params, lex, vocab, cfg, device="cpu").params,
                                    torch.from_numpy(h_top), torch.from_numpy(look_w[:, 1]).long())
        want = jax_fwd.score_hidden(params, jnp.asarray(h_top), jnp.asarray(look_w[:, 1]))
    else:
        make = make_kernel_forward if forward == "kernel" else make_fused_frame_forward
        port = BeamDecoder(params, lex, vocab, cfg, device="cpu",
                           forward_fn=make(cfg, torch.float32))
        jx = jax_engine.BeamDecoder(params, lex, vocab, cfg,
                                    forward_fn=jax_engine.make_pallas_forward(
                                        cfg, tile_v=128, interpret=True))
        payload = port._fwd.prepare(port.params, torch.from_numpy(look_w))
        got = port._fwd.score_hidden(port.params, torch.from_numpy(h_top),
                                     {k: v[1] for k, v in payload.items()})
        jpay = jx._fwd.prepare(jx.params, jnp.asarray(look_w))
        want = jx._fwd.score_hidden(jx.params, jnp.asarray(h_top),
                                    {k: v[:, 1] for k, v in jpay.items()})
    assert got.shape == (S * M, B, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("mode", ["fp32", "bf16", "int8-MXU"])
def test_chunked_equals_the_ports_unchunked_scan(setup, mode):
    """Overlap-save is exact: at ``max_kana_len`` 20 a 60-kana input runs in
    four chunks, and its n-best equals one unchunked scan of the same
    forward at ``max_kana_len`` 63 (the packing's bound), in the parity mode
    and in both speed modes; at the initialised weights (paths tie to
    1e-5) and where paths do not tie (``_embedding_head_peaked``)."""
    cfg, vocab, lex, params, _, _ = setup
    cfg = cfg.replace(beam_width=10, n_best_max=3)
    for weights in (params, _embedding_head_peaked(params)):
        p = quantize_params(weights) if mode == "int8-MXU" else weights
        for seed in (61, 62):
            kana = "".join(k for k, _ in generate_test_set(12, seed=seed))[:60]
            got, want = (BeamDecoder(p, lex, vocab, cfg.replace(max_kana_len=t, int8_mxu=True),
                                     precision="highest" if mode == "fp32" else "default",
                                     device="cpu").decode(kana, n_best=3) for t in (20, 63))
            _same(got, want, tol=1e-4)


@pytest.mark.parametrize("forward", ["full", "kernel"])
def test_peaked_weights_vs_jax_and_oracle(setup, forward):
    """Where paths do not tie: three 3-chunk inputs through the port's
    ``decode_long`` equal the JAX package's (n-best 2, scores 1e-3) and
    the uncapped oracle's top-1, in the fp32 parity forward and the fp32
    kernel forward (against the JAX Pallas forward)."""
    cfg, vocab, lex, params, _, _ = setup
    p = _embedding_head_peaked(params)
    if forward == "full":
        port = BeamDecoder(p, lex, vocab, cfg, precision="highest", device="cpu")
        jx = jax_engine.BeamDecoder(p, lex, vocab, cfg, precision="highest")
    else:
        port = BeamDecoder(p, lex, vocab, cfg, device="cpu",
                           forward_fn=make_kernel_forward(cfg, torch.float32))
        jx = jax_engine.BeamDecoder(p, lex, vocab, cfg, forward_fn=jax_engine.make_pallas_forward(
            cfg, tile_v=128, interpret=True))
    orc = _uncapped(p, cfg, lex, vocab)
    tests = generate_test_set(10, seed=99)
    for i in range(3):
        kana = "".join(k for k, _ in tests[i * 3:(i + 1) * 3])[:30 + i * 4]
        res = port.decode(kana, n_best=2)
        _same(res, jx.decode_long(kana, n_best=2))
        ref = orc.decode(kana, n_best=1)[0]
        assert res[0].segments == ref.segments, (kana, res[0].surface, ref.surface)
        np.testing.assert_allclose(res[0].score, ref.score, atol=1e-3)


def _windows(kanas, lo, hi, mask_upto, cfg, lex, vocab):
    """Each input's window [lo, hi) packed into one batch; frames up to
    ``mask_upto`` cleared as ``_pack_window`` clears them."""
    wins = [k[lo:hi] for k in kanas]
    packed, _ = jax_engine.pack_lattice_batch([build_lattice(w, lex, vocab, cfg) for w in wins])
    packed = packed[:, :max(len(w) for w in wins)].copy()
    packed[:, :mask_upto] = 0
    return packed, np.asarray([len(w) for w in wins], np.int32)


@pytest.mark.parametrize("forward", ["full", "kernel"])
def test_seeded_scan_at_two_sentences_equals_reference(setup, forward):
    """``_decode_scan``'s "first", "mid" and "last" variants at S = 2, each
    fed the reference's own seeds: rings within 1e-5, backpointers,
    final_topk, paths, root_pos and root_beam equal.  At S >= 2 a seed
    slice taken along the wrong axis of the time-major payload shows."""
    cfg, vocab, lex, params, _, _ = setup
    M, T_c = cfg.max_word_len, cfg.max_kana_len
    if forward == "full":
        port = BeamDecoder(params, lex, vocab, cfg, device="cpu")
        jx = jax_engine.BeamDecoder(params, lex, vocab, cfg)
    else:
        port = BeamDecoder(params, lex, vocab, cfg, device="cpu",
                           forward_fn=make_kernel_forward(cfg, torch.float32))
        jx = jax_engine.BeamDecoder(params, lex, vocab, cfg, forward_fn=jax_engine.make_pallas_forward(
            cfg, tile_v=128, interpret=True))
    tests = generate_test_set(12, seed=31)
    kanas = ["".join(k for k, _ in tests[:6])[:26], "".join(k for k, _ in tests[6:])[:23]]
    cut2 = T_c + (T_c - M)
    steps = [("first", 0, T_c, 0, dict(export_rings=True, walk=False)),
             ("mid", T_c - M, cut2, M, dict(seed_m=M, export_rings=True, walk=False)),
             ("last", cut2 - M, 64, M, dict(seed_m=M))]
    seed = None
    for name, lo, hi, mask_upto, kw in steps:
        packed, lengths = _windows(kanas, lo, hi, mask_upto, cfg, lex, vocab)
        want = jax_engine._decode_scan(jx.params, jnp.asarray(packed), jnp.asarray(lengths),
                                       seed=seed, config=cfg, forward_fn=jx._fwd, **kw)
        t_seed = None if seed is None else {k: torch.from_numpy(np.array(v))
                                            for k, v in seed.items()}
        got = torch_engine._decode_scan(port.params, torch.from_numpy(packed),
                                        torch.from_numpy(lengths), seed=t_seed, config=cfg,
                                        forward_fn=port._fwd, **kw)
        if "rings" in want:
            for k in ("score", "c", "h"):
                np.testing.assert_allclose(got["rings"][k].numpy(), np.asarray(want["rings"][k]),
                                           atol=1e-5, rtol=0, err_msg=f"{name} rings {k}")
            seed = want["rings"]
        if "bp" in want:
            for g, w in zip(got["bp"], want["bp"]):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
        else:
            for k in ("final_topk", "paths", "root_pos", "root_beam"):
                g, w = got[k].numpy(), np.asarray(want[k])
                if k == "final_topk":
                    np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=k)
                else:
                    np.testing.assert_array_equal(g, w, err_msg=k)
            assert (got["root_pos"].numpy() > 0).any()  # a walk entered the seeded rows


def test_realistic_lattice_long_input():
    """A long input over the realistic 100k lexicon (about 10 nodes a kana;
    ``max_nodes_per_frame`` 32, no node dropped): the uncapped oracle's path
    and score, and the JAX package's."""
    from jlm_tpu.config import Config as JConfig
    from jlm_tpu_torch.data.realistic import (
        generate_realistic_lexicon, generate_realistic_test_set, lattice_density_stats)
    from jlm_tpu_torch.data.lexicon import Lexicon as PLexicon

    vocab = generate_realistic_lexicon(100_000, seed=7)
    lex = PLexicon.from_vocab(vocab)
    cfg = JConfig(vocab_size=100_000, embed_size=32, hidden_size=64, beam_width=4,
                  max_kana_len=30, max_nodes_per_frame=32, n_best_max=1, seed=11)
    tests = generate_realistic_test_set(vocab, 12, seed=123, min_words=3, max_words=5)
    kana = "".join(k for k, _ in tests)[:60]
    assert len(kana) > 2 * cfg.max_kana_len - cfg.max_word_len
    stats = lattice_density_stats([kana], lex, vocab, cfg.replace(max_kana_len=len(kana)))
    assert stats["dropped_frac"] == 0.0 and stats["nodes_per_kana"] > 8, stats
    params = init_params(cfg)
    res = BeamDecoder(params, lex, vocab, cfg, device="cpu").decode(kana)
    _same(res, jax_engine.BeamDecoder(params, lex, vocab, cfg).decode(kana))
    ref = _uncapped(params, cfg, lex, vocab).decode(kana)[0]
    assert res[0].segments == ref.segments
    np.testing.assert_allclose(res[0].score, ref.score, atol=1e-3)


def test_stream_and_async_refuse_over_length(setup):
    """``decode_stream`` / ``decode_batch_async`` take no input past
    ``max_kana_len`` (as the reference's lattice builder asserts); the
    error names the entry points that convert it."""
    cfg, _, _, _, port, _ = setup
    kana = _long()
    for call in (lambda: port.decode_stream(["きょうは", kana]),
                 lambda: port.decode_batch_async([kana])):
        with pytest.raises(ValueError, match="decode_batch"):
            call()
