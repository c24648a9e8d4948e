"""PyTorch port multi-session server and suggester vs the JAX package.

The port's ``SessionServer`` on the CPU at the TINY conftest config, held
to the JAX ``SessionServer``, ``BeamDecoder`` and ``IncrementalDecoder``:
the cases of tests/test_server.py (segments identical, fp32 scores within
1e-3), and the port's ``Suggester`` against the JAX one (ids equal, logp
within 1e-5).
"""

import numpy as np
import pytest
import torch

from jlm_tpu.config import EOS_ID, Config, DSoftmaxConfig
from jlm_tpu.data import generate_test_set
from jlm_tpu.decoder import server as jax_server
from jlm_tpu.decoder.engine import BeamDecoder as JaxBeamDecoder
from jlm_tpu.decoder.suggest import Suggester as JaxSuggester
from jlm_tpu.models import init_params
from jlm_tpu.ops.quant import quantize_params
from jlm_tpu_torch.decoder.incremental import IncrementalDecoder
from jlm_tpu_torch.decoder.server import SessionServer
from jlm_tpu_torch.decoder.suggest import Suggester


def _server(params, lexicon, vocab, config, **kw):
    return SessionServer(params, lexicon, vocab, config, device="cpu", **kw)


def _assert_same(res, ref, atol=1e-3):
    assert [r.segments for r in res] == [r.segments for r in ref]
    np.testing.assert_allclose([r.score for r in res], [r.score for r in ref], atol=atol)


@pytest.fixture(scope="module")
def server(tiny_params, tiny_config, lexicon, vocab):
    return _server(tiny_params, lexicon, vocab, tiny_config, max_sessions=8)


@pytest.fixture(scope="module")
def batch_dec(tiny_params, tiny_config, lexicon, vocab):
    return JaxBeamDecoder(tiny_params, lexicon, vocab, tiny_config)


def test_interleaved_sessions_match_batch(server, batch_dec, tiny_params, tiny_config, lexicon,
                                          vocab):
    """Three sessions' keystrokes interleaved in shared steps: each equals
    its solo batch decode and the JAX server's session."""
    texts = ["きょうはいい", "あめがふる", "かみとかわ"]
    ref = jax_server.SessionServer(tiny_params, lexicon, vocab, tiny_config, max_sessions=8)
    sids = [server.open() for _ in texts]
    ref_sids = [ref.open() for _ in texts]
    for t in range(max(len(x) for x in texts)):
        server.push([(s, x[t]) for s, x in zip(sids, texts) if t < len(x)])
        ref.push([(s, x[t]) for s, x in zip(ref_sids, texts) if t < len(x)])
    for sid, ref_sid, text in zip(sids, ref_sids, texts):
        res = server.results(sid, n_best=2)
        _assert_same(res, batch_dec.decode(text, n_best=2))
        _assert_same(res, ref.results(ref_sid, n_best=2))
        assert server.suggest_next(sid) == ref.suggest_next(ref_sid)
    for sid in sids:
        server.close(sid)


def test_session_reuse_after_close(server, batch_dec):
    sid = server.open()
    for ch in "はし":
        server.push([(sid, ch)])
    server.close(sid)
    sid2 = server.open()
    for ch in "あめ":
        server.push([(sid2, ch)])
    _assert_same(server.results(sid2), batch_dec.decode("あめ"))
    server.close(sid2)


def test_backspace_in_server(server, batch_dec):
    sid = server.open()
    for ch in "きょう":
        server.push([(sid, ch)])
    server.backspace(sid)
    server.push([(sid, "く")])  # きょく
    assert server.results(sid)[0].segments == batch_dec.decode("きょく")[0].segments
    server.close(sid)


def test_single_event_bucket_padding(server, batch_dec):
    """One event pads to its bucket; the padding writes only the reserved
    row and corrupts no session."""
    sid_a, sid_b = server.open(), server.open()
    server.push([(sid_a, "か"), (sid_b, "き")])
    server.push([(sid_a, "み")])  # b idle
    server.push([(sid_b, "く")])
    assert server.results(sid_a)[0].segments == batch_dec.decode("かみ")[0].segments
    assert server.results(sid_b)[0].segments == batch_dec.decode("きく")[0].segments
    server.close(sid_a)
    server.close(sid_b)


def test_server_window_roll_long_session(tiny_params, lexicon, vocab):
    """200-kana sessions roll windows and stay identical to the port's
    single-session decoder across the rolls; backspace cannot cross one."""
    cfg = Config(vocab_size=256, embed_size=32, hidden_size=64, beam_width=4,
                 max_kana_len=8, seed=42)  # tiny window: many rolls
    srv = _server(tiny_params, lexicon, vocab, cfg, max_sessions=4)
    inc = IncrementalDecoder(tiny_params, lexicon, vocab, cfg, device="cpu")
    kana = "".join(k for k, _ in generate_test_set(25, seed=31))[:200]
    assert len(kana) == 200
    sid = srv.open()
    for t, ch in enumerate(kana, 1):
        srv.push([(sid, ch)])
        inc.push(ch)
        if t % 40 == 0 or t == len(kana):
            _assert_same(srv.results(sid), inc.results(1))
    assert srv._base[sid] >= 8 * ((200 - 1) // 8) - 8
    while len(srv._kana[sid]) > srv._base[sid]:
        srv.backspace(sid)
    with pytest.raises(ValueError):
        srv.backspace(sid)
    srv.close(sid)


def test_server_suggest_next(server, tiny_params, tiny_config, lexicon, vocab):
    """The step's probes rank next kana as the single-session decoder's
    LM ranking does."""
    inc = IncrementalDecoder(tiny_params, lexicon, vocab, tiny_config, device="cpu")
    sid = server.open()
    for ch in "きょ":
        server.push([(sid, ch)])
        inc.push(ch)
    sugg = server.suggest_next(sid, k=8)
    assert sugg, "no suggestions after the probes rode the push payload"
    assert sugg[0] == inc._ranked_next[0]
    server.close(sid)


def test_server_probes_off(tiny_params, tiny_config, lexicon, vocab, batch_dec):
    """probes=False leaves the probe scoring out: the payload is 4B wide,
    the results unchanged, suggest_next returns []."""
    srv = _server(tiny_params, lexicon, vocab, tiny_config, max_sessions=4, probes=False)
    sid = srv.open()
    for ch in "きょうは":
        srv.push([(sid, ch)])
    assert srv.results(sid)[0].segments == batch_dec.decode("きょうは")[0].segments
    assert srv.suggest_next(sid) == []
    assert srv._probe_scores[sid].shape == (0,)
    srv.close(sid)


def test_server_dsoftmax_int8(lexicon, vocab):
    cfg = Config(vocab_size=256, embed_size=32, hidden_size=64, head="dsoftmax",
                 dsoftmax=DSoftmaxConfig(block_sizes=(64, 64, 128), block_dims=(64, 32, 16),
                                         mode="prefix"),
                 beam_width=4, max_kana_len=30, seed=42)
    qp = quantize_params(init_params(cfg))
    srv = _server(qp, lexicon, vocab, cfg, max_sessions=4)
    sid = srv.open()
    for ch in "きょうは":
        srv.push([(sid, ch)])
    _assert_same(srv.results(sid), JaxBeamDecoder(qp, lexicon, vocab, cfg).decode("きょうは"))


def test_server_kernel_lse_matches(tiny_params, tiny_config, lexicon, vocab, batch_dec):
    """The batched step with the project_lse normalizer (its fp32 plain
    version here) matches batch decoding and the reference server's
    use_pallas=True (interpret mode)."""
    srv = _server(tiny_params, lexicon, vocab, tiny_config, max_sessions=4, use_kernel=True)
    ref = jax_server.SessionServer(tiny_params, lexicon, vocab, tiny_config, max_sessions=4,
                                   use_pallas=True)
    text = ["きょうは", "あめがふ"]
    sids, ref_sids = [srv.open(), srv.open()], [ref.open(), ref.open()]
    for i in range(4):
        srv.push([(s, x[i]) for s, x in zip(sids, text)])
        ref.push([(s, x[i]) for s, x in zip(ref_sids, text)])
    for sid, ref_sid, x in zip(sids, ref_sids, text):
        res = srv.results(sid)
        _assert_same(res, batch_dec.decode(x))
        _assert_same(res, ref.results(ref_sid))


def test_server_matches_incremental_speed_mode(lexicon, vocab):
    """Kernel speed mode (bf16 compute, int8 x int8 head) on int8 weights:
    the server's sessions equal the port's single-session decoder in the
    same mode, and the JAX server's speed mode within the int8 tolerance."""
    cfg = Config(vocab_size=256, embed_size=32, hidden_size=64, beam_width=4,
                 max_kana_len=30, seed=5)
    qp = quantize_params(init_params(cfg))
    kw = dict(precision="default", use_kernel=True)
    srv = _server(qp, lexicon, vocab, cfg, max_sessions=4, **kw)
    ref = jax_server.SessionServer(qp, lexicon, vocab, cfg, max_sessions=4,
                                   precision="default", use_pallas=True)
    texts = ["きょうは", "かみと"]
    sids, ref_sids = [srv.open() for _ in texts], [ref.open() for _ in texts]
    incs = [IncrementalDecoder(qp, lexicon, vocab, cfg, device="cpu", **kw) for _ in texts]
    for t in range(4):
        srv.push([(s, x[t]) for s, x in zip(sids, texts) if t < len(x)])
        ref.push([(s, x[t]) for s, x in zip(ref_sids, texts) if t < len(x)])
        for inc, x in zip(incs, texts):
            if t < len(x):
                inc.push(x[t])
    for sid, ref_sid, inc in zip(sids, ref_sids, incs):
        _assert_same(srv.results(sid, 2), inc.results(2), atol=1e-5)
        _assert_same(srv.results(sid, 2), ref.results(ref_sid, 2), atol=0.2)


@pytest.mark.parametrize("context", [[], [5], [17, 3, 9], list(range(10, 19))])
def test_suggester_matches_jax(context, tiny_params, tiny_config, vocab):
    """The top-k: the same ids in the same order, logp within 1e-5."""
    import jax
    import jax.numpy as jnp

    pt, jx = Suggester(tiny_params, vocab, tiny_config, device="cpu"), JaxSuggester(
        tiny_params, vocab, tiny_config)
    got, want = pt.suggest(context, k=5), jx.suggest(context, k=5)
    assert [d for d, _ in got] == [d for d, _ in want]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want], atol=1e-5, rtol=0)
    n = len(context)
    ids = context + [EOS_ID] * (jx._bucket(max(n, 1)) - n)  # as suggest pads
    want_ids = jax.lax.top_k(jx._run(jx.params, jnp.asarray(ids, jnp.int32), jnp.int32(n)), 5)[1]
    assert pt.top_k(context, k=5)[0] == np.asarray(want_ids).tolist()


def test_suggester_mesh_not_ported(tiny_params, tiny_config, vocab):
    """The mesh option is ported now (tests/test_torch_sharded.py drives it
    on a four-rank world): a one-rank mesh gives the one-device top-k."""
    from jlm_tpu_torch.parallel.mesh import Mesh

    one = Suggester(tiny_params, vocab, tiny_config, device="cpu")
    meshed = Suggester(tiny_params, vocab, tiny_config, mesh=Mesh(1, 1, 0, torch.device("cpu")),
                       device="cpu")
    assert meshed.top_k([5, 6], k=5) == one.top_k([5, 6], k=5)
