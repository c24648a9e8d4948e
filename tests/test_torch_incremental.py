"""PyTorch port per-keystroke decoding vs the JAX package.

The port's ``IncrementalDecoder`` (and the model functions under it,
``candidate_logits`` / ``node_logits``) on the CPU at the TINY conftest
config, held to the JAX ``IncrementalDecoder`` and ``BeamDecoder``: the
cases of tests/test_incremental.py (all but the int8 export script, which
is not ported), with their tolerances (segments identical; fp32 scores
within 1e-3, int8-MXU within 0.2), plus sessions saved by either package
resumed by the other.  Kernel mode runs ``project_lse``'s plain version
here; the JAX referee runs its Pallas kernel in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jlm_tpu.config import Config, DSoftmaxConfig
from jlm_tpu.decoder import incremental as jax_inc
from jlm_tpu.decoder.engine import BeamDecoder as JaxBeamDecoder
from jlm_tpu.models import init_params
from jlm_tpu.models import lstm as jax_lstm
from jlm_tpu.ops.quant import quantize_params
from jlm_tpu_torch.decoder.incremental import IncrementalDecoder, build_probe_arrays
from jlm_tpu_torch.models import lstm as torch_lstm
from jlm_tpu_torch.models.params import params_to_torch

DS = DSoftmaxConfig(block_sizes=(64, 64, 128), block_dims=(64, 32, 16), mode="prefix")


def _ds_config(mode="prefix", seed=42, **kw):
    dims = (64, 32, 16) if mode == "prefix" else (32, 16, 16)
    return Config(vocab_size=256, embed_size=32, hidden_size=64, head="dsoftmax",
                  dsoftmax=DSoftmaxConfig(block_sizes=DS.block_sizes, block_dims=dims,
                                          mode=mode),
                  beam_width=4, max_kana_len=30, seed=seed, **kw)


def _inc(params, lexicon, vocab, config, **kw):
    return IncrementalDecoder(params, lexicon, vocab, config, device="cpu", **kw)


def _segs(results):
    return [r.segments for r in results]


class _Batch:
    """The JAX batch engine's n-best per kana, decoded once and kept."""

    def __init__(self, params, lexicon, vocab, config):
        self.eng = JaxBeamDecoder(params, lexicon, vocab, config)
        self.memo = {}

    def __call__(self, kana, n_best=1):
        if (kana, n_best) not in self.memo:
            self.memo[kana, n_best] = self.eng.decode(kana, n_best=n_best)
        return self.memo[kana, n_best]


@pytest.fixture(scope="module")
def batch(tiny_params, tiny_config, lexicon, vocab):
    return _Batch(tiny_params, lexicon, vocab, tiny_config)


@pytest.fixture(scope="module")
def inc(tiny_params, tiny_config, lexicon, vocab):
    return _inc(tiny_params, lexicon, vocab, tiny_config)


def _assert_same(res, ref, atol=1e-3):
    assert _segs(res) == _segs(ref)
    np.testing.assert_allclose([r.score for r in res], [r.score for r in ref], atol=atol)


# ---- the model functions under the lazy scoring ----

@pytest.mark.parametrize("head", ["full", "prefix", "disjoint"])
@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_candidate_and_node_logits_match_jax(head, int8, tiny_config):
    cfg = tiny_config if head == "full" else _ds_config(head)
    params = init_params(cfg)
    if int8:
        params = quantize_params(params)
    rng = np.random.default_rng(3)
    H = cfg.hidden_size
    words = rng.integers(0, cfg.vocab_size, 7).astype(np.int32)
    h_top = rng.uniform(-1, 1, (3, 5, H)).astype(np.float32)
    node_w = rng.integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    h_src = rng.uniform(-1, 1, (2, 6, 4, H)).astype(np.float32)
    tp = params_to_torch(params, "cpu")

    got = torch_lstm.candidate_logits(tp, cfg, torch.from_numpy(h_top),
                                      torch.from_numpy(words).long())
    want = jax_lstm.candidate_logits(params, cfg, jnp.asarray(h_top), jnp.asarray(words))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    got = torch_lstm.node_logits(tp, cfg, torch.from_numpy(h_src),
                                 torch.from_numpy(node_w).long())
    want = jax_lstm.node_logits(params, cfg, jnp.asarray(h_src), jnp.asarray(node_w))
    assert got.shape == (2, 6, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_probe_arrays_match_jax(tiny_config, lexicon):
    for window in ("", "きょ", "きょうはい", "ゑ"):
        got = build_probe_arrays(lexicon, tiny_config, 96, window)
        want = jax_inc.build_probe_arrays(lexicon, tiny_config, 96, window)
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g, w)
        assert got[3] == want[3]


# ---- tests/test_incremental.py's cases ----

def test_keystroke_stream_matches_batch(inc, batch, tiny_params, tiny_config, lexicon, vocab):
    """Every prefix equals the JAX batch decode of that prefix and the JAX
    incremental decoder's keystroke."""
    ref_inc = jax_inc.IncrementalDecoder(tiny_params, lexicon, vocab, tiny_config)
    kana = "きょうはいい"
    inc.reset()
    for i, ch in enumerate(kana, 1):
        res = inc.push(ch, n_best=2)
        _assert_same(res, batch(kana[:i], 2))
        _assert_same(res, ref_inc.push(ch, n_best=2))
    assert inc._ranked_next == ref_inc._ranked_next


def test_backspace_then_retype(inc, batch):
    inc.reset()
    for ch in "あめが":
        inc.push(ch)
    inc.pop()
    inc.pop()
    _assert_same(inc.push("き"), batch("あき"))  # now "あき"
    assert inc.push("よ")[0].segments == batch("あきよ")[0].segments


def test_reset_clears_session(inc, batch):
    inc.reset()
    inc.push("か")
    inc.reset()
    assert inc.results() == []
    assert inc.push("は")[0].segments == batch("は")[0].segments


def test_incremental_quantized(tiny_params, tiny_config, lexicon, vocab):
    qp = quantize_params(tiny_params)
    inc_q = _inc(qp, lexicon, vocab, tiny_config)
    for ch in "かみと":
        res = inc_q.push(ch)
    _assert_same(res, JaxBeamDecoder(qp, lexicon, vocab, tiny_config).decode("かみと"))


def test_dsoftmax_incremental(lexicon, vocab):
    cfg = _ds_config()
    params = init_params(cfg)
    inc_d = _inc(params, lexicon, vocab, cfg)
    for ch in "きょうは":
        res = inc_d.push(ch)
    _assert_same(res, JaxBeamDecoder(params, lexicon, vocab, cfg).decode("きょうは"))


def test_session_save_resume(tiny_params, tiny_config, lexicon, vocab, tmp_path, batch):
    """A session saved mid-sentence resumes in a fresh decoder and finishes
    as an uninterrupted one."""
    a = _inc(tiny_params, lexicon, vocab, tiny_config)
    for ch in "きょうは":
        a.push(ch)
    path = str(tmp_path / "session.npz")
    a.save_session(path)
    b = _inc(tiny_params, lexicon, vocab, tiny_config)
    b.load_session(path)
    assert b.kana == "きょうは"
    for ch in "いい":
        res = b.push(ch)
    _assert_same(res, batch("きょうはいい"))
    assert _segs(b.results(2)) == _segs(batch("きょうはいい", 2))


@pytest.mark.parametrize("saver", ["jax", "torch"])
def test_session_crosses_packages(saver, tiny_params, tiny_config, lexicon, vocab, tmp_path):
    """A session saved by either package loads in the other and continues
    to the same n-best; a snapshot of another beam_pad is refused."""
    jx = jax_inc.IncrementalDecoder(tiny_params, lexicon, vocab, tiny_config)
    pt = _inc(tiny_params, lexicon, vocab, tiny_config)
    src, dst = (jx, pt) if saver == "jax" else (pt, jx)
    for ch in "あめが":
        src.push(ch)
    path = str(tmp_path / f"from_{saver}.npz")
    src.save_session(path)
    dst.load_session(path)
    assert dst.kana == "あめが"
    _assert_same(dst.results(2), src.results(2))
    for ch in "ふる":
        _assert_same(dst.push(ch, n_best=2), src.push(ch, n_best=2))
    wide = _inc(tiny_params, lexicon, vocab, tiny_config.replace(beam_width=10))
    with pytest.raises(ValueError, match="beam_pad"):
        wide.load_session(path)


def test_speculative_matches_plain(tiny_params, tiny_config, lexicon, vocab, batch):
    """Speculation is invisible in the results: hits and misses both give
    the plain stream (and hits happen)."""
    spec = _inc(tiny_params, lexicon, vocab, tiny_config, speculate=4)
    kana = "きょうはいい"
    for i, ch in enumerate(kana, 1):
        _assert_same(spec.push(ch, n_best=2), batch(kana[:i], 2))
    assert spec.spec_hits + spec.spec_misses == len(kana)
    assert spec.spec_hits > 0, "the LM predictor never hit in 6 keystrokes"


def test_unified_one_dispatch_per_keystroke(tiny_params, tiny_config, lexicon, vocab, batch):
    """With speculation each keystroke issues exactly one device step
    (commit + probes + ranking + speculation); priming happens only at
    reset, roll and pop."""
    dec = _inc(tiny_params, lexicon, vocab, tiny_config, speculate=4)
    calls = {"unified": 0, "prime": 0}
    unified, prime = dec._unified, dec._prime_step

    def count_unified(*a, **k):
        calls["unified"] += 1
        return unified(*a, **k)

    def count_prime(*a, **k):
        calls["prime"] += 1
        return prime(*a, **k)

    dec._unified, dec._prime_step = count_unified, count_prime
    kana = "きょうはいい"
    for i, ch in enumerate(kana, 1):
        assert dec.push(ch)[0].segments == batch(kana[:i])[0].segments
    assert calls == {"unified": len(kana), "prime": 0}, calls


def test_speculative_forced_hit_and_miss(tiny_params, tiny_config, lexicon, vocab, batch):
    """Both paths pinned: a predictor that always names the next char (all
    hits) and one that never does (all misses)."""
    hit_dec = _inc(tiny_params, lexicon, vocab, tiny_config, speculate=2,
                   next_char_predictor=lambda prefix: ["きょうは"[len(prefix)], "ん"]
                   if len(prefix) < 4 else ["ん"])
    for i, ch in enumerate("きょうは", 1):
        assert hit_dec.push(ch)[0].segments == batch("きょうは"[:i])[0].segments
    assert (hit_dec.spec_hits, hit_dec.spec_misses) == (4, 0)
    miss_dec = _inc(tiny_params, lexicon, vocab, tiny_config, speculate=2,
                    next_char_predictor=lambda prefix: ["ん", "を"])
    for i, ch in enumerate("きょう", 1):
        assert miss_dec.push(ch)[0].segments == batch("きょう"[:i])[0].segments
    assert (miss_dec.spec_hits, miss_dec.spec_misses) == (0, 3)


def test_speculative_pop_invalidates(tiny_params, tiny_config, lexicon, vocab, batch):
    spec = _inc(tiny_params, lexicon, vocab, tiny_config, speculate=3)
    for ch in "あめが":
        spec.push(ch)
    spec.pop()
    spec.pop()
    assert spec.push("き")[0].segments == batch("あき")[0].segments


def test_window_roll_long_session(tiny_params, tiny_config, lexicon, vocab):
    """Typing past max_kana_len rolls the window; the port stays equal to
    the JAX decoder across the roll, the score is the exact cumulative LM
    score of the returned path, and pop cannot cross the roll."""
    from jlm_tpu.config import EOS_ID
    from jlm_tpu.oracle import OracleLM

    cfg = tiny_config.replace(max_kana_len=6)
    pt = _inc(tiny_params, lexicon, vocab, cfg)
    jx = jax_inc.IncrementalDecoder(tiny_params, lexicon, vocab, cfg)
    for ch in "きょうはいいあめがふるよ":  # 12 kana = 2 windows of 6
        res = pt.push(ch, n_best=2)
        _assert_same(res, jx.push(ch, n_best=2))
    assert pt._base == 6
    top = res[0]
    lm = OracleLM(tiny_params, cfg)
    state = lm.initial_state(1)
    ids = [EOS_ID] + [w for _, w in top.segments]
    want = 0.0
    for t in range(len(ids) - 1):
        logp, state = lm.step(np.asarray(ids[t:t + 1]), state)
        want += float(logp[0, ids[t + 1]])
    logp, _ = lm.step(np.asarray(ids[-1:]), state)
    want += float(logp[0, EOS_ID])
    assert abs(top.score - want) < 1e-3
    for _ in range(6):
        pt.pop()
    with pytest.raises(ValueError):
        pt.pop()


def test_lm_predictor_beats_static(tiny_params, tiny_config, lexicon, vocab):
    """The LM next-kana predictor beats the static prior on speculation hit
    rate over a fixed typing trace, and both match the JAX decoder's
    hits and misses exactly."""
    from jlm_tpu.data.synthetic import generate_test_set

    tests = generate_test_set(8, seed=777)

    def run(make, pred):
        dec = make(tiny_params, lexicon, vocab, tiny_config, precision="highest",
                   speculate=4, next_char_predictor=pred)
        for kana, _ in tests:
            dec.reset()
            for ch in kana:
                dec.push(ch)
        return dec.spec_hits, dec.spec_misses

    lm, static = run(_inc, None), run(_inc, "static")
    assert lm == run(jax_inc.IncrementalDecoder, None)
    assert static == run(jax_inc.IncrementalDecoder, "static")
    rate = lambda hm: hm[0] / max(1, sum(hm))  # noqa: E731
    assert rate(lm) > rate(static), (lm, static)
    assert rate(lm) > 0.25, lm


def test_kernel_lse_keystrokes_match(tiny_params, tiny_config, lexicon, vocab):
    """use_kernel=True (project_lse's fp32 path, the eos column gathered)
    matches the reference's use_pallas=True (interpret mode) and its
    logits-row path keystroke for keystroke."""
    pt = _inc(tiny_params, lexicon, vocab, tiny_config, use_kernel=True)
    jp = jax_inc.IncrementalDecoder(tiny_params, lexicon, vocab, tiny_config, use_pallas=True)
    pt_plain = _inc(tiny_params, lexicon, vocab, tiny_config)
    for ch in "きょうはいい":
        rp = pt.push(ch, n_best=2)
        _assert_same(rp, jp.push(ch, n_best=2))
        _assert_same(rp, pt_plain.push(ch, n_best=2))


def test_kernel_lse_int8_dsoftmax_keystrokes(lexicon, vocab):
    """The int8 D-softmax head in kernel mode: speed mode (bf16 compute,
    int8 x int8 per block) against the reference's speed-mode Pallas path
    within the int8-MXU tolerance, and the parity mode (dequant fp32)
    against the reference's logits-row path within 1e-3."""
    cfg = _ds_config(seed=3, max_nodes_per_frame=16)
    qp = quantize_params(init_params(cfg))
    speed = _inc(qp, lexicon, vocab, cfg, precision="default", use_kernel=True)
    parity = _inc(qp, lexicon, vocab, cfg, use_kernel=True)
    j_speed = jax_inc.IncrementalDecoder(qp, lexicon, vocab, cfg, precision="default",
                                         use_pallas=True)
    j_plain = jax_inc.IncrementalDecoder(qp, lexicon, vocab, cfg)
    for ch in "あめがふる":
        _assert_same(speed.push(ch), j_speed.push(ch), atol=0.2)
        _assert_same(parity.push(ch), j_plain.push(ch))
