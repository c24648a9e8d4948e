"""PyTorch port decode engine vs the JAX engine and the numpy oracle.

Everything runs on the CPU at the TINY conftest config: the port's kernel
forward takes its plain versions there, the JAX speed forward its Pallas
kernels in interpret mode.  Tolerances follow tests/test_engine_parity.py:
fp32 scores within 1e-3, bf16 speed mode within 0.1, int8-MXU within 0.2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jlm_tpu.config import Config, DSoftmaxConfig
from jlm_tpu.decoder import engine as jax_engine
from jlm_tpu.decoder.lattice import build_lattice
from jlm_tpu.models import init_params
from jlm_tpu.oracle import OracleDecoder, OracleLM
from jlm_tpu.ops.quant import quantize_params
from jlm_tpu_torch.decoder import engine as torch_engine
from jlm_tpu_torch.decoder.engine import BeamDecoder, topk_stable

KANAS = [
    "きょうはいい",
    "あめがふる",
    "はしをみる",
    "かみとかわ",
    "きょうはいいてんき",
    "ゑ",  # unknown fallback
    "とてもさむいです",
]


@pytest.fixture(scope="module")
def oracle(tiny_params, tiny_config, lexicon, vocab):
    return OracleDecoder(OracleLM(tiny_params, tiny_config), lexicon, vocab, tiny_config)


@pytest.fixture(scope="module")
def engine(tiny_params, tiny_config, lexicon, vocab):
    return BeamDecoder(tiny_params, lexicon, vocab, tiny_config, device="cpu")


@pytest.fixture(scope="module")
def fp32_results(engine, tiny_params, tiny_config, lexicon, vocab):
    """(port, JAX) n-best lists for KANAS from one batched call each."""
    jax_eng = jax_engine.BeamDecoder(tiny_params, lexicon, vocab, tiny_config)
    return (dict(zip(KANAS, engine.decode_batch(KANAS, n_best=3))),
            dict(zip(KANAS, jax_eng.decode_batch(KANAS, n_best=3))))


def _segs(results):
    return [r.segments for r in results]


def test_topk_stable_exact_vs_lax():
    """topk_stable == lax.top_k bit for bit, including tie order (ascending
    index within a tie group) and NEG-masked slots."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 6, (64, 640)).astype(np.float32)
    x[rng.random((64, 640)) < 0.3] = -1e30
    for k in (1, 4, 10):
        v_t, i_t = topk_stable(torch.from_numpy(x), k)
        v_j, i_j = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))


def test_pack_and_unpack_bit_equal_to_jax(tiny_config, lexicon, vocab):
    """The port's own copy of the lattice packing and its device unpack
    (dummy-slot scatter) equal the JAX originals bit for bit."""
    for name in ("_WORD_BITS", "_START_SHIFT", "_CIDX_SHIFT", "_MASK_SHIFT", "_RING"):
        assert getattr(torch_engine, name) == getattr(jax_engine, name), name
    lats = [build_lattice(k, lexicon, vocab, tiny_config)
            for k in ["きょうはいいてんき", "ゑび", "あめがふる", "かみとかわとき"]]
    packed_t, len_t = torch_engine.pack_lattice_batch(lats)
    packed_j, len_j = jax_engine.pack_lattice_batch(lats)
    np.testing.assert_array_equal(packed_t, packed_j)
    np.testing.assert_array_equal(len_t, len_j)
    packed = packed_t[:, :12]
    got = torch_engine._unpack_lattice(torch.from_numpy(packed), tiny_config)
    want = jax_engine._unpack_lattice(jnp.asarray(packed), tiny_config)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("kana", KANAS)
def test_top1_parity_fp32(fp32_results, oracle, kana):
    """fp32 parity mode: top-1 path identity and n-best scores vs the JAX
    engine and the oracle (atol 1e-3)."""
    port, jx = fp32_results[0][kana], fp32_results[1][kana]
    orc = oracle.decode(kana, n_best=3)
    assert _segs(port) == _segs(jx)
    assert port[0].segments == orc[0].segments
    np.testing.assert_allclose([r.score for r in port], [r.score for r in jx], atol=1e-3)
    np.testing.assert_allclose([r.score for r in port],
                               [r.score for r in orc[: len(port)]], atol=1e-3)


def test_greedy_config_parity(tiny_params, tiny_config, lexicon, vocab):
    """beam_width=1 greedy Viterbi matches the oracle."""
    cfg = tiny_config.replace(beam_width=1)
    eng = BeamDecoder(tiny_params, lexicon, vocab, cfg, device="cpu")
    orc = OracleDecoder(OracleLM(tiny_params, cfg), lexicon, vocab, cfg)
    for kana, res in zip(KANAS, eng.decode_batch(KANAS)):
        assert res[0].segments == orc.decode(kana)[0].segments, kana


def test_bf16_speed_mode(tiny_params, tiny_config, lexicon, vocab, oracle):
    """precision="default" (kernel forward in bf16, bf16 ring caches): top-1
    matches the fp32 oracle and the JAX Pallas bf16 engine; scores within
    0.1 of both."""
    kanas = ["きょうはいい", "あめがふる"]
    port = BeamDecoder(tiny_params, lexicon, vocab, tiny_config, precision="default",
                       device="cpu").decode_batch(kanas)
    fwd = jax_engine.make_pallas_forward(tiny_config, compute_dtype=jnp.bfloat16, tile_v=128)
    jx = jax_engine.BeamDecoder(tiny_params, lexicon, vocab, tiny_config,
                                forward_fn=fwd).decode_batch(kanas)
    for kana, r_t, r_j in zip(kanas, port, jx):
        r_o = oracle.decode(kana)[0]
        assert r_t[0].segments == r_o.segments == r_j[0].segments, kana
        assert abs(r_t[0].score - r_o.score) < 0.1
        assert abs(r_t[0].score - r_j[0].score) < 0.1


def test_int8_mxu_speed_mode(tiny_params, tiny_config, lexicon, vocab):
    """int8 weights, native int8 x int8 head: top-1 matches the int8 oracle
    and the JAX int8-MXU Pallas engine; scores within 0.2."""
    qp = quantize_params(tiny_params)
    kanas = ["かみとかわ", "はしをみる"]
    port = BeamDecoder(qp, lexicon, vocab, tiny_config, precision="default",
                       device="cpu").decode_batch(kanas)
    fwd = jax_engine.make_pallas_forward(tiny_config, compute_dtype=jnp.bfloat16,
                                         tile_v=128, int8_mxu=True)
    jx = jax_engine.BeamDecoder(qp, lexicon, vocab, tiny_config,
                                forward_fn=fwd).decode_batch(kanas)
    orc = OracleDecoder(OracleLM(qp, tiny_config), lexicon, vocab, tiny_config)
    for kana, r_t, r_j in zip(kanas, port, jx):
        r_o = orc.decode(kana)[0]
        assert r_t[0].segments == r_o.segments == r_j[0].segments, kana
        assert abs(r_t[0].score - r_o.score) < 0.2
        assert abs(r_t[0].score - r_j[0].score) < 0.2


def test_two_layer_parity(lexicon, vocab):
    """A 2-layer model decodes with oracle parity in both precisions (the
    kernel forward runs one cell step per layer)."""
    cfg = Config(vocab_size=256, embed_size=32, hidden_size=64, num_layers=2,
                 beam_width=4, max_kana_len=30, seed=42)
    params = init_params(cfg)
    orc = OracleDecoder(OracleLM(params, cfg), lexicon, vocab, cfg)
    kanas = ["きょうはいいてんき", "はしをみる"]
    for precision, tol in (("highest", 1e-3), ("default", 0.1)):
        eng = BeamDecoder(params, lexicon, vocab, cfg, precision=precision, device="cpu")
        for kana, res in zip(kanas, eng.decode_batch(kanas)):
            r_o = orc.decode(kana)[0]
            assert res[0].segments == r_o.segments, (precision, kana)
            assert abs(res[0].score - r_o.score) < tol


def test_prepare_payload_is_time_major_and_contiguous(tiny_params, tiny_config, lexicon,
                                                     vocab):
    """The kernel forward's payload is [T1, S, C+1, ...] with EOS last, and a
    frame's slice is contiguous, as the cand_dot kernel requires."""
    eng = BeamDecoder(tiny_params, lexicon, vocab, tiny_config, precision="default",
                      device="cpu")
    look_w = torch.randint(0, tiny_config.vocab_size, (3, 6, tiny_config.max_lookahead),
                           dtype=torch.int32)
    payload = eng._fwd.prepare(eng.params, look_w)
    C1, H = tiny_config.max_lookahead + 1, tiny_config.hidden_size
    assert payload["cols"].shape == (6, 3, C1, H)
    assert payload["bias"].shape == (6, 3, C1)
    for t in range(6):
        assert payload["cols"][t].is_contiguous() and payload["bias"][t].is_contiguous()
    head_T = eng.params["_decode"]["head_T"]
    assert torch.equal(payload["cols"][2, 1, :-1], head_T[look_w[1, 2].long()])
    assert torch.equal(payload["cols"][2, 1, -1], head_T[0])  # EOS_ID


def test_batch_decode_matches_single(engine):
    kanas = ["きょうはいい", "あめがふる", "はしをみる"]
    for kana, res in zip(kanas, engine.decode_batch(kanas, n_best=2)):
        single = engine.decode(kana, n_best=2)
        assert _segs(res) == _segs(single)
        np.testing.assert_allclose([r.score for r in res], [r.score for r in single],
                                   atol=1e-4)


def test_stream_sorted_chunks_restore_order(engine):
    """decode_stream with length sorting returns results in the original
    order, identical to unsorted chunking and to single decodes."""
    kanas = ["きょうはいいてんき", "ゑ", "あめがふる", "はしをみる",
             "かみとかわ", "とてもさむいです", "きょうはいい"]
    sorted_res = engine.decode_stream(kanas, chunk_size=3)
    plain_res = engine.decode_stream(kanas, chunk_size=3, sort_by_length=False)
    assert len(sorted_res) == len(plain_res) == len(kanas)
    for kana, rs, rp in zip(kanas, sorted_res, plain_res):
        assert _segs(rs) == _segs(rp), kana
        assert rs[0].segments == engine.decode(kana)[0].segments, kana


def test_t_bucket_rule(engine, tiny_params, tiny_config, lexicon, vocab):
    """Frame buckets honor config.t_bucket_multiple (min 4); batches pad to
    powers of two."""
    assert [engine._t_bucket(n) for n in (1, 4, 5, 9)] == [4, 4, 5, 9]
    eng4 = BeamDecoder(tiny_params, lexicon, vocab,
                       tiny_config.replace(t_bucket_multiple=4), device="cpu")
    assert [eng4._t_bucket(n) for n in (5, 9, 14)] == [8, 12, 16]
    assert [BeamDecoder._bucket(n) for n in (1, 3, 4, 5)] == [1, 4, 4, 8]


def test_native_and_python_builders_agree(tiny_params, tiny_config, lexicon, vocab):
    from jlm_tpu import native

    if not native.available():
        pytest.skip("no C++ toolchain")
    kanas = ["きょうはいい", "ゑとかみ"]
    rn = BeamDecoder(tiny_params, lexicon, vocab, tiny_config, use_native=True,
                     device="cpu").decode_batch(kanas, 2)
    rp = BeamDecoder(tiny_params, lexicon, vocab, tiny_config, use_native=False,
                     device="cpu").decode_batch(kanas, 2)
    assert [_segs(r) for r in rn] == [_segs(r) for r in rp]


def test_unported_paths_raise(engine, tiny_params, tiny_config, lexicon, vocab):
    """Two paths this test once saw refused are served now: an over-length
    input goes through ``decode_long`` (its n-best equals the JAX
    package's ``decode_long``, scores within 1e-3), and the D-softmax head
    through the kernel forward (top-1 equals the oracle's with the score
    within the bf16 speed mode's 0.1)."""
    from jlm_tpu.data import generate_test_set

    kana = "".join(k for k, _ in generate_test_set(12, seed=5))[:tiny_config.max_kana_len + 9]
    assert len(kana) > tiny_config.max_kana_len
    r_t = engine.decode(kana, n_best=2)
    r_j = jax_engine.BeamDecoder(tiny_params, lexicon, vocab, tiny_config).decode_long(kana, 2)
    assert r_t and _segs(r_t) == _segs(r_j)
    np.testing.assert_allclose([r.score for r in r_t], [r.score for r in r_j], atol=1e-3)
    cfg = Config(vocab_size=256, embed_size=32, hidden_size=64, head="dsoftmax",
                 dsoftmax=DSoftmaxConfig(block_sizes=(64, 192), block_dims=(64, 32)),
                 max_kana_len=30, seed=42)
    params = init_params(cfg)
    eng = BeamDecoder(params, lexicon, vocab, cfg, precision="default", device="cpu")
    r_t = eng.decode("きょうはいい")[0]
    r_o = OracleDecoder(OracleLM(params, cfg), lexicon, vocab, cfg).decode("きょうはいい")[0]
    assert r_t.segments == r_o.segments
    assert abs(r_t.score - r_o.score) < 0.1
