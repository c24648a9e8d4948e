"""The port's vocab-sharded serving vs the JAX package's, case for case.

Mirrors tests/test_sharded.py on the port: its decode-side cases, except
the seq-pipeline ones (not ported) and ``seq_shard=False`` (ruled out:
``make_sharded_forward`` raises).  The port's ranks run in Gloo worlds on
the CPU (``parallel.comm.spawn``) whose function lives in
tests/_torch_dist_worker.py, which imports only ``jlm_tpu_torch``: the
(2, 4) cases in the world that tests/_torch_sharded_cases.py shares with
the training tests, config 3's in a (1, 4) world; each test reads its
case.  The JAX side runs here on its 8-device CPU mesh.  The same numpy parameters go to both sides.  Tolerances as
test_sharded.py states them: plain forwards 1e-5 (states 1e-6), the
kernel forwards' plain versions 1e-4 (states 1e-5), decode scores 1e-3
against the oracle with top-1 path identity, top-k indices equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_dist_worker as worker
from _torch_sharded_cases import (BASE, CONTEXTS, DS, LONG_KANA, fwd_inputs, jcfg, run_world,
                                  world_24)
from jlm_tpu.decoder.engine import build_decode_head, full_softmax_forward, make_pallas_forward
from jlm_tpu.models import init_params
from jlm_tpu.models.lstm import initial_state
from jlm_tpu.oracle import OracleDecoder, OracleLM
from jlm_tpu.ops.quant import quantize_params
from jlm_tpu.parallel import make_mesh, param_shardings


def _cases_14(tiny):
    """Config 3's layout on a (1, 4) world: a D-softmax int8 head, vocab
    sharded four ways."""
    ds_q = quantize_params(init_params(jcfg(DS)))
    return [("mesh", "mesh_info", dict(cfg=BASE)),
            ("c3_mxu", "decode", dict(cfg=DS, params=ds_q, kernels=True, int8_mxu=True,
                                      n_best=3, single=True)),
            ("c3_dequant", "decode", dict(cfg=DS, params=ds_q, kernels=True, int8_mxu=False,
                                          n_best=3, single=True)),
            ("c3_plain", "decode", dict(cfg=DS, params=ds_q))]


@pytest.fixture(scope="module")
def world(tiny_params, encoded, tmp_path_factory):
    return world_24(tmp_path_factory, tiny_params, encoded)[0]


@pytest.fixture(scope="module")
def world14(tiny_params):
    return run_world((1, 4), _cases_14(tiny_params))


def rows(world, case, key):
    """A per-rank result's rows concatenated in rank order (the row
    sharding over data x vocab)."""
    return np.concatenate([r[case][key] for r in world])


def _vocab_slice(full, spec, v, n):
    """Rank ``v`` of ``n``'s part of ``full`` under the JAX package's
    PartitionSpec ``spec``: its block along the axis split over vocab
    (``q`` and ``scale`` of an int8 leaf along the output axis)."""
    if isinstance(full, dict):
        return {"q": _vocab_slice(full["q"], spec, v, n),
                "scale": _vocab_slice(full["scale"], P(*spec[1:]), v, n)}
    full = np.asarray(full)
    for axis, name in enumerate(spec):
        if name == "vocab":
            full = np.split(full, n, axis=axis)[v]
    return full


def test_mesh_axes(world, world14, tiny_params):
    """The (data, vocab) layout of ranks is JAX's ``make_mesh``'s, and the
    leaves each rank keeps (``shard_params``) are its part of the JAX
    package's ``param_shardings``: head columns split over vocab (int8
    ``q`` and ``scale`` alike, every D-softmax block), the rest whole."""
    cfg = jcfg(BASE, mesh_data=2, mesh_vocab=4)
    jmesh = make_mesh(cfg)
    assert jmesh.shape == {"data": 2, "vocab": 4}
    for rank, r in enumerate(world):
        assert r["mesh"]["shape"] == {"data": 2, "vocab": 4}
        assert r["mesh"]["coords"] == (rank // 4, rank % 4)
    assert world14[3]["mesh"]["shape"] == {"data": 1, "vocab": 4}
    for case, kw, params in (("mesh", BASE, tiny_params),
                             ("mesh_ds", DS, init_params(jcfg(DS))),
                             ("mesh_q", BASE, quantize_params(tiny_params))):
        specs = param_shardings(jcfg(kw, mesh_data=2, mesh_vocab=4), jmesh)
        for r in world:
            v = r["mesh"]["coords"][1]
            want = jax.tree.map(lambda spec, full: _vocab_slice(full, spec, v, 4), specs, params,
                                is_leaf=lambda x: isinstance(x, P))
            got = r[case]["params"]
            assert jax.tree.structure(got) == jax.tree.structure(want), case
            for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
                np.testing.assert_array_equal(g, np.asarray(w, np.float32), err_msg=case)


@pytest.mark.parametrize("seq_shard", [True])
def test_sharded_forward_matches_unsharded(world, tiny_params, seq_shard):
    """Sentence rows sharded over data x vocab, h_top gathered at the
    head, candidates back to their owners by one reduce_scatter."""
    words, cand, _, _ = fwd_inputs(5, 8, 2, 4)
    cand[0, :4] = [0, 5, 17, 255]
    cfg = jcfg(BASE)
    c_r, e_r, st_r = full_softmax_forward(jax.tree.map(jnp.asarray, tiny_params), cfg,
                                          jnp.asarray(words), initial_state(cfg, 16),
                                          jnp.asarray(cand))
    np.testing.assert_allclose(rows(world, "forward", "cand"), c_r, atol=1e-5)
    np.testing.assert_allclose(rows(world, "forward", "eos"), e_r, atol=1e-5)
    c = np.concatenate([r["forward"]["c"] for r in world], axis=1)
    np.testing.assert_allclose(c, st_r[0], atol=1e-6)


def test_sharded_forward_refuses_seq_shard_false():
    from jlm_tpu_torch.config import Config as PConfig
    from jlm_tpu_torch.parallel import make_sharded_forward
    from jlm_tpu_torch.parallel.mesh import Mesh

    with pytest.raises(ValueError, match="seq_shard=False"):
        make_sharded_forward(Mesh(1, 1, 0, torch.device("cpu")), PConfig(), seq_shard=False)


def test_mesh_and_world_default_to_the_card():
    """``make_mesh`` and ``spawn`` put ranks on the card unless asked for
    the CPU: without a GPU they raise, as every entry point of the port
    does."""
    from jlm_tpu_torch.parallel import make_mesh as port_mesh
    from jlm_tpu_torch.parallel.comm import spawn

    cfg = worker.config(**BASE)
    if torch.cuda.is_available():
        assert port_mesh(cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_mesh(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        spawn(worker.run, 2, args=((1, 2), []))
    assert port_mesh(cfg, "cpu").device == torch.device("cpu")


@pytest.mark.parametrize("entry", ["decoder", "suggester", "trainer"])
def test_device_conflicting_with_the_mesh_raises(tiny_params, entry):
    """An object built on a CPU mesh with its default device (the card)
    raises rather than run on the mesh's CPU unasked."""
    from jlm_tpu_torch.decoder.engine import BeamDecoder
    from jlm_tpu_torch.decoder.suggest import Suggester
    from jlm_tpu_torch.parallel import make_mesh as port_mesh
    from jlm_tpu_torch.parallel import make_sharded_forward
    from jlm_tpu_torch.train import Trainer

    cfg = worker.config(**BASE)
    mesh = port_mesh(cfg, "cpu")
    vocab, lexicon = worker._data()
    build = {"decoder": lambda **kw: BeamDecoder(tiny_params, lexicon, vocab, cfg, forward_fn=
                                                 make_sharded_forward(mesh, cfg), **kw),
             "suggester": lambda **kw: Suggester(tiny_params, vocab, cfg, mesh=mesh, **kw),
             "trainer": lambda **kw: Trainer(cfg, tiny_params, mesh=mesh, **kw)}[entry]
    with pytest.raises(ValueError, match="conflicts with the mesh's device 'cpu'"):
        build()
    assert build(device="cpu").device == torch.device("cpu")


def test_sharded_dsoftmax_forward_matches_unsharded(world):
    cfg = jcfg(DS)
    params = jax.tree.map(jnp.asarray, init_params(cfg))
    words = jnp.asarray([[1], [8], [3], [250], [7], [0], [12], [99]], jnp.int32)
    cand = jnp.asarray([[0, 63, 64, 127, 128, 255], [255, 128, 127, 64, 63, 0]] * 4, jnp.int32)
    c_r, e_r, _ = full_softmax_forward(params, cfg, words, initial_state(cfg, 8), cand)
    np.testing.assert_allclose(rows(world, "forward_ds", "cand"), c_r, atol=1e-5)
    np.testing.assert_allclose(rows(world, "forward_ds", "eos"), e_r, atol=1e-5)


@pytest.mark.parametrize("seq_shard", [True])
@pytest.mark.parametrize("quant", [False, True])
def test_sharded_pallas_forward_matches_unsharded(world, tiny_params, seq_shard, quant):
    """The kernel forward (the kernels' plain versions here): the cell and
    cand_dot on the rank's own rows, project_ms on its local columns, the
    (m, s) merged across the vocab group; vs JAX's unsharded Pallas
    forward (interpret mode), fp32, int8 dequant included; score_hidden
    through the same merge."""
    cfg = jcfg(BASE)
    base = quantize_params(tiny_params) if quant else tiny_params
    params = dict(jax.tree.map(jnp.asarray, base))
    params["_decode"] = build_decode_head(params, cfg)
    fwd_1 = make_pallas_forward(cfg, interpret=True, int8_mxu=False)
    words, _, look, h3 = fwd_inputs(5, 8, 2, 4)
    pay_1 = jax.tree.map(lambda a: a[:, 0], fwd_1.prepare(params, jnp.asarray(look)))
    c_r, e_r, st_r = jax.jit(fwd_1)(params, jnp.asarray(words), initial_state(cfg, 16), pay_1)
    case = f"kernel_forward_{quant}"
    np.testing.assert_allclose(rows(world, case, "cand"), c_r, atol=1e-4)
    np.testing.assert_allclose(rows(world, case, "eos"), e_r, atol=1e-4)
    for i, key in enumerate(("c", "h")):
        got = np.concatenate([r[case][key] for r in world], axis=1)
        np.testing.assert_allclose(got, st_r[i], atol=1e-5)
    sc_r = jax.jit(fwd_1.score_hidden)(params, jnp.asarray(h3), pay_1)
    np.testing.assert_allclose(rows(world, case, "score"), sc_r, atol=1e-4)


@pytest.mark.parametrize("int8_mxu", [False, True])
def test_sharded_pallas_dsoftmax_int8(world, int8_mxu):
    """D-softmax int8 head under vocab sharding: each block's local
    columns (native int8 x int8 included), merged lse vs the unsharded
    JAX Pallas D-softmax forward."""
    cfg = jcfg(DS)
    params = dict(jax.tree.map(jnp.asarray, quantize_params(init_params(cfg))))
    params["_decode"] = build_decode_head(params, cfg)
    fwd_1 = make_pallas_forward(cfg, interpret=True, int8_mxu=int8_mxu)
    rng = np.random.default_rng(7)
    words = jnp.asarray(rng.integers(0, 256, (8, 2)), jnp.int32)
    look = jnp.asarray([[[0, 63, 64, 127, 128, 255]]] * 8, jnp.int32)
    pay_1 = jax.tree.map(lambda a: a[:, 0], fwd_1.prepare(params, look))
    c_r, e_r, _ = jax.jit(fwd_1)(params, words, initial_state(cfg, 16), pay_1)
    case = f"kernel_ds_int8_{int8_mxu}"
    np.testing.assert_allclose(rows(world, case, "cand"), c_r, atol=1e-4)
    np.testing.assert_allclose(rows(world, case, "eos"), e_r, atol=1e-4)


def _oracle_check(results, params, cfg, lexicon, vocab, kanas=worker.KANAS):
    orc = OracleDecoder(OracleLM(params, cfg), lexicon, vocab, cfg)
    for kana, r in zip(kanas, results):
        r_o = orc.decode(kana)[0]
        assert [tuple(s) for s in r[0][0]] == [tuple(s) for s in r_o.segments], kana
        assert abs(r[0][1] - r_o.score) < 1e-3


def _every_rank_same(world, case, key):
    for r in world[1:]:
        assert r[case][key] == world[0][case][key]
    return world[0][case][key]


def test_sharded_pallas_decode_top1_parity(world, tiny_params, lexicon, vocab):
    """BeamDecoder over the sharded kernel forward == numpy oracle; every
    rank returns the whole batch."""
    res = _every_rank_same(world, "decode_kernels", "sharded")
    _oracle_check(res, tiny_params, jcfg(BASE), lexicon, vocab)


def test_sharded_decode_from_presharded_params(world):
    """Params already sharded (each rank's head columns) decode the same:
    the kernel forward gathers the full head once for its candidate
    table."""
    assert (_every_rank_same(world, "decode_kernels_presharded", "sharded")
            == _every_rank_same(world, "decode_kernels", "sharded"))


def test_vocab_layout_refuses_uneven_shards():
    from jlm_tpu_torch.parallel.sharded_head import shard_layout, vocab_layout

    with pytest.raises(ValueError, match="mesh_vocab=4"):
        shard_layout(worker.config(**dict(BASE, vocab_size=250)), 4)
    with pytest.raises(ValueError, match="dsoftmax block sizes"):
        shard_layout(worker.config(**dict(DS, dsoftmax=((62, 66, 128), (64, 32, 16),
                                                         "prefix"))), 4)
    owner_pos, v_local = vocab_layout(worker.config(**DS), 4)
    owner, pos = owner_pos(torch.tensor([0, 15, 16, 63, 64, 80, 128, 255]))
    assert v_local == 64
    assert owner.tolist() == [0, 0, 1, 3, 0, 1, 0, 3]
    assert pos.tolist() == [0, 15, 0, 15, 16, 16, 32, 63]


def test_sharded_pallas_decode_long(world, tiny_params, lexicon, vocab):
    """Multi-root decode_long under the sharded kernel forward: seeds
    scored through score_hidden's merge; path and score vs the uncapped
    oracle."""
    res = _every_rank_same(world, "decode_long_kernels", "sharded")
    _oracle_check(res, tiny_params, jcfg(BASE, max_kana_len=64), lexicon, vocab, [LONG_KANA])


def test_sharded_topk_exact_with_ties(world):
    ties = np.random.default_rng(0).integers(0, 8, (3, 256)).astype(np.float32)
    vals_r, idx_r = jax.lax.top_k(jnp.asarray(ties), 10)
    for case in ("topk", "topk_ds"):  # contiguous shards; every block's slice
        for r in world:
            np.testing.assert_array_equal(r[case]["vals"], np.asarray(vals_r))
            np.testing.assert_array_equal(r[case]["idx"], np.asarray(idx_r))


def test_sharded_decode_top1_parity(world, tiny_params, lexicon, vocab):
    """BASELINE config 3's skeleton: the plain sharded forward's beam
    decode == oracle."""
    res = _every_rank_same(world, "decode", "sharded")
    _oracle_check(res, tiny_params, jcfg(BASE), lexicon, vocab)


def test_sharded_decode_long_exact_scores(world, tiny_params, lexicon, vocab):
    """decode_long with the plain sharded forward (multi-root through its
    score_hidden): path and score vs the single-device port decode and the
    uncapped oracle."""
    from jlm_tpu_torch.decoder.engine import BeamDecoder

    res = _every_rank_same(world, "decode_long", "sharded")
    cfg = jcfg(BASE, max_kana_len=8)
    one = BeamDecoder(tiny_params, _port_data()[1], _port_data()[0], worker.config(
        **dict(BASE, max_kana_len=8)), precision="highest", device="cpu").decode(LONG_KANA)[0]
    assert [tuple(s) for s in res[0][0][0]] == [tuple(s) for s in one.segments]
    _oracle_check(res, tiny_params, cfg.replace(max_kana_len=64), lexicon, vocab, [LONG_KANA])


def _port_data():
    return worker._data()


@pytest.mark.parametrize("head", ["full", "dsoftmax"])
def test_sharded_suggester_matches_single(world, head):
    """Suggester(mesh=): each rank's columns normalized by the global lse,
    sharded_topk; the same ids as the one-device suggester and log-probs
    within 1e-5."""
    from jlm_tpu_torch.decoder.suggest import Suggester

    kw = BASE if head == "full" else DS
    vocab, _ = _port_data()
    one = Suggester(init_params(jcfg(kw)) if head != "full" else
                    init_params(jcfg(BASE)), vocab, worker.config(**kw), device="cpu")
    for r in world:
        got = r["suggest" if head == "full" else "suggest_ds"]
        for (ids, vals), ctx in zip(got, CONTEXTS):
            want_ids, want_vals = one.top_k(ctx, 5)
            assert ids == want_ids
            np.testing.assert_allclose(vals, want_vals, atol=1e-5)


@pytest.mark.parametrize("mode", ["c3_mxu", "c3_dequant"])
def test_config3_layout_kernel_decode(world14, mode):
    """Config 3's layout on (1, 4): the D-softmax int8 head's blocks split
    four ways through the kernel forward; n-best equal to the one-rank
    kernel forward's, scores within 1e-4 (only the lse merge's order
    differs)."""
    for r in world14:
        got, want = r[mode]["sharded"], r[mode]["single"]
        for g, w in zip(got, want):
            assert [s for s, _ in g] == [s for s, _ in w]
            np.testing.assert_allclose([x for _, x in g], [x for _, x in w], atol=1e-4)


def test_config3_layout_plain_decode_top1(world14, lexicon, vocab):
    """Config 3's layout, plain sharded forward: top-1 == the int8 oracle."""
    cfg = jcfg(DS)
    res = _every_rank_same(world14, "c3_plain", "sharded")
    _oracle_check(res, quantize_params(init_params(cfg)), cfg, lexicon, vocab)


def test_comms_model_consistency():
    """The port's copy of the analytic model: payloads track the sharded
    forward's exchange shapes; the projection is monotone in bandwidth."""
    from jlm_tpu_torch.config import Config as PConfig
    from jlm_tpu_torch.parallel.comms_model import (
        decode_collective_bytes_per_frame,
        decode_scaling_projection,
    )

    cfg = PConfig(vocab_size=50_000)
    S, n = 512, 4
    c = decode_collective_bytes_per_frame(cfg, S, n)
    assert c["payload_bytes_pmax"] == S * cfg.beam_pad * 4
    assert c["payload_bytes_psum_cand"] == S * cfg.beam_pad * (cfg.max_lookahead + 1) * 4
    assert c["wire_bytes_per_device_per_frame"] == 2 * (n - 1) / n * c["payload_bytes_total"]
    fast = decode_scaling_projection(cfg, S, 8.0, 0.55, n_vocab=4, gbps=100)
    slow = decode_scaling_projection(cfg, S, 8.0, 0.55, n_vocab=4, gbps=12.5)
    assert fast["speedup_vs_1chip"] > slow["speedup_vs_1chip"] > 1.0
    seq = decode_scaling_projection(cfg, S, 8.0, 0.55, n_vocab=4, gbps=100, seq_shard=True,
                                    htop_bytes=2)
    assert seq["eff_vs_ideal"] > fast["eff_vs_ideal"] and seq["eff_vs_ideal"] >= 0.7
    c_seq = decode_collective_bytes_per_frame(cfg, S, 4, seq_shard=True, htop_bytes=2)
    assert c_seq["payload_bytes_allgather_htop"] == S * cfg.beam_pad * cfg.hidden_size * 2
