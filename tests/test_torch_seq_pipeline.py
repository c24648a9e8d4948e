"""The port's time-block pipeline (``parallel/seq_pipeline.py``) and its
training step vs the JAX package's, and the process-group bootstrap's
device rule.

Mirrors tests/test_sharded.py's two seq cases on the port.  The port's
ranks run in one 4-rank Gloo world on the CPU (tests/_torch_dist_worker.py
``run_seq``, which imports only ``jlm_tpu_torch``); the JAX side runs
here on the 8-device CPU mesh of tests/conftest.py.  Tolerances: the
pipeline's ``hs`` and final carries 1e-5 against JAX's
``make_seq_pipeline_scan`` and ``seq_pipeline_ref``; its VJP 1e-5 of each
gradient's largest entry against the sequential scan's; the seq trainer's
params 2e-4 after an epoch against JAX's seq ``Trainer`` (and the port's
one-device trainer), dev PPL 1e-3 relative.  With ``fused_ce`` JAX's CE
runs in Pallas interpret mode, the port's through the CE kernels' plain
versions.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_dist_worker as worker
from jlm_tpu.config import Config
from jlm_tpu_torch.parallel.comm import spawn

P_SEQ = 4
PIPE = dict(M=8, B=2, T=16, E=16, H=16, L=2)
SEQ_TRAIN = dict(vocab_size=256, embed_size=16, hidden_size=32, batch_size=8, num_steps=16,
                 learning_rate=5e-3, seed=5)
VARIANTS = {"full": {}, "fused_ce": {"fused_ce": True}}


def pipe_inputs():
    """test_sharded.py's inputs (seed 11), and cotangents for the VJP."""
    M, B, T, E, H, L = (PIPE[k] for k in "MBTEHL")
    rng = np.random.default_rng(11)
    xs = rng.normal(size=(M, B, T, E)).astype(np.float32) * 0.2
    layers = [(rng.normal(size=((E if l == 0 else H) + H, 4 * H)).astype(np.float32) * 0.1,
               np.zeros((4 * H,), np.float32)) for l in range(L)]
    c0 = rng.normal(size=(M, L, B, H)).astype(np.float32) * 0.1
    h0 = rng.normal(size=(M, L, B, H)).astype(np.float32) * 0.1
    g_hs = rng.normal(size=(M, B, T, H)).astype(np.float32)
    g_c = rng.normal(size=(M, L, B, H)).astype(np.float32)
    g_h = rng.normal(size=(M, L, B, H)).astype(np.float32)
    return xs, layers, c0, h0, g_hs, g_c, g_h


@pytest.fixture(scope="module")
def seq_world(encoded, tmp_path_factory):
    xs, layers, c0, h0, g_hs, g_c, g_h = pipe_inputs()
    train, dev, _ = encoded
    exp = str(tmp_path_factory.mktemp("seq_exp"))
    cases = [("pipeline", "pipeline", dict(xs=xs, layers=layers, c0=c0, h0=h0, g_hs=g_hs,
                                           g_c=g_c, g_h=g_h))]
    cases += [(f"train {name}", "seq_train",
               dict(cfg=dict(SEQ_TRAIN, seq_microbatches=8, **kw), train_ids=train[:3200],
                    dev_ids=dev[:400], exp=exp if name == "full" else None))
              for name, kw in VARIANTS.items()]
    out = spawn(worker.run_seq, P_SEQ, device="cpu", args=(P_SEQ, cases))
    for r in out:
        assert r["_modules"] == [], r["_modules"]
    return out


def test_seq_pipeline_matches_sequential(seq_world):
    """The ranks' time blocks, laid side by side, are JAX's pipeline and its
    sequential reference; every rank holds the same final carries; the VJP
    is the sequential scan's."""
    from jlm_tpu.parallel.seq_pipeline import make_seq_pipeline_scan, seq_pipeline_ref

    xs, layers, c0, h0, g_hs, g_c, g_h = pipe_inputs()
    res = [r["pipeline"] for r in seq_world]
    hs = np.concatenate([r["hs"] for r in res], axis=2)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:P_SEQ]), ("seq",))
    j_layers = tuple((jnp.asarray(W), jnp.asarray(b)) for W, b in layers)
    args = (jnp.asarray(xs), j_layers, jnp.asarray(c0), jnp.asarray(h0))
    got_j = make_seq_pipeline_scan(mesh, num_layers=PIPE["L"])(*args)
    ref, vjp = jax.vjp(lambda x, ly, c, h: seq_pipeline_ref(x, ly, c, h), *args)
    for want in (got_j, ref):
        np.testing.assert_allclose(hs, np.asarray(want[0]), atol=1e-5)
        for r in res:
            np.testing.assert_allclose(r["c"], np.asarray(want[1]), atol=1e-5)
            np.testing.assert_allclose(r["h"], np.asarray(want[2]), atol=1e-5)
    g_x, g_ly, g_c0, g_h0 = vjp((jnp.asarray(g_hs), jnp.asarray(g_c), jnp.asarray(g_h)))
    want = [g_x, g_c0, g_h0] + [g for W_b in g_ly for g in W_b]
    for r in res:
        for got, w in zip(r["grads"], want):
            w = np.asarray(w)
            np.testing.assert_allclose(got, w, rtol=0, atol=1e-5 * np.abs(w).max())


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}{key}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, f"{prefix}{i}/").items()}
    if hasattr(tree, "detach"):  # a torch leaf
        tree = tree.detach().numpy()
    return {prefix.rstrip("/"): np.asarray(tree)}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_seq_pipeline_trainer_matches_single(seq_world, encoded, variant):
    """The port's Trainer on a 4-stage seq mesh (8 microbatches) after an
    epoch equals JAX's seq Trainer and the port's one-device Trainer; every
    rank holds the same params; a saved state loads back bit-equal."""
    from jlm_tpu.parallel.mesh import make_seq_mesh
    from jlm_tpu.train import Trainer as JTrainer
    from jlm_tpu_torch.config import Config as PConfig
    from jlm_tpu_torch.train import Trainer

    train, dev, _ = encoded
    kw = dict(SEQ_TRAIN, **VARIANTS[variant])
    res = [r[f"train {variant}"] for r in seq_world]
    cfg_s = Config(mesh_seq=P_SEQ, seq_microbatches=8, **kw)
    tr_j = JTrainer(cfg_s, mesh=make_seq_mesh(cfg_s))
    tr_j.run_epoch(train[:3200], 0, jax.random.key(0))
    tr_1 = Trainer(PConfig(**kw), device="cpu")
    tr_1.run_epoch(train[:3200], 0)
    want_j, want_1 = _flat(tr_j.params), _flat(tr_1.params)
    for r in res:
        got = _flat(r["params"])
        assert got.keys() == want_j.keys() == want_1.keys()
        for k in got:
            np.testing.assert_allclose(got[k], want_j[k], atol=2e-4, err_msg=k)
            np.testing.assert_allclose(got[k], want_1[k], atol=2e-4, err_msg=k)
            np.testing.assert_array_equal(got[k], _flat(res[0]["params"])[k])
        assert r["dev_ppl"] < r["ppl0"]
    p_j = tr_j.evaluate_ppl(dev[:400])
    assert abs(res[0]["dev_ppl"] - p_j) / p_j < 1e-3
    if variant == "full":
        assert all(r["resumed_epoch"] == 1 and r["resumed_equal"] for r in res)


def test_multihost_init_device_rule(monkeypatch):
    """``multihost_init`` defaults to the card (raising without one, before
    any rendezvous); an explicit ``"cpu"`` picks ``gloo``; ``backend_for``
    keeps its rule on CUDA: ``nccl`` with a GPU for every rank, else
    ``gloo``."""
    import torch

    from jlm_tpu_torch.parallel import mesh as pmesh

    assert inspect.signature(pmesh.multihost_init).parameters["device"].default == "cuda"
    assert pmesh.multihost_init("file:///nonexistent", 1, 0, device="cpu") == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pmesh.multihost_init("file:///nonexistent", 2, 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert [pmesh.backend_for("cuda", n) for n in (1, 4, 5, 8)] == ["nccl", "nccl", "gloo",
                                                                     "gloo"]
    assert pmesh.backend_for("cpu", 4) == "gloo"
