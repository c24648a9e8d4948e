"""The port's vocab- and data-parallel training vs the JAX package's and
the port's one-device trainer.

Mirrors tests/test_sharded.py's training cases on the port (the seq
pipeline's two are not ported).  The port's ranks run in Gloo worlds on
the CPU through tests/_torch_dist_worker.py (imports only
``jlm_tpu_torch``): the (2, 4) cases in the world that
tests/_torch_sharded_cases.py shares with the serving tests, the
data-only sampled case in a (2, 1) world.
Tolerances as test_sharded.py states them: ``vocab_parallel_nll``'s loss
and every gradient leaf 1e-5 against the JAX package's; the trainer's
params 2e-4 after an epoch against the JAX package's Trainer and the
port's one-device Trainer, PPL 1e-3 relative.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_dist_worker as worker
from _torch_sharded_cases import (CLIP, FAULTS, NLL_CASES, TRAIN, jcfg, nll_inputs, run_world,
                                  world_24)
from jlm_tpu.models.heads import full_softmax_loss


@pytest.fixture(scope="module")
def data_dir(encoded, vocab, tmp_path_factory):
    from jlm_tpu.data.io import save_dataset

    train, dev, test = encoded
    path = str(tmp_path_factory.mktemp("data"))
    save_dataset(path, vocab, train[:800], dev[:200], test[:200])
    return path


@pytest.fixture(scope="module")
def world(tiny_params, encoded, tmp_path_factory):
    return world_24(tmp_path_factory, tiny_params, encoded)


@pytest.fixture(scope="module")
def world21(encoded):
    train, dev, _ = encoded
    cases = [("sampled", "train", dict(cfg=dict(TRAIN, sampled_softmax_samples=32),
                                       train_ids=train[:600], dev_ids=dev[:400]))]
    return run_world((2, 1), cases)


@functools.lru_cache(maxsize=None)
def _jax_nll(kw_key, seed):
    """The JAX package's loss on the unsharded head (``full_softmax_loss``,
    precision "highest": what test_sharded.py holds its
    ``vocab_parallel_nll`` to), its head leaves' gradients (each block's
    W, b) and the hs gradient."""
    kw = dict(kw_key)
    cfg = jcfg(kw)
    params, hs, tgt = nll_inputs(kw, seed)
    params = jax.tree.map(jnp.asarray, params)
    hs, tgt = jnp.asarray(hs), jnp.asarray(tgt)

    def loss_fn(p, h):
        return full_softmax_loss(p, cfg, h, tgt, precision="highest")

    loss, (gp, gh) = jax.value_and_grad(loss_fn, argnums=(0, 1))(params, hs)
    g = gp["head"]
    blocks = g["blocks"] if "blocks" in g else [g]
    return (float(loss), [np.asarray(x) for b in blocks for x in (b["W"], b["b"])],
            np.asarray(gh))


def _port_nll(world, case, same_dh=True):
    """The port's loss (mean over data rows), gradients summed over the
    data group and divided (the train step's sync), the head leaves'
    columns gathered in rank order, and hs's gradient rows (a rank's
    local-mean gradient over the data rows it holds, divided likewise)."""
    res = [r[case] for r in world]
    loss = np.mean([res[d * 4]["loss"] for d in range(2)])
    leaves = []
    for i in range(len(res[0]["head"])):
        cols = [sum(res[d * 4 + v]["head"][i] for d in range(2)) / 2 for v in range(4)]
        leaves.append(np.concatenate(cols, axis=-1))
    dh = np.concatenate([res[d * 4]["dh"] for d in range(2)]) / 2
    for rank, r in enumerate(res if same_dh else []):  # a data row's ranks: one dh
        np.testing.assert_array_equal(r["dh"], res[rank // 4 * 4]["dh"])
    return loss, leaves, dh


@pytest.mark.parametrize("case", ["plain", "kernels_full", "kernels_dsoftmax"])
def test_vocab_parallel_nll_matches_jax(world, case):
    """Loss and every gradient leaf (head W, b per block; hs) within 1e-5
    of the JAX package's (its loss on the whole head, to which
    test_sharded.py holds its vocab_parallel_nll), plain and through the
    CE kernels' plain versions, full and D-softmax heads."""
    kw, seed, kernels, _ = NLL_CASES[case]
    l_j, g_j, gh_j = _jax_nll(tuple(kw.items()), seed)
    l_p, g_p, gh_p = _port_nll(world[0], case)
    np.testing.assert_allclose(l_p, l_j, atol=1e-5)
    for a, b in zip(g_p, g_j):
        np.testing.assert_allclose(a, b, atol=1e-5)
    np.testing.assert_allclose(gh_p, gh_j, atol=1e-5)


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("path", ["kernels", "plain"])
def test_vocab_parallel_nll_dh_fault_fails(world, fault, path):
    """A dh summed over the vocab group twice, or not at all, misses the
    reference's hs gradient by far more than the bound."""
    kw, seed, kernels, _ = NLL_CASES["kernels_full" if path == "kernels" else "plain"]
    _, _, gh_j = _jax_nll(tuple(kw.items()), seed)
    _, _, gh_p = _port_nll(world[0], f"{path}_{fault}", same_dh=False)
    assert np.abs(gh_p - gh_j).max() > 1e-3


def _single(cfg_kw, train_ids, dev_ids):
    from jlm_tpu_torch.train import Trainer

    tr = Trainer(worker.config(**cfg_kw), device="cpu")
    tr.run_epoch(train_ids, 0)
    return tr


def _jax_epoch(cfg_kw, train_ids, dev_ids):
    """One epoch of the JAX package's Trainer from the same params
    (``init_params`` of the same seed) and windows: its train PPL, its
    params flattened as the port's checkpoint names them, its dev PPL."""
    from jlm_tpu.train import Trainer as JaxTrainer
    from jlm_tpu_torch.train import checkpoint

    jt = JaxTrainer(jcfg(cfg_kw))
    train_ppl = jt.run_epoch(train_ids, 0, jax.random.key(0))
    return (train_ppl, checkpoint.flatten(jax.tree.map(np.asarray, jt.params)),
            jt.evaluate_ppl(dev_ids))


def test_sharded_trainer_matches_single(world, encoded, tmp_path):
    """Trainer(mesh=(2, 4)) == the JAX package's Trainer and the port's
    Trainer() after an epoch from the same params and windows (every leaf
    within 2e-4, train and dev PPL 1e-3 relative); the checkpoint saved on
    the mesh holds the full tree, reloads on the mesh to the same params
    and on one device to the same tree and PPL."""
    from jlm_tpu_torch.train import Trainer

    world, exp = world
    train, dev, _ = encoded
    ppl_j, want_j, dev_j = _jax_epoch(TRAIN, train[:1600], dev[:400])
    tr_1 = _single(TRAIN, train[:1600], dev[:400])
    got = world[0]["trainer"]
    assert sorted(got["params"]) == sorted(want_j)
    for k, p in tr_1.flat.items():
        np.testing.assert_allclose(got["params"][k], want_j[k], atol=2e-4, err_msg=k)
        np.testing.assert_allclose(p.detach().numpy(), want_j[k], atol=2e-4, err_msg=k)
        np.testing.assert_allclose(got["params"][k], p.detach().numpy(), atol=2e-4)
    assert abs(got["train_ppl"] - ppl_j) / ppl_j < 1e-3
    assert abs(got["dev_ppl"] - dev_j) / dev_j < 1e-3
    p_1 = tr_1.evaluate_ppl(dev[:400])
    for r in world:
        assert abs(r["trainer"]["dev_ppl"] - p_1) / p_1 < 1e-3
        assert r["trainer"]["resumed_epoch"] == 1 and r["trainer"]["resumed_equal"]
        assert abs(r["trainer"]["resumed_ppl"] - r["trainer"]["dev_ppl"]) < 1e-6
    tr_r = Trainer(worker.config(**TRAIN), device="cpu")
    assert tr_r.load_state(exp) == 1
    for k, p in tr_r.flat.items():
        np.testing.assert_array_equal(p.detach().numpy(), got["params"][k])
    assert abs(tr_r.evaluate_ppl(dev[:400]) - got["dev_ppl"]) / got["dev_ppl"] < 1e-5


def test_sharded_trainer_bf16_and_accum_smoke(world, encoded):
    """The sharded step with bf16 compute and gradient accumulation still
    learns."""
    world, _ = world
    for r in world:
        assert r["bf16_accum"]["dev_ppl"] < r["bf16_accum"]["ppl0"]


def test_sharded_clip_sees_the_whole_tree(world, encoded):
    """With a clip that fires every step, the mesh's params equal the JAX
    package's Trainer's and the port's one device's (the clip on the
    tree's norm); a clip on each rank's own shards' norm does not."""
    world, _ = world
    train, dev, _ = encoded
    _, want_j, _ = _jax_epoch(CLIP, train[:480], dev[:400])
    tr_1 = _single(CLIP, train[:480], dev[:400])
    refs = {"jax": want_j, "port": {k: p.detach().numpy() for k, p in tr_1.flat.items()}}
    for ref, want in refs.items():
        for case, bound in (("clip", 2e-4), ("clip_local_norm", None)):
            got = world[0][case]["params"]
            err = max(np.abs(got[k] - want[k]).max() for k in want)
            assert err <= bound if bound else err > 1e-3, (ref, case, err)


def test_sampled_softmax_data_parallel(world, world21):
    """Sampled softmax trains on a data-only mesh (one draw shared by the
    ranks): finite PPL above 1; under vocab sharding it raises at
    construction."""
    world, _ = world
    for r in world21:
        ppl = r["sampled"]["train_ppl"]
        assert np.isfinite(ppl) and ppl > 1.0
    assert "vocab" in world[0]["trainer"]["sampled_vocab"]


def test_cli_trains_on_a_mesh(data_dir, vocab, tmp_path):
    """``python -m jlm_tpu_torch.train --mesh-vocab 2 --device cpu``
    spawns its world and writes the reference's layout; the checkpoint is
    the full tree, which one device loads."""
    from jlm_tpu_torch.train import Trainer, checkpoint
    from jlm_tpu_torch.train.__main__ import main

    exp = str(tmp_path / "exp")
    main(["--data", data_dir, "--exp", exp, "--embed-size", "16", "--hidden-size", "32",
          "--batch-size", "4", "--num-steps", "8", "--epochs", "1", "--mesh-vocab", "2",
          "--dsoftmax", "--fused-ce", "--device", "cpu"])
    assert sorted(os.listdir(exp)) == ["ckpt-latest.npz", "config.json", "log.jsonl",
                                       checkpoint.OPT_STATE_FILE]
    params, cfg = checkpoint.load_checkpoint(exp)
    assert cfg.mesh_vocab == 2 and cfg.vocab_size % 2 == 0
    assert [b["W"].shape[1] for b in params["head"]["blocks"]] == list(cfg.dsoftmax.block_sizes)
    assert Trainer(cfg, device="cpu").load_state(exp) == 1
