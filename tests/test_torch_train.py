"""The port's training path (jlm_tpu_torch.train, models.heads,
models.lstm.forward_hidden) vs the JAX package's, on the CPU.

Same parameters and batches (numpy-seeded) through both; the port's fused
CE runs its plain versions on CPU tensors.  Configurations are the
``small_cfg`` of tests/test_train.py.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jlm_tpu.config import Config, DSoftmaxConfig
from jlm_tpu.data.reader import bptt_batches
from jlm_tpu.models import heads as jax_heads
from jlm_tpu.models import lstm as jax_lstm
from jlm_tpu.models.params import init_params
from jlm_tpu_torch.config import Config as PortConfig
from jlm_tpu_torch.models import heads, lstm
from jlm_tpu_torch.models.params import params_to_torch
from jlm_tpu_torch.train import Trainer, checkpoint, train_lm
from jlm_tpu_torch.train.trainer import epoch_lr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def small_cfg(**kw):
    base = dict(vocab_size=256, embed_size=16, hidden_size=32, batch_size=4,
                num_steps=8, epochs=2, learning_rate=5e-3, seed=5)
    base.update(kw)
    return Config(**base)


def _windows(ids, batch, steps, n):
    return [(x.astype(np.int32), y.astype(np.int32))
            for _, (x, y) in zip(range(n), bptt_batches(np.asarray(ids), batch, steps))]


def _tt(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _leaves_close(port_flat, jax_tree, **tol):
    want = checkpoint.flatten(jax.tree.map(np.asarray, jax_tree))
    assert sorted(port_flat) == sorted(want)
    for k, v in port_flat.items():
        np.testing.assert_allclose(v.detach().numpy(), want[k], err_msg=k, **tol)


@pytest.mark.parametrize("mode", ["prefix", "disjoint"])
def test_dsoftmax_head_logits_matches_jax(mode):
    """D-softmax logits, fp32: tolerance 1e-5 (summation order)."""
    cfg = Config(vocab_size=256, embed_size=32, hidden_size=64, head="dsoftmax",
                 dsoftmax=DSoftmaxConfig(block_sizes=(64, 192),
                                         block_dims=(64, 32) if mode == "prefix" else (40, 24),
                                         mode=mode), seed=5)
    params = init_params(cfg)
    h = np.random.default_rng(1).normal(size=(6, 64)).astype(np.float32)
    want = jax_lstm.head_logits(params, cfg, jnp.asarray(h))
    got = lstm.head_logits(params_to_torch(params, "cpu"), cfg, torch.from_numpy(h))
    assert got.shape == (6, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_forward_hidden_matches_jax_and_remat_is_exact():
    """hs and the carried state vs JAX (fp32 "highest"): atol 1e-5; grads
    with ``remat=True`` equal the stored-activation grads to 1e-6."""
    cfg = small_cfg(num_layers=2)
    params = init_params(cfg)
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 256, (4, 8)).astype(np.int32)
    c0, h0 = (rng.normal(size=(2, 4, 32)).astype(np.float32) * 0.1 for _ in range(2))
    hs_j, (c_j, h_j) = jax_lstm.forward_hidden(params, cfg, jnp.asarray(ids),
                                               (jnp.asarray(c0), jnp.asarray(h0)),
                                               precision="highest")
    pt = params_to_torch(params, "cpu")
    state = (torch.from_numpy(c0), torch.from_numpy(h0))
    hs_t, (c_t, h_t) = lstm.forward_hidden(pt, cfg, _tt(ids), state)
    for got, want in ((hs_t, hs_j), (c_t, c_j), (h_t, h_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)

    flat = checkpoint.flatten(pt)
    for p in flat.values():
        p.requires_grad_(True)
    y = _tt(np.roll(ids, -1, axis=1))

    def grads(remat):
        hs, _ = lstm.forward_hidden(pt, cfg, _tt(ids), state, remat=remat)
        loss = heads.full_softmax_loss(pt, cfg, hs, y)
        return torch.autograd.grad(loss, list(flat.values()))

    for a, b in zip(grads(False), grads(True)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_fused_ce_loss_and_grads_match_jax(encoded):
    """The port's test_fused_ce_loss_and_grads_match_unfused: the fused
    route (precision "highest") vs JAX's unfused loss and grads on every
    parameter.  Loss rtol 1e-5; grads atol 2e-5, rtol 1e-4."""
    train, _, _ = encoded
    cfg = small_cfg()
    params = init_params(cfg)
    ids = np.asarray(train[:4 * 9]).reshape(4, 9).astype(np.int32)
    st = jax_lstm.initial_state(cfg, 4)

    def loss_j(p):
        hs, _ = jax_lstm.forward_hidden(p, cfg, jnp.asarray(ids[:, :-1]), st, precision="highest")
        return jax_heads.full_softmax_loss(p, cfg, hs, jnp.asarray(ids[:, 1:]), precision="highest")

    l_j, g_j = jax.value_and_grad(loss_j)(jax.tree.map(jnp.asarray, params))
    cfg_f = cfg.replace(fused_ce=True)
    pt = params_to_torch(params, "cpu")
    flat = checkpoint.flatten(pt)
    for p in flat.values():
        p.requires_grad_(True)
    hs, _ = lstm.forward_hidden(pt, cfg_f, _tt(ids[:, :-1]), lstm.initial_state(cfg, 4, "cpu"))
    l_t = heads.full_softmax_loss(pt, cfg_f, hs, _tt(ids[:, 1:]), precision="highest")
    np.testing.assert_allclose(l_t.item(), float(l_j), rtol=1e-5)
    g_t = dict(zip(flat, torch.autograd.grad(l_t, list(flat.values()))))
    _leaves_close(g_t, g_j, atol=2e-5, rtol=1e-4)


def test_sampled_softmax_matches_jax_and_sampler_is_zipf():
    """Given the same sampled ids (with accidental hits), the sampled loss
    equals JAX's to 1e-5; log q equals JAX's to 1e-6; 200,000 draws of the
    port's sampler follow q(k) within 5 standard errors on the first ids."""
    cfg = small_cfg(sampled_softmax_samples=16)
    params = init_params(cfg)
    rng = np.random.default_rng(4)
    hs = rng.normal(size=(2, 5, 32)).astype(np.float32) * 0.3
    tgt = rng.integers(0, 256, (2, 5)).astype(np.int32)
    # JAX draws from its key inside the loss; the port is given that draw,
    # and three targets are set to sampled ids (accidental hits)
    drawn = np.asarray(jax_heads.sample_log_uniform(jax.random.key(3), 256, 16))
    tgt[0, :3] = drawn[:3]
    want = jax_heads.sampled_softmax_loss(params, cfg, jnp.asarray(hs), jnp.asarray(tgt),
                                          jax.random.key(3), precision="highest")
    got = heads.sampled_softmax_loss(params_to_torch(params, "cpu"), cfg, torch.from_numpy(hs),
                                     _tt(tgt), _tt(drawn))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)

    np.testing.assert_allclose(heads.log_uniform_logq(256).numpy(),
                               np.asarray(jax_heads.log_uniform_logq(256)), atol=1e-6)
    g = torch.Generator().manual_seed(0)
    draws = heads.sample_log_uniform(g, 256, 200_000)
    assert draws.min() >= 0 and draws.max() < 256
    q = np.exp(np.asarray(jax_heads.log_uniform_logq(256)))
    freq = np.bincount(draws.numpy(), minlength=256) / 200_000
    se = np.sqrt(q * (1 - q) / 200_000)
    # the sampler rounds exp(u log(V+1)) - 2, so id k collects the draws of
    # [k - 0.5, k + 0.5): compare the head of the distribution to that mass
    k = np.arange(1, 8)
    mass = (np.log(k + 2.5) - np.log(k + 1.5)) / np.log(257.0)
    assert np.all(np.abs(freq[k] - mass) < 5 * se[k]), (freq[k], mass)
    assert np.all(np.diff(freq[:64]) <= 5 * se[:63])  # decreasing (Zipf)


def test_epoch_lr_matches_jax():
    from jlm_tpu.train.trainer import epoch_lr as jax_epoch_lr

    cfg = small_cfg(learning_rate=0.5, lr_decay=0.8, lr_decay_start_epoch=3)
    for epoch in range(10):
        for start in (None, 0, 2, 7):
            assert epoch_lr(cfg, epoch, start) == jax_epoch_lr(cfg, epoch, start)


def test_grad_accum_equals_big_batch(encoded):
    """3 SGD updates, each of 2 accumulated microbatches of 4 rows, equal 3
    updates on the 8-row batches (no clipping, zero initial state):
    atol 1e-6."""
    train, _, _ = encoded
    base = dict(optimizer="sgd", learning_rate=1e-2, max_grad_norm=1e9)
    tr_a = Trainer(small_cfg(batch_size=4, grad_accum_steps=2, **base), device="cpu")
    tr_b = Trainer(small_cfg(batch_size=8, **base), device="cpu")
    st_a = lstm.initial_state(tr_a.config, 4, "cpu")
    st_b = lstm.initial_state(tr_b.config, 8, "cpu")
    for step in range(3):
        x = np.asarray(train[64 * step: 64 * (step + 1)]).reshape(8, 8)
        y = np.roll(x, -1, axis=1)
        for mb in (slice(0, 4), slice(4, 8)):
            tr_a._train_step(st_a, _tt(x[mb]), _tt(y[mb]), 1e-2)
        tr_b._train_step(st_b, _tt(x), _tt(y), 1e-2)
        for k, v in tr_a.flat.items():
            np.testing.assert_allclose(v.detach().numpy(), tr_b.flat[k].detach().numpy(),
                                       atol=1e-6, err_msg=f"step {step} {k}")


def test_adam_clip_steps_match_jax(encoded):
    """3 Adam steps with the global-norm clip active (max_grad_norm 0.1),
    state carried, vs ``jlm_tpu.train.Trainer._train_step`` from the same
    params and batches: losses rtol 1e-5, params atol 1e-5 (the first
    Adam step moves each weight by about lr = 5e-3 whatever the gradient's
    size, so sum-order noise in a tiny gradient shows at that scale only
    where its sign is in doubt)."""
    from jlm_tpu.train import Trainer as JaxTrainer

    train, _, _ = encoded
    cfg = small_cfg(max_grad_norm=0.1)
    jt, tt = JaxTrainer(cfg), Trainer(cfg, device="cpu")
    st_j = jax_lstm.initial_state(cfg, 4)
    st_t = lstm.initial_state(cfg, 4, "cpu")
    for x, y in _windows(train, 4, 8, 3):
        jt.params, jt.opt_state, st_j, l_j = jt._train_step(
            jt.params, jt.opt_state, st_j, jnp.asarray(x), jnp.asarray(y),
            jax.random.key(0), jnp.float32(cfg.learning_rate))
        st_t, l_t = tt._train_step(st_t, _tt(x), _tt(y), cfg.learning_rate)
        np.testing.assert_allclose(l_t.item(), float(l_j), rtol=1e-5)
    assert tt.opt_state.count == 3
    _leaves_close(tt.flat, jt.params, atol=1e-5)


@pytest.mark.parametrize("mode", ["fp32", "fused_ce", "bf16", "pallas_scan"])
def test_trainer_loss_trajectory_matches_jax(encoded, mode):
    """5 steps of the port's Trainer vs JAX's at small_cfg, then dev
    perplexity over the trained weights.  Unfused fp32, and fp32 through
    the fused scan (JAX's Pallas kernels in interpret mode, the port's
    plain versions): rtol 1e-4.  With ``fused_ce`` the CE computes in bf16
    on both sides (the reference's default precision) while the model stays
    fp32, and with a bf16 forward (unfused) every matmul rounds to bf16:
    rtol 1e-3 for both.  (The reference's bf16 forward with the fused CE
    does not trace: its custom VJP returns an fp32 dh for a bf16 h.)"""
    from jlm_tpu.train import Trainer as JaxTrainer

    train, dev, _ = encoded
    cfg = small_cfg(**{"fp32": {}, "fused_ce": dict(fused_ce=True),
                       "bf16": dict(compute_dtype="bfloat16"),
                       "pallas_scan": dict(use_pallas_scan=True)}[mode])
    rtol = 1e-4 if mode in ("fp32", "pallas_scan") else 1e-3
    jt, tt = JaxTrainer(cfg), Trainer(cfg, device="cpu")
    st_j = jax_lstm.initial_state(cfg, 4)
    st_t = lstm.initial_state(cfg, 4, "cpu")
    for x, y in _windows(train, 4, 8, 5):
        jt.params, jt.opt_state, st_j, l_j = jt._train_step(
            jt.params, jt.opt_state, st_j, jnp.asarray(x), jnp.asarray(y),
            jax.random.key(0), jnp.float32(cfg.learning_rate))
        st_t, l_t = tt._train_step(st_t, _tt(x), _tt(y), cfg.learning_rate)
        np.testing.assert_allclose(l_t.item(), float(l_j), rtol=rtol)
    np.testing.assert_allclose(tt.evaluate_ppl(dev[:400]), jt.evaluate_ppl(dev[:400]), rtol=rtol)


def test_checkpoint_cross_loads_both_ways(tmp_path):
    """A port checkpoint loads through jlm_tpu.train.checkpoint with equal
    arrays and config, and a JAX checkpoint into the port's Trainer."""
    from jlm_tpu.train.checkpoint import load_checkpoint as jax_load
    from jlm_tpu.train.checkpoint import save_checkpoint as jax_save

    cfg = small_cfg(num_layers=2)
    tr = Trainer(cfg, device="cpu")
    with torch.no_grad():
        for p in tr.flat.values():
            p.add_(0.25)  # not init_params' values
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    tr.save_state(port_dir, epoch=0)
    loaded, loaded_cfg = jax_load(port_dir)
    assert loaded_cfg == cfg
    want = checkpoint.flatten(loaded)
    assert sorted(want) == sorted(tr.flat)
    for k, v in tr.flat.items():
        np.testing.assert_array_equal(v.detach().numpy(), want[k])

    params = jax.tree.map(lambda a: a * 2.0, init_params(cfg))
    jax_save(jax_dir, params, cfg)
    # the port reads config.json into its own Config, with the same fields
    assert checkpoint.load_checkpoint(jax_dir)[1] == PortConfig(
        **{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
    tr2 = Trainer(cfg, device="cpu")
    assert tr2.load_state(jax_dir) == 0  # no optimizer state of the port
    _leaves_close(tr2.flat, params, atol=0)


def test_resume_restores_moments_without_duplicate_log_records(encoded, tmp_path):
    """A run stops after epoch 1 with a record of a re-run epoch 2 already
    logged (a crash between log and checkpoint); resuming continues at
    epoch 2 with the saved Adam moments and leaves one record per epoch."""
    train, dev, _ = encoded
    exp = str(tmp_path)
    cfg = small_cfg(epochs=2)
    train_lm(cfg, train[:600], dev[:200], exp_dir=exp, log=False, device="cpu")
    checkpoint.append_log(exp, {"epoch": 2, "lr": 0.0, "train_ppl": 0.0, "dev_ppl": 0.0})
    assert not os.path.exists(os.path.join(exp, "opt_state.npz"))
    saved = Trainer(cfg, device="cpu")
    assert saved.load_state(exp) == 2
    assert saved.opt_state.count > 0
    assert any(float(m.abs().sum()) > 0 for m in saved.opt_state.mu.values())

    _, hist = train_lm(cfg.replace(epochs=3), train[:600], dev[:200], exp_dir=exp,
                       log=False, resume=True, device="cpu")
    assert [r["epoch"] for r in hist] == [2]
    epochs = [r["epoch"] for r in checkpoint.read_log(exp)]
    assert epochs == [0, 1, 2]
    assert checkpoint.read_log(exp)[2]["dev_ppl"] > 1.0
    resumed = Trainer(cfg, device="cpu")
    assert resumed.load_state(exp) == 3
    assert resumed.opt_state.count == saved.opt_state.count + len(list(
        bptt_batches(np.asarray(train[:600]), 4, 8)))


def test_resume_of_a_jax_experiment_keeps_its_log(encoded, tmp_path):
    """Resuming a jlm_tpu experiment directory (weights and log.jsonl, no
    optimizer state of the port) starts at epoch 0 from its weights and
    appends to its log: no record of the JAX run is dropped."""
    from jlm_tpu.train.checkpoint import append_log as jax_append_log
    from jlm_tpu.train.checkpoint import save_checkpoint as jax_save

    train, dev, _ = encoded
    exp = str(tmp_path)
    cfg = small_cfg(epochs=1)
    jax_save(exp, init_params(cfg), cfg)
    jax_records = [{"epoch": e, "lr": 5e-3, "train_ppl": 9.0, "dev_ppl": 9.0}
                   for e in range(3)]
    for rec in jax_records:
        jax_append_log(exp, rec)
    _, hist = train_lm(cfg, train[:600], dev[:200], exp_dir=exp, log=False,
                       resume=True, device="cpu")
    assert [r["epoch"] for r in hist] == [0]
    records = checkpoint.read_log(exp)
    assert records[:3] == jax_records
    assert [r["epoch"] for r in records] == [0, 1, 2, 0]


@pytest.mark.parametrize("kind", ["bf16_fused", "sampled", "dsoftmax_fused"])
def test_trainer_variants_improve(encoded, kind):
    """One epoch lowers dev perplexity in bf16 with the fused CE, with the
    sampled softmax, and with a fused D-softmax head."""
    train, dev, _ = encoded
    kw = {"bf16_fused": dict(compute_dtype="bfloat16", fused_ce=True),
          "sampled": dict(sampled_softmax_samples=32),
          "dsoftmax_fused": dict(head="dsoftmax", fused_ce=True,
                                 dsoftmax=DSoftmaxConfig(block_sizes=(64, 192),
                                                         block_dims=(32, 16)))}[kind]
    tr = Trainer(small_cfg(**kw), device="cpu")
    ppl0 = tr.evaluate_ppl(dev[:400])
    tr.run_epoch(train[:2000], 0)
    assert tr.evaluate_ppl(dev[:400]) < ppl0


def test_cli_rejects_unported_options(encoded, vocab, tmp_path):
    """``--mesh-seq`` is exclusive with ``--mesh-data`` / ``--mesh-vocab``
    and needs ``--num-steps`` to divide by it (``scripts/train.py``'s
    rules, checked before the data loads); ``--mesh-seq 2`` alone trains
    (two ranks on the CPU) and writes the reference's experiment layout."""
    from jlm_tpu_torch.data.io import save_dataset
    from jlm_tpu_torch.train.__main__ import main

    for flag, what in ((["--mesh-seq", "2", "--mesh-data", "2"], "exclusive"),
                       (["--mesh-seq", "2", "--mesh-vocab", "4"], "exclusive"),
                       (["--mesh-seq", "3"], "divide")):
        with pytest.raises(ValueError, match=what):
            main(["--data", str(tmp_path), "--exp", str(tmp_path / "e"), *flag])
    train, dev, test = encoded
    data, exp = str(tmp_path / "data"), str(tmp_path / "exp")
    save_dataset(data, vocab, train[:800], dev[:200], test[:200])
    main(["--data", data, "--exp", exp, "--embed-size", "16", "--hidden-size", "32",
          "--batch-size", "4", "--num-steps", "8", "--epochs", "1", "--mesh-seq", "2",
          "--device", "cpu"])
    assert sorted(os.listdir(exp)) == ["ckpt-latest.npz", "config.json", "log.jsonl",
                                       checkpoint.OPT_STATE_FILE]
    with open(os.path.join(exp, "config.json")) as f:
        assert json.load(f)["mesh_seq"] == 2
    assert np.isfinite(checkpoint.read_log(exp)[0]["dev_ppl"])


def test_cli_trains_from_a_data_dir(encoded, vocab, tmp_path):
    """``python -m jlm_tpu_torch.train`` on a saved data dir writes the
    reference's experiment layout."""
    from jlm_tpu.data.io import save_dataset
    from jlm_tpu_torch.train.__main__ import main

    train, dev, test = encoded
    data = str(tmp_path / "data")
    save_dataset(data, vocab, train[:800], dev[:200], test[:200])
    exp = str(tmp_path / "exp")
    main(["--data", data, "--exp", exp, "--embed-size", "16", "--hidden-size", "32",
          "--batch-size", "4", "--num-steps", "8", "--epochs", "1", "--device", "cpu"])
    assert sorted(os.listdir(exp)) == ["ckpt-latest.npz", "config.json", "log.jsonl",
                                       checkpoint.OPT_STATE_FILE]
    with open(os.path.join(exp, "config.json")) as f:
        assert json.load(f)["vocab_size"] == len(vocab)


def test_cli_trains_with_pallas_scan(encoded, vocab, tmp_path):
    """``--pallas-scan`` on the CPU trains through the scan's plain
    versions: the config records it, dev perplexity falls below the
    untrained model's, and no scan kernel is launched."""
    from jlm_tpu.data.io import save_dataset
    from jlm_tpu_torch.ops import lstm_scan as ls
    from jlm_tpu_torch.train.__main__ import main

    train, dev, test = encoded
    data = str(tmp_path / "data")
    save_dataset(data, vocab, train[:1600], dev[:200], test[:200])
    exp = str(tmp_path / "exp")
    n0 = (ls.lstm_scan_fwd.launches, ls.lstm_scan_bwd.launches)
    main(["--data", data, "--exp", exp, "--embed-size", "16", "--hidden-size", "32",
          "--batch-size", "4", "--num-steps", "8", "--epochs", "1", "--lr", "5e-3",
          "--pallas-scan", "--device", "cpu"])
    assert (ls.lstm_scan_fwd.launches, ls.lstm_scan_bwd.launches) == n0
    with open(os.path.join(exp, "config.json")) as f:
        assert json.load(f)["use_pallas_scan"] is True
    (rec,) = checkpoint.read_log(exp)
    untrained = Trainer(checkpoint.load_checkpoint(exp)[1], device="cpu")
    assert rec["dev_ppl"] < untrained.evaluate_ppl(dev[:200])


def test_training_modules_import_without_jax():
    code = ("import sys\n"
            "import jlm_tpu_torch.train, jlm_tpu_torch.train.__main__\n"
            "import jlm_tpu_torch.models.heads, jlm_tpu_torch.ops.softmax_ce\n"
            "from jlm_tpu_torch.ops import _build\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'optax'))\n"
            "assert not bad, bad\n"
            "assert _build._lib is None\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, PATH=""))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
