"""Trainer with truncated BPTT, on one device or one rank of a mesh.

Counterpart of :mod:`jlm_tpu.train.trainer`: the epoch loop
over BPTT windows with the LSTM state carried between windows (detached:
the reference carries it as a value between jitted steps) and reset to
zeros at each epoch; global-norm clipping, Adam or SGD, gradient
accumulation and the per-epoch (optionally dev-PPL-gated) learning-rate
decay of :mod:`jlm_tpu_torch.train.optim`; bf16 mixed precision with fp32
master parameters; dev perplexity; full-state checkpoints and resume.

With ``config.use_pallas_scan`` the LSTM runs through the fused scan
kernels (``forward_hidden_scan``): the fp32 master parameters go into the
kernels, which round the products' operands to ``compute_dtype``, and the
head is not cast to bf16 (the reference's ``--pallas-scan`` path does the
same).

The loss is the full softmax (fused CE kernels with ``config.fused_ce``)
or the log-uniform sampled softmax, drawn from a ``torch.Generator``
seeded from ``config.seed``.  Loss sums stay on the device and are fetched
once per epoch.

With ``mesh`` (a ``(data, vocab)`` :class:`jlm_tpu_torch.parallel.Mesh`
of more than one rank) the same loop runs the sharded step of
:mod:`jlm_tpu_torch.parallel.train_step` in every rank's process: the
batch's rows split over the data axis, the head's columns over the vocab
axis (vocab-parallel CE, through the CE kernels with ``fused_ce``), the
gradients summed over the data group and the clip on the whole tree's
norm.  Checkpoints hold the full tree whatever the mesh: the head's
shards are gathered on save (rank 0 writes) and sliced again on load.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from jlm_tpu_torch.config import Config
from jlm_tpu_torch.data.reader import bptt_batches
from jlm_tpu_torch.models.heads import (
    full_softmax_loss,
    sample_log_uniform,
    sampled_softmax_loss,
)
from jlm_tpu_torch.models.lstm import (
    State,
    forward_hidden,
    forward_hidden_scan,
    initial_state,
)
from jlm_tpu_torch.models.params import init_params, params_to_torch, resolve_device
from jlm_tpu_torch.parallel import comm
from jlm_tpu_torch.parallel import train_step as sharded
from jlm_tpu_torch.train import checkpoint, optim


def _tree_map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def cast_floats(tree: Any, dtype) -> Any:
    """Cast the float leaves of a parameter pytree to ``dtype``."""
    return _tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t, tree)


def epoch_lr(config: Config, epoch: int, decay_start=None) -> float:
    """``lr * decay ** max(0, epoch - start)``; ``decay_start`` overrides
    ``config.lr_decay_start_epoch`` (the PPL-gated schedule passes the
    epoch after dev PPL first cleared the gate)."""
    start = config.lr_decay_start_epoch if decay_start is None else decay_start
    return config.learning_rate * (config.lr_decay ** max(0, epoch - start))


class Trainer:
    """Trains the LSTM LM on one device, or as one rank of ``mesh``.

    ``params`` is a parameter pytree (numpy or torch leaves; copied; the
    full tree, also under a mesh), by default ``init_params(config)``.
    ``device`` defaults to the card (``"cuda"`` without a GPU raises);
    with ``mesh`` it runs on the mesh's device (a ``device`` naming
    another raises).  Sampled softmax under vocab sharding raises."""

    def __init__(self, config: Config, params: Optional[Any] = None, mesh=None, *,
                 device="cuda"):
        self.config = config
        self.mesh = mesh if mesh is not None and mesh.world > 1 else None
        if mesh is not None:
            from jlm_tpu_torch.parallel.mesh import mesh_device

            device = mesh_device(mesh, device)
        self.device = resolve_device(device)
        params = params_to_torch(init_params(config) if params is None else params,
                                 self.device)
        if self.mesh:
            self._head_loss = sharded.make_loss_fn(self.mesh, config)
            params = sharded.init_sharded_training(params, config, self.mesh)
            self._step = sharded.make_sharded_train_step(
                self.mesh, config, lambda x, y, st: self._loss(self.params, x, y, st),
                lambda flat, grads, lr, norm_fn: optim.apply_gradients(
                    flat, grads, self.opt_state, self.config, lr, norm_fn))
            self._eval = sharded.make_sharded_eval_step(self.mesh, self._eval_rows)
        self.params = _tree_map(lambda p: p.detach().clone().requires_grad_(True), params)
        self.flat = checkpoint.flatten(self.params)  # path -> the same leaves
        self.opt_state = optim.init_state(config, self.flat)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(config.seed)
        self.rows = config.batch_size // (self.mesh.data if self.mesh else 1)

    # --- one window ----------------------------------------------------
    def _forward(self, params, x, state: State) -> Tuple[torch.Tensor, State]:
        cfg = self.config
        if cfg.use_pallas_scan:
            cd = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
            return forward_hidden_scan(params, cfg, x, state, compute_dtype=cd)
        if cfg.compute_dtype == "bfloat16":
            # fp32 master params, bf16 forward; the casts' backward returns
            # fp32 gradients
            bf = torch.bfloat16
            hs, (c, h) = forward_hidden(cast_floats(params, bf), cfg, x,
                                        (state[0].to(bf), state[1].to(bf)),
                                        remat=cfg.remat)
            return hs, (c.float(), h.float())
        return forward_hidden(params, cfg, x, state, remat=cfg.remat)

    def _loss(self, params, x, y, state: State) -> Tuple[torch.Tensor, State]:
        cfg = self.config
        hs, state = self._forward(params, x, state)
        if cfg.compute_dtype == "bfloat16" and not cfg.use_pallas_scan:
            params = cast_floats(params, torch.bfloat16)
        if cfg.sampled_softmax_samples > 0:
            sampled = sample_log_uniform(self.generator, cfg.vocab_size,
                                         cfg.sampled_softmax_samples)
            return sampled_softmax_loss(params, cfg, hs, y, sampled), state
        if self.mesh:
            return self._head_loss(params, hs, y), state
        return full_softmax_loss(params, cfg, hs, y), state

    def _train_step(self, state: State, x, y, lr: float) -> Tuple[State, torch.Tensor]:
        """Loss, gradients and one optimizer call; returns the carried
        state (detached) and the loss (under a mesh: this rank's rows of
        the batch; the global batch's mean loss)."""
        if self.mesh:
            return self._step(self.flat, sharded.local_rows(x, self.mesh),
                              sharded.local_rows(y, self.mesh), state, lr)
        loss, state = self._loss(self.params, x, y, state)
        keys = list(self.flat)
        grads = torch.autograd.grad(loss, [self.flat[k] for k in keys])
        optim.apply_gradients(self.flat, dict(zip(keys, grads)), self.opt_state,
                              self.config, lr)
        return (state[0].detach(), state[1].detach()), loss.detach()

    def _eval_rows(self, x, y, state: State) -> Tuple[torch.Tensor, State]:
        hs, state = self._forward(self.params, x, state)
        # the reference's bf16 hs meet fp32 head weights as fp32
        if self.mesh:
            return self._head_loss(self.params, hs.float(), y), state
        return full_softmax_loss(self.params, self.config, hs.float(), y), state

    @torch.no_grad()
    def _eval_step(self, state: State, x, y) -> Tuple[torch.Tensor, State]:
        if self.mesh:
            return self._eval(sharded.local_rows(x, self.mesh), sharded.local_rows(y, self.mesh),
                              state)
        return self._eval_rows(x, y, state)

    # --- loops -----------------------------------------------------------
    def _windows(self, ids: np.ndarray):
        """BPTT windows ``(x, y)`` as views of ``ids`` uploaded once."""
        cfg = self.config
        ids_t = torch.from_numpy(np.asarray(ids, np.int64)).to(self.device)
        return bptt_batches(ids_t, cfg.batch_size, cfg.num_steps)

    def _perplexity(self, steps) -> float:
        total, n = torch.zeros((), device=self.device), 0
        for loss, tokens in steps:
            total += loss * tokens
            n += tokens
        if n == 0:
            return float("nan")
        return float(np.exp(total.cpu().numpy() / max(1, n)))

    def train_steps(self, ids: np.ndarray, epoch: int, decay_start=None):
        """Train over the BPTT windows of ``ids`` at epoch ``epoch``'s
        learning rate, from a zero state; yields ``(loss, tokens)`` per
        window, the loss a device scalar (nothing waits for the device)."""
        cfg = self.config
        lr = epoch_lr(cfg, epoch, decay_start)
        state = initial_state(cfg, self.rows, self.device)
        for x, y in self._windows(ids):
            state, loss = self._train_step(state, x, y, lr)
            yield loss, x.numel()

    def run_epoch(self, ids: np.ndarray, epoch: int, decay_start=None) -> float:
        """One epoch of training; returns its training perplexity."""
        return self._perplexity(self.train_steps(ids, epoch, decay_start))

    def evaluate_ppl(self, ids: np.ndarray) -> float:
        """Perplexity under the full-softmax objective (the sampled softmax
        is a training-only approximation)."""
        def steps():
            state = initial_state(self.config, self.rows, self.device)
            for x, y in self._windows(ids):
                loss, state = self._eval_step(state, x, y)
                yield loss, x.numel()

        return self._perplexity(steps())

    # --- full training state -------------------------------------------
    def save_state(self, exp_dir: str, epoch: int) -> str:
        """Write ``ckpt-latest.npz`` (+ ``config.json``) and the optimizer
        state with the epoch just finished.  Under a mesh every rank calls
        it: the head's shards and moments are gathered into the full tree,
        rank 0 writes, and every rank returns once the files are there."""
        params, state = self.params, self.opt_state
        if self.mesh:
            params = sharded.gather_head(self.flat, self.mesh)
            state = optim.OptState(
                count=state.count, mini_step=state.mini_step,
                **{name: sharded.gather_head(getattr(state, name), self.mesh)
                   for name in ("mu", "nu", "acc")})
            if self.mesh.rank != 0:
                comm.barrier()
                return ""
        os.makedirs(exp_dir, exist_ok=True)
        checkpoint.save_checkpoint(exp_dir, params, self.config, tag="latest")
        path = checkpoint.save_opt_state(exp_dir, state, epoch)
        if self.mesh:
            comm.barrier()
        return path

    def load_state(self, exp_dir: str) -> int:
        """Restore params and optimizer state; returns the next epoch (0
        when the directory holds no optimizer state of the port)."""
        params, _ = checkpoint.load_checkpoint(exp_dir, tag="latest")
        loaded = checkpoint.flatten(params)
        if self.mesh:  # the full tree's head sliced to this rank's columns
            loaded = sharded.slice_head(loaded, self.config, self.mesh)
        with torch.no_grad():
            for k, p in self.flat.items():
                p.copy_(torch.from_numpy(np.ascontiguousarray(loaded[k])))
        restored = checkpoint.load_opt_state(exp_dir, self.device)
        if restored is None:
            self.opt_state = optim.init_state(self.config, self.flat)
            return 0
        self.opt_state, epoch = restored
        if self.mesh:
            for name in ("mu", "nu", "acc"):
                setattr(self.opt_state, name, {
                    k: v.contiguous() for k, v in sharded.slice_head(
                        getattr(self.opt_state, name), self.config, self.mesh).items()})
        return epoch + 1


def train_lm(config: Config, train_ids: np.ndarray, dev_ids: np.ndarray,
             exp_dir: Optional[str] = None, log: bool = True, resume: bool = False,
             save_every: int = 1, mesh=None, *,
             device="cuda") -> Tuple[Any, List[Dict[str, float]]]:
    """Full training run; returns ``(params, per-epoch history)``.  With
    ``mesh`` every rank calls it; rank 0 prints and writes the log.

    ``resume=True`` restores params, optimizer state and epoch from
    ``exp_dir``, drops log records of epochs after the restored one (they
    are re-run), and continues.  ``save_every``: checkpoint every N epochs
    and after the last."""
    trainer = Trainer(config, mesh=mesh, device=device)
    lead = trainer.mesh is None or trainer.mesh.rank == 0
    log = log and lead
    start_epoch = 0
    if resume and exp_dir:
        start_epoch = trainer.load_state(exp_dir)
        if start_epoch:  # the port's optimizer state was restored
            if lead:
                checkpoint.truncate_log(exp_dir, start_epoch - 1)
            if log:
                print(f"resumed {exp_dir} at epoch {start_epoch}")
    history: List[Dict[str, float]] = []
    # PPL-gated decay: full lr until dev PPL clears the gate, decay from the
    # next epoch, never later than lr_decay_start_epoch; a resumed run
    # recovers the gate epoch from the log
    gate = float(config.lr_decay_gate_ppl or 0.0)
    decay_start = None
    if gate > 0:
        decay_start = config.lr_decay_start_epoch
        if resume and exp_dir:
            for r in checkpoint.read_log(exp_dir):
                if "decay_start" in r:
                    decay_start = min(decay_start, int(r["decay_start"]))
    for epoch in range(start_epoch, config.epochs):
        t0 = time.time()
        train_ppl = trainer.run_epoch(train_ids, epoch, decay_start)
        dev_ppl = trainer.evaluate_ppl(dev_ids)
        rec = {"epoch": epoch, "lr": epoch_lr(config, epoch, decay_start),
               "train_ppl": train_ppl, "dev_ppl": dev_ppl,
               "seconds": time.time() - t0}
        if gate > 0 and dev_ppl < gate and epoch + 1 < decay_start:
            decay_start = epoch + 1
        if gate > 0:
            rec["decay_start"] = decay_start
        history.append(rec)
        if log:
            print(f"epoch {epoch}: train_ppl={train_ppl:.2f} dev_ppl={dev_ppl:.2f} "
                  f"lr={rec['lr']:.4g} ({rec['seconds']:.1f}s)")
        if exp_dir:
            if lead:
                checkpoint.append_log(exp_dir, rec)
            if (epoch + 1) % max(1, save_every) == 0 or epoch + 1 == config.epochs:
                trainer.save_state(exp_dir, epoch)
    return trainer.params, history


def train_rank(device, config: Config, data_dir: str, exp_dir: str, resume: bool) -> None:
    """One rank of a ``(config.mesh_data, config.mesh_vocab)`` training run
    (``parallel.comm.spawn`` calls it in each rank's process): the
    dataset from ``data_dir``, this rank's mesh, :func:`train_lm`."""
    from jlm_tpu_torch.data.io import load_dataset
    from jlm_tpu_torch.parallel import make_mesh

    _, train, dev, _ = load_dataset(data_dir)
    train_lm(config, train, dev, exp_dir=exp_dir, resume=resume,
             mesh=make_mesh(config, device), device=device)
