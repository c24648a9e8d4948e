"""The training steps over a ``(data, vocab)`` or a ``('seq',)`` mesh, one
process per rank.

Counterpart of :mod:`jlm_tpu.parallel.train_step`.  On a ``(data, vocab)``
mesh batch rows shard over the
data axis and are replicated over the vocab axis; the head is
column-sharded over the vocab axis (:func:`vocab_parallel_nll`), the
embedding and the LSTM replicated.  JAX's data-axis ``pmean`` becomes one
SUM of the gradients over the data group, then a divide, once a step
(:func:`sync_grads`); the global-norm clip sees the logical tree's norm
(:func:`global_norm`): the squares of the sharded head leaves summed over
the vocab group, the replicated leaves counted once.

On a ``('seq',)`` mesh (:func:`make_seq_loss_fn`) the BPTT window's time
axis is cut over the ranks and the batch into pipeline microbatches
(:mod:`jlm_tpu_torch.parallel.seq_pipeline`); every parameter is
replicated.  Each rank embeds its own time block and takes the head's CE
(the fused CE kernels with ``config.fused_ce``) over its own ``B x T/P``
rows, divided by ``B x T``: the ranks' losses sum to the global token
mean.  JAX's transpose of the replicated parameters sums their
cotangents over the axis; here :func:`seq_sum_grads` makes that one SUM
of every gradient over the seq group, once a step.

:class:`jlm_tpu_torch.train.Trainer` with ``mesh=`` runs these behind its
epoch loop.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from jlm_tpu_torch.config import Config
from jlm_tpu_torch.parallel import comm
from jlm_tpu_torch.parallel.mesh import Mesh, SeqMesh
from jlm_tpu_torch.parallel.sharded_head import shard_params, vocab_parallel_nll

SAMPLED_VOCAB = ("sampled softmax is incompatible with vocab (tensor) parallelism; use a "
                 "data-only mesh (mesh_vocab=1) or the default vocab-parallel "
                 "full-softmax CE")


def is_sharded(key: str) -> bool:
    """Whether the flat parameter path names a column-sharded head leaf."""
    return key.startswith("head/")


def global_norm(grads: Dict[str, torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """The logical tree's global norm: each sharded head leaf's sum of
    squares summed over the vocab group, each replicated leaf's once."""
    keys = sorted(grads)
    sharded = [(grads[k].float() ** 2).sum() for k in keys if is_sharded(k)]
    total = comm.all_reduce_sum(sum(sharded), mesh.vocab_group) if sharded else 0.0
    return torch.sqrt(total + sum((grads[k].float() ** 2).sum()
                                  for k in keys if not is_sharded(k)))


def _tree_sum(grads: Dict[str, torch.Tensor], group, divide: int = 1) -> Dict[str, torch.Tensor]:
    """Every leaf summed over ``group`` in one ``all_reduce`` (then divided
    by ``divide``)."""
    keys = sorted(grads)
    flat = torch.cat([grads[k].reshape(-1).float() for k in keys])
    flat = comm.all_reduce_sum(flat, group)
    if divide != 1:
        flat = flat / divide
    out, i = {}, 0
    for k in keys:
        n = grads[k].numel()
        out[k] = flat[i:i + n].reshape(grads[k].shape).to(grads[k].dtype)
        i += n
    return out


def sync_grads(grads: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The global-batch mean gradient: one SUM over the data group, then a
    divide by its size."""
    if mesh.data == 1:
        return grads
    return _tree_sum(grads, mesh.data_group, mesh.data)


def seq_sum_grads(grads: Dict[str, torch.Tensor], mesh: SeqMesh) -> Dict[str, torch.Tensor]:
    """The whole window's gradient of replicated parameters: each rank's
    share summed over the seq group (a SUM, not a mean)."""
    return _tree_sum(grads, mesh.group)


def data_mean(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The mean over the data group of a value every rank holds one of."""
    if mesh.data == 1:
        return x
    return comm.all_reduce_sum(x, mesh.data_group) / mesh.data


def make_loss_fn(mesh: Mesh, config: Config, precision: str = "default") -> Callable:
    """The head loss of the sharded step, ``loss(params, hs, y)``: the
    vocab-parallel CE over this rank's rows (through the fused CE kernels
    with ``config.fused_ce``), also the eval step's.  The sampled softmax
    (the trainer's own path, on a data-only mesh: one draw every rank
    shares, from generators seeded alike) raises under vocab sharding, at
    construction: the sampled columns would live on one shard."""
    if config.sampled_softmax_samples > 0 and mesh.vocab > 1:
        raise ValueError(SAMPLED_VOCAB)
    return vocab_parallel_nll(mesh, config, precision, use_kernels=config.fused_ce)


def local_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of a global ``[B, ...]`` batch: the data index's
    ``B / data`` contiguous rows (replicated over the vocab axis)."""
    b = x.shape[0] // mesh.data
    if b * mesh.data != x.shape[0]:
        raise ValueError(f"batch {x.shape[0]} must divide by mesh_data={mesh.data}")
    return x[mesh.data_index * b:(mesh.data_index + 1) * b]


def init_sharded_training(params: Any, config: Config, mesh: Mesh) -> Any:
    """This rank's trainable params: ``params`` (torch leaves on the mesh's
    device) with the head's columns sliced to the rank's own."""
    return shard_params(params, config, mesh)


def make_sharded_train_step(mesh: Mesh, config: Config, loss_fn: Callable,
                            apply: Callable) -> Callable:
    """``step(flat, x, y, state, lr) -> (state', global mean loss)``:
    ``loss_fn(x, y, state) -> (local mean loss, state')`` on this rank's
    rows, gradients of ``flat`` (the rank's leaves by path), synced over
    the data group, then ``apply(flat, grads, lr, norm_fn)`` with the
    logical tree's norm."""

    def step(flat: Dict[str, torch.Tensor], x, y, state, lr: float):
        loss, state = loss_fn(x, y, state)
        keys = list(flat)
        grads = dict(zip(keys, torch.autograd.grad(loss, [flat[k] for k in keys])))
        apply(flat, sync_grads(grads, mesh), lr, lambda g: global_norm(g, mesh))
        return (state[0].detach(), state[1].detach()), data_mean(loss.detach(), mesh)

    return step


def make_sharded_eval_step(mesh: Mesh, loss_fn: Callable) -> Callable:
    """``eval(x, y, state) -> (global mean NLL, state')`` (full softmax)."""

    @torch.no_grad()
    def eval_step(x, y, state) -> Tuple[torch.Tensor, Any]:
        loss, state = loss_fn(x, y, state)
        return data_mean(loss, mesh), state

    return eval_step


# ------------------------------------------------------- the seq pipeline

def check_mesh_flags(mesh_seq: int, mesh_data: int, mesh_vocab: int, num_steps: int) -> None:
    """The reference's rules for ``--mesh-seq`` (``scripts/train.py``)."""
    if mesh_seq > 1 and mesh_data * mesh_vocab != 1:
        raise ValueError("--mesh-seq is exclusive with --mesh-data/--mesh-vocab")
    if mesh_seq > 1 and num_steps % mesh_seq:
        raise ValueError("--num-steps must divide by --mesh-seq (time blocks)")


def seq_microbatches(mesh: SeqMesh, config: Config, microbatches: int = 0) -> int:
    """The pipeline's microbatch count: ``microbatches``, by default
    ``max(P, min(batch_size, 2P))``; checks the reference's rules (``M``
    divides by ``P``, the batch by ``M``, the window by ``P``)."""
    P = mesh.seq
    M = microbatches or max(P, min(config.batch_size, 2 * P))
    if M % P:
        raise ValueError(f"microbatches {M} must divide by the seq axis {P}")
    if config.batch_size % M:
        raise ValueError(f"batch {config.batch_size} must divide into {M} pipeline microbatches")
    if config.num_steps % P:
        raise ValueError(f"num_steps {config.num_steps} must divide by the seq axis {P} "
                         "(time blocks)")
    return M


def make_seq_loss_fn(mesh: SeqMesh, config: Config, microbatches: int = 0) -> Callable:
    """``loss(params, x, y, state) -> (this rank's share of the global mean
    NLL, state')`` on a ``('seq',)`` mesh, for the global batch ``x, y [B,
    T]`` and state ``[L, B, H]`` (every rank holds them whole): this rank's
    time block embedded, the pipeline, the full-softmax CE over the
    block's rows divided by the number of blocks; ``state'`` the whole
    batch's on every rank.  Also the eval step's loss."""
    from jlm_tpu_torch.models.heads import full_softmax_loss
    from jlm_tpu_torch.models.lstm import _w, embed
    from jlm_tpu_torch.parallel.seq_pipeline import make_seq_pipeline_scan

    M = seq_microbatches(mesh, config, microbatches)
    P, p = mesh.seq, mesh.rank
    L, H = config.num_layers, config.hidden_size
    pipe = make_seq_pipeline_scan(mesh, num_layers=L, forget_bias=config.forget_bias)

    def loss_fn(params, x, y, state):
        B_all, T = x.shape
        Bm, TB = B_all // M, T // P
        block = slice(p * TB, (p + 1) * TB)
        xs = embed(params, x[:, block]).reshape(M, Bm, TB, -1)
        c0, h0 = state
        c0m = c0.reshape(L, M, Bm, H).transpose(0, 1)
        h0m = h0.reshape(L, M, Bm, H).transpose(0, 1)
        layers = [(_w(l["W"]), l["b"]) for l in params["lstm"]]
        hs, c_f, h_f = pipe(xs, layers, c0m, h0m)
        loss = full_softmax_loss(params, config, hs.reshape(B_all, TB, H), y[:, block]) / P
        return loss, (c_f.transpose(0, 1).reshape(L, B_all, H),
                      h_f.transpose(0, 1).reshape(L, B_all, H))

    return loss_fn


def make_seq_train_step(mesh: SeqMesh, loss_fn: Callable, apply: Callable) -> Callable:
    """``step(flat, x, y, state, lr) -> (state', global mean loss)``:
    ``loss_fn(x, y, state) -> (this rank's share, state')``, gradients of
    ``flat`` summed over the seq group (:func:`seq_sum_grads`), then
    ``apply(flat, grads, lr, None)``: after the sum every rank holds the
    whole tree's gradient, so the clip's norm is its own."""

    def step(flat: Dict[str, torch.Tensor], x, y, state, lr: float):
        loss, state = loss_fn(x, y, state)
        keys = list(flat)
        grads = dict(zip(keys, torch.autograd.grad(loss, [flat[k] for k in keys])))
        apply(flat, seq_sum_grads(grads, mesh), lr, None)
        return ((state[0].detach(), state[1].detach()),
                comm.all_reduce_sum(loss.detach(), mesh.group))

    return step


def make_seq_eval_step(mesh: SeqMesh, loss_fn: Callable) -> Callable:
    """``eval(x, y, state) -> (global mean NLL, state')`` (full softmax)."""

    @torch.no_grad()
    def eval_step(x, y, state) -> Tuple[torch.Tensor, Any]:
        loss, state = loss_fn(x, y, state)
        return comm.all_reduce_sum(loss, mesh.group), state

    return eval_step


# ---------------------------------------------------------------- checkpoints

def _block_of(key: str) -> int:
    parts = key.split("/")
    return int(parts[2]) if len(parts) > 2 and parts[1] == "blocks" else 0


def gather_head(flat: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """Leaves by flat path with every head leaf's columns gathered over the
    vocab group (collective); the rest as they are."""
    from jlm_tpu_torch.parallel.sharded_head import _gather_cols

    return {k: _gather_cols(v.detach(), mesh.vocab_group) if is_sharded(k) else v
            for k, v in flat.items()}


def slice_head(flat: Dict[str, Any], config: Config, mesh: Mesh) -> Dict[str, Any]:
    """Full leaves by flat path (numpy or torch) with every head leaf's
    columns sliced to this rank's: the inverse of :func:`gather_head`."""
    from jlm_tpu_torch.parallel.sharded_head import shard_layout

    sizes = [s for *_, s in shard_layout(config, mesh.vocab)]
    vi = mesh.vocab_index

    def cut(k, v):
        s = sizes[_block_of(k)]
        return v[..., vi * s:(vi + 1) * s]

    return {k: cut(k, v) if is_sharded(k) else v for k, v in flat.items()}
