"""The collectives of the sharded paths, each on a process subgroup, and
:func:`spawn`, which starts a world of ranks.

JAX's ``pmax``, ``psum``, ``all_gather`` and ``psum_scatter`` become the
calls here.  PyTorch's backend table lists only ``all_reduce`` and
``broadcast`` for Gloo on CUDA tensors, so every collective is built from
``all_reduce`` on every backend:

- :func:`all_gather`: a SUM over a zero-filled ``[n, ...]`` buffer in
  which each rank writes its own slice (exact: every other term is zero;
  bf16 and fp16 travel as fp32, 8-bit integers as int32, which hold them
  exactly);
- :func:`reduce_scatter`: a SUM, then each rank keeps its own slice;
- :func:`all_reduce_max`: an ``all_reduce`` MAX, which Gloo takes on CUDA
  tensors too (``chip_smoke.py`` phase 3f holds it equal to the max of
  the gathered values on the card);
- :func:`broadcast`: one rank's tensor on every rank;
- :func:`shift_right` / :func:`shift_left`: the time-block pipeline's
  halo hand-off (JAX's ``ppermute`` to a neighbour), a SUM over a
  zero-filled ``[n, ...]`` buffer in which each rank writes the slot of
  its neighbour and reads its own (exact, as :func:`all_gather`).

A group of one rank (or no process group at all) makes each of them the
identity.  :func:`reduce_from` is the SUM for a value every rank then
holds, under autograd: its gradient passes unchanged (each rank's copy of
the downstream computation already holds the whole gradient).
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist

def group_size(group) -> int:
    if not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def group_rank(group) -> int:
    if not dist.is_initialized():
        return 0
    return dist.get_rank(group)


def _wire_dtype(dtype: torch.dtype) -> torch.dtype:
    """A dtype every backend reduces that holds ``dtype`` exactly: fp32 for
    bf16 and fp16, int32 for 8-bit integers and bool."""
    if dtype in (torch.bfloat16, torch.float16):
        return torch.float32
    if dtype in (torch.int8, torch.uint8, torch.bool):
        return torch.int32
    return dtype


def _wire(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` in its wire dtype."""
    return x.to(_wire_dtype(x.dtype), copy=True)


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Elementwise sum over the group (a new tensor; ``x`` is untouched)."""
    if group_size(group) == 1:
        return x
    y = _wire(x)
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y.to(x.dtype)


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """``[n, *x.shape]``: every rank's ``x`` in group-rank order."""
    n = group_size(group)
    if n == 1:
        return x[None]
    buf = torch.zeros((n,) + tuple(x.shape), dtype=_wire_dtype(x.dtype), device=x.device)
    buf[group_rank(group)] = x
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(x.dtype)


def all_reduce_max(x: torch.Tensor, group=None) -> torch.Tensor:
    """Elementwise max over the group."""
    if group_size(group) == 1:
        return x
    y = _wire(x)
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y.to(x.dtype)


def broadcast(x: torch.Tensor, group=None, src: int = 0) -> torch.Tensor:
    """Group rank ``src``'s ``x`` on every rank of the group (a new tensor
    on the others; ``x`` is untouched)."""
    if group_size(group) == 1:
        return x
    y = _wire(x)
    dist.broadcast(y, src=src if group is None else dist.get_global_rank(group, src),
                   group=group)
    return y.to(x.dtype)


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    n, r = group_size(group), group_rank(group)
    buf = torch.zeros((n,) + tuple(x.shape), dtype=_wire_dtype(x.dtype), device=x.device)
    if 0 <= r + step < n:
        buf[r + step] = x
    if n > 1:
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf[r].to(x.dtype)


def shift_right(x: torch.Tensor, group=None) -> torch.Tensor:
    """Group rank ``r - 1``'s ``x`` on rank ``r``; zeros on rank 0 (the
    last rank's ``x`` goes nowhere).  Every rank of the group calls it."""
    return _shift(x, group, 1)


def shift_left(x: torch.Tensor, group=None) -> torch.Tensor:
    """Group rank ``r + 1``'s ``x`` on rank ``r``; zeros on the last rank
    (rank 0's ``x`` goes nowhere).  Every rank of the group calls it."""
    return _shift(x, group, -1)


def reduce_scatter(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over the group of ``x [n*k, ...]``; this rank keeps rows
    ``[r*k, (r+1)*k)``."""
    n = group_size(group)
    if n == 1:
        return x
    k = x.shape[0] // n
    r = group_rank(group)
    return all_reduce_sum(x, group)[r * k:(r + 1) * k]


def barrier(group=None) -> None:
    if group_size(group) > 1:
        dist.barrier(group=group)


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def reduce_from(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum over the group forward; the gradient as it is backward."""
    if group_size(group) == 1:
        return x
    return _ReduceFrom.apply(x, group)


# ------------------------------------------------------------------ worlds

def rank_device(device, rank: int) -> torch.device:
    """Rank ``rank``'s device: ``cuda:(rank % device_count)`` for a CUDA
    ``device`` without an index, else ``device`` itself."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def _entry(rank: int, world: int, device, init_method: str, out_dir: str) -> None:
    from jlm_tpu_torch.parallel.mesh import multihost_init

    with open(os.path.join(out_dir, "call.pkl"), "rb") as f:
        fn, args = pickle.load(f)
    torch.set_num_threads(1)
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)  # before any allocation on the card
    multihost_init(init_method, world, rank, dev)
    try:
        out = fn(dev, *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world: int, device="cuda", args: Sequence[Any] = ()) -> List[Any]:
    """Run ``fn(device, *args)`` in ``world`` new processes (start method
    ``spawn``), one rank each, in a process group set up through a
    ``file://`` rendezvous in a fresh temporary directory, over the
    backend ``mesh.backend_for`` picks; returns each
    rank's return value (pickled back), in rank order.  ``device``
    defaults to the card (rank r on ``cuda:(r % device_count)``; raises
    without a GPU), ``"cpu"`` runs the world on the CPU.  A rank that
    raises makes ``spawn`` raise here and stops the others.  ``fn`` must
    be importable by name from a module (a child imports its module)."""
    from jlm_tpu_torch.models.params import resolve_device

    resolve_device(device)  # no GPU for a CUDA world: raise before any rank starts
    out_dir = tempfile.mkdtemp(prefix="jlm_world_")
    try:
        init = "file://" + os.path.join(out_dir, "rendezvous")
        # the call goes through a file: a child reads its start-up pipe
        # only once it has imported torch, so large arguments sent there
        # would start the ranks one after another
        with open(os.path.join(out_dir, "call.pkl"), "wb") as f:
            pickle.dump((fn, tuple(args)), f)
        torch.multiprocessing.spawn(
            _entry, args=(world, device, init, out_dir),
            nprocs=world, join=True, start_method="spawn")
        out = []
        for r in range(world):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
