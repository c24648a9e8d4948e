"""The ``(data, vocab)`` and ``('seq',)`` layouts of ranks, and the
process-group bootstrap.

Counterpart of :mod:`jlm_tpu.parallel.mesh`.  JAX runs one process over
a device mesh; the port runs one process per rank on ``torch.distributed``,
and each rank holds only its own shard.  A :class:`Mesh` is this rank's
view of the layout: the world size, its ``(data, vocab)`` coordinates
(vocab minor, as ``make_mesh`` lays devices out), its device, and two
process subgroups: the ranks of its data row (``vocab_group``: the vocab
axis's collectives) and the ranks of its vocab column (``data_group``).
Every rank creates every subgroup, in the same order.  A
:class:`SeqMesh` is the one-axis layout of the time-block pipeline
(:mod:`jlm_tpu_torch.parallel.seq_pipeline`): rank ``p`` owns time block
``p`` of the BPTT window, and the seq group is the whole world.

The backend rule (:func:`backend_for`): ``gloo`` on the CPU; on the card
``nccl`` where every rank has a GPU of its own, else ``gloo`` (NCCL
refuses two ranks on one GPU).  :func:`multihost_init` logs it.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Any, Dict

import torch
import torch.distributed as dist

from jlm_tpu_torch.config import Config
from jlm_tpu_torch.models.params import resolve_device
from jlm_tpu_torch.parallel.comm import rank_device

DATA_AXIS = "data"
VOCAB_AXIS = "vocab"
SEQ_AXIS = "seq"


@dataclasses.dataclass
class Mesh:
    """This rank's place in a ``(data, vocab)`` layout of ranks.

    Rank ``r`` sits at ``(r // vocab, r % vocab)``.  ``vocab_group`` holds
    the ``vocab`` ranks of its data row, ``data_group`` the ``data`` ranks
    of its vocab column; ``None`` on a one-rank mesh, where every
    collective is the identity."""

    data: int
    vocab: int
    rank: int
    device: torch.device
    vocab_group: Any = None
    data_group: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, VOCAB_AXIS: self.vocab}

    @property
    def world(self) -> int:
        return self.data * self.vocab

    @property
    def data_index(self) -> int:
        return self.rank // self.vocab

    @property
    def vocab_index(self) -> int:
        return self.rank % self.vocab


@dataclasses.dataclass
class SeqMesh:
    """This rank's place in a ``('seq',)`` layout: stage ``rank`` of
    ``seq`` pipeline stages, each the owner of one time block.  ``group``
    is the seq group (``None``: the whole world, or a one-rank mesh)."""

    seq: int
    rank: int
    device: torch.device
    group: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        return {SEQ_AXIS: self.seq}

    @property
    def world(self) -> int:
        return self.seq


def mesh_device(mesh, device) -> torch.device:
    """The device of a model object built on ``mesh``: the mesh's.  Raises
    if ``device`` names another (a different type, or another index):
    nothing runs on a device its caller did not ask for."""
    want = torch.device(device)
    have = mesh.device
    if want.type != have.type or (want.index is not None and want.index != have.index):
        raise ValueError(f"device {str(want)!r} conflicts with the mesh's device "
                         f"{str(have)!r}: pass the mesh's device, or build the mesh on "
                         f"{str(want)!r}")
    return have


def backend_for(device, world: int) -> str:
    """``gloo`` on the CPU; on CUDA ``nccl`` when the host has a GPU for
    every rank, else ``gloo``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= world else "gloo"


def multihost_init(init_method: str, world_size: int, rank: int, device="cuda") -> str:
    """``init_process_group`` with an explicit ``init_method``
    (``file://...`` or ``tcp://host:port``); no-op for one process.
    ``device`` (this rank's) defaults to the card, as every entry point
    of the port (raises without a GPU); ``"cpu"`` picks ``gloo``.
    Returns the backend :func:`backend_for` picks, and logs it on rank 0.
    A collective that waits ten minutes raises (a rank that died)."""
    backend = backend_for(resolve_device(device), world_size)
    if world_size <= 1:
        return backend
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=datetime.timedelta(minutes=10))
    if rank == 0:
        print(f"torch.distributed: backend {backend}, world {world_size}, "
              f"device {device} (rule: gloo on the CPU; nccl when every rank has a GPU "
              "of its own, else gloo)", flush=True)
    return backend


def make_mesh(config: Config, device="cuda") -> Mesh:
    """This rank's ``(config.mesh_data, config.mesh_vocab)`` mesh.

    Needs a process group of exactly that world size (or none, for a
    one-rank mesh).  Creates the data-row and vocab-column subgroups;
    every rank must call it at the same point.  ``device`` defaults to
    the card, rank r's ``cuda:(r % device_count)`` (raises without a
    GPU); ``"cpu"`` keeps the rank on the CPU."""
    D, Vn = config.mesh_data, config.mesh_vocab
    n = D * Vn
    rank = dist.get_rank() if dist.is_initialized() else 0
    dev = rank_device(resolve_device(device), rank)
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(f"a ({D}, {Vn}) mesh needs a process group of {n} ranks: "
                               "call multihost_init (or parallel.comm.spawn) first")
        return Mesh(1, 1, 0, dev)
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"mesh ({D}, {Vn}) needs {n} ranks, the process group has {world}")
    mesh = Mesh(D, Vn, rank, dev)
    for d in range(D):  # one group a data row: the vocab axis
        g = dist.new_group([d * Vn + v for v in range(Vn)])
        if d == mesh.data_index:
            mesh.vocab_group = g
    for v in range(Vn):  # one group a vocab column: the data axis
        g = dist.new_group([d * Vn + v for d in range(D)])
        if v == mesh.vocab_index:
            mesh.data_group = g
    return mesh


def make_seq_mesh(config: Config, device="cuda") -> SeqMesh:
    """This rank's ``('seq',)`` mesh of ``config.mesh_seq`` stages.

    Needs a process group of exactly that world size (or none, for one
    stage); the seq group is the whole world.  ``device`` defaults to the
    card, rank r's ``cuda:(r % device_count)``; ``"cpu"`` keeps the rank
    on the CPU."""
    n = config.mesh_seq
    rank = dist.get_rank() if dist.is_initialized() else 0
    dev = rank_device(resolve_device(device), rank)
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(f"a seq mesh of {n} stages needs a process group of {n} ranks: "
                               "call multihost_init (or parallel.comm.spawn) first")
        return SeqMesh(1, 0, dev)
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"seq mesh of {n} stages needs {n} ranks, the process group has {world}")
    return SeqMesh(n, rank, dev)
