"""Adam's global-norm clip and update over every leaf, in two launches.

Replaces no TPU kernel: the reference's optax chain is elementwise code
that XLA fuses.  On the card the optimizer's plain version
(:mod:`jlm_tpu_torch.train.optim`) is one PyTorch pass over device memory
per product, quotient and sum of every leaf, about 43 in all; these two
kernels (``csrc/adam.cu``) read each gradient twice and each parameter and
moment once: 32 bytes an element.

- :func:`sumsq_norm`: ``sqrt`` of the sum of every leaf's squares, a 0-d
  fp32 tensor on the device (``sumsq_kernel``: one partial a block, summed
  in a fixed order by the last block: a rerun gives the same bits).
- :func:`adam_clip`: the clip on that norm, Adam's moments and the update,
  written to the parameters and moments in place (``adam_clip_kernel``),
  with the plain version's arithmetic and roundings on the card: given the
  same norm, the same bits.

Both walk one table of chunks, ``(leaf, start, count)`` rows of at most
``CHUNK`` elements (:func:`chunk_table`), kept on the device per set of
leaf sizes; the leaves' pointers go by value with each launch, so the
trainer's tree stays as it is and a new gradient buffer costs no copy.
The wrappers take fp32 contiguous CUDA leaves and raise on any other
(there is no plain fallback here: ``optim.apply_gradients`` picks the
plain version for CPU tensors).  Launches go on PyTorch's current stream;
the norm's scratch is one per device, so two :func:`sumsq_norm` launches
must not run at once on two streams.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch.autograd.graph import increment_version

from jlm_tpu_torch.ops import _build

CHUNK = 4096       # elements a chunk (a multiple of 4: float4 loads stay aligned)
MAX_LEAVES = 96    # leaves a launch (their pointers ride in its parameters)
MAX_GRID = 4096    # partials of the norm's scratch (csrc/adam.cu)

_tables: Dict[Tuple[torch.device, Tuple[int, ...]], torch.Tensor] = {}
_scratch: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


def chunk_table(sizes: Sequence[int], chunk: int = CHUNK) -> np.ndarray:
    """int64 ``[n, 3]``: ``(leaf, start, count)`` for every chunk of at
    most ``chunk`` elements of every leaf in order (none for an empty one)."""
    rows = [np.zeros((0, 3), np.int64)]
    for leaf, n in enumerate(sizes):
        starts = np.arange(0, n, chunk, dtype=np.int64)
        rows.append(np.stack([np.full_like(starts, leaf), starts,
                              np.minimum(chunk, n - starts)], axis=1))
    return np.concatenate(rows)


def _check_leaves(name: str, *groups: Sequence[torch.Tensor]) -> None:
    """Raise unless every tensor is fp32, contiguous and on one CUDA
    device, and the groups (gradients, parameters, moments) match leaf for
    leaf in size."""
    first = groups[0]
    if not 1 <= len(first) <= MAX_LEAVES:
        raise ValueError(f"{name}: 1 to {MAX_LEAVES} leaves, got {len(first)}")
    dev = first[0].device
    for group in groups:
        if len(group) != len(first):
            raise ValueError(f"{name}: {len(group)} leaves against {len(first)}")
        for t, ref in zip(group, first):
            if t.dtype != torch.float32:
                raise ValueError(f"{name}: fp32 leaves only, got {t.dtype}")
            if not t.is_contiguous():
                raise ValueError(f"{name}: contiguous leaves only, got strides {t.stride()}")
            if t.numel() != ref.numel():
                raise ValueError(f"{name}: leaf of {t.numel()} elements against {ref.numel()}")
    for group in groups:
        for t in group:
            if t.device.type != "cuda" or t.device != dev:
                raise ValueError(f"{name}: leaves on one CUDA device, got {t.device}")


def _table(dev: torch.device, leaves: List[torch.Tensor]) -> torch.Tensor:
    sizes = tuple(t.numel() for t in leaves)
    table = _tables.get((dev, sizes))
    if table is None:
        table = _tables[dev, sizes] = torch.from_numpy(chunk_table(sizes)).to(dev)
    return table


def _ptrs(leaves: List[torch.Tensor]):
    return (ctypes.c_void_p * len(leaves))(*[t.data_ptr() for t in leaves])


def sumsq_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum of every leaf's squares)`` as a 0-d fp32 tensor on the
    leaves' device, in one launch.  ``sumsq_norm.launches`` counts them."""
    _check_leaves("sumsq_norm", grads)
    dev = grads[0].device
    table = _table(dev, grads)
    scratch = _scratch.get(dev)
    if scratch is None:  # the partials, and the ticket each launch leaves at 0
        scratch = _scratch[dev] = (torch.empty(MAX_GRID, dtype=torch.float32, device=dev),
                                   torch.zeros(1, dtype=torch.int32, device=dev))
    norm = torch.empty((), dtype=torch.float32, device=dev)
    err = _build.lib().jlm_adam_sumsq(
        _ptrs(grads), len(grads), table.data_ptr(), table.shape[0], scratch[0].data_ptr(),
        scratch[1].data_ptr(), norm.data_ptr(), _build.stream_ptr(norm))
    _build.check(err, "sumsq kernel")
    sumsq_norm.launches += 1
    return norm


def adam_scalars(count: int, lr: float, max_norm: float, b1: float, b2: float,
                 eps: float) -> List[float]:
    """The kernel's scalars as the plain version rounds them on the card:
    each Python scalar to fp32, and ``x / (1 - b**count)`` as ``x`` times
    the divisor's reciprocal, taken in double and rounded to fp32: so
    PyTorch divides a CUDA tensor by a Python scalar (read on the H100 with
    torch 2.11: ``mu / bc`` equals ``mu * float(1 / bc)`` on every element,
    and differs from ``mu * (1 / f32(bc))`` in fp32 on 73% of them at
    count 1)."""
    f = np.float32
    bc1, bc2 = 1.0 - b1 ** count, 1.0 - b2 ** count
    return [float(v) for v in (f(max_norm), f(b1), f(1 - b1), f(b2), f(1 - b2),
                               f(1.0 / bc1), f(1.0 / bc2), f(eps), f(-lr))]


def adam_clip(params: List[torch.Tensor], grads: List[torch.Tensor], mu: List[torch.Tensor],
              nu: List[torch.Tensor], norm: torch.Tensor, *, count: int, lr: float,
              max_norm: float, b1: float, b2: float, eps: float) -> None:
    """One launch: every gradient clipped on the global ``norm`` (a 0-d
    fp32 tensor on the device: kept below ``max_norm``, else scaled by
    ``max_norm / norm``), Adam's moments ``mu`` and ``nu`` updated and
    ``params`` moved, in place (their version counters moved too);
    ``count`` is Adam's step count after this step.
    ``adam_clip.launches`` counts launches."""
    _check_leaves("adam_clip", grads, params, mu, nu)
    dev = grads[0].device
    if norm.dtype != torch.float32 or norm.numel() != 1 or norm.device != dev:
        raise ValueError(f"adam_clip: the norm must be one fp32 value on {dev}")
    table = _table(dev, grads)
    err = _build.lib().jlm_adam_clip(
        _ptrs(grads), _ptrs(params), _ptrs(mu), _ptrs(nu), len(grads), table.data_ptr(),
        table.shape[0], norm.data_ptr(), *adam_scalars(count, lr, max_norm, b1, b2, eps),
        _build.stream_ptr(norm))
    _build.check(err, "adam_clip kernel")
    adam_clip.launches += 1
    for t in (*params, *mu, *nu):  # written in place, as an in-place op would note
        increment_version(t)


sumsq_norm.launches = 0
adam_clip.launches = 0
