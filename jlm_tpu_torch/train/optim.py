"""The reference trainer's optax chain as plain functions on tensors.

Counterpart of ``make_optimizer`` (``jlm_tpu/train/trainer.py``):
``clip_by_global_norm(max_grad_norm)`` then Adam (b1 0.9, b2 0.999,
eps 1e-8, bias-corrected) or SGD, with the learning rate passed in per
step (the reference injects it per epoch), and, for
``grad_accum_steps = k > 1``, ``optax.MultiSteps``: the running mean of k
microbatch gradients goes through the chain every k-th call, and the
calls between leave the parameters and the Adam moments alone.

Parameters and state are dictionaries keyed by the checkpoint's flat
parameter paths (``lstm/0/W``); updates are in place.  Each step follows
optax's arithmetic in the same order, so a run matches the reference to
fp32 summation order.

Adam on CUDA leaves runs the clip and the update as two kernel launches
over every leaf (:mod:`jlm_tpu_torch.ops.adam`): the global norm
(``norm_fn``'s where given), then one pass that clips, updates the moments
and moves the parameters, with the plain functions' arithmetic on the
card.  CPU tensors, SGD and the accumulation's running mean take the plain
functions below.  While the tracer is on, every call counts one
``optim.kernel_calls`` or ``optim.plain_calls`` by the path its update
takes (:mod:`jlm_tpu_torch.utils.profiling`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch

from jlm_tpu_torch.config import Config
from jlm_tpu_torch.ops import adam as adam_kernels
from jlm_tpu_torch.utils import profiling

B1, B2, EPS = 0.9, 0.999, 1e-8

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass
class OptState:
    """Adam's ``count``, ``mu`` and ``nu`` (empty for SGD) and the
    accumulator of ``MultiSteps`` (empty without accumulation)."""

    count: int
    mu: Tensors
    nu: Tensors
    acc: Tensors
    mini_step: int = 0


def init_state(config: Config, params: Tensors) -> OptState:
    def zeros(on: bool) -> Tensors:
        return {k: torch.zeros_like(p) for k, p in params.items()} if on else {}

    adam = config.optimizer == "adam"
    return OptState(count=0, mu=zeros(adam), nu=zeros(adam),
                    acc=zeros(config.grad_accum_steps > 1))


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every leaf, as ``optax.global_norm``."""
    return torch.sqrt(sum((g.float() ** 2).sum() for g in grads))


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        norm: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """As ``optax.clip_by_global_norm``: unchanged when ``norm < max_norm``,
    otherwise ``g / norm * max_norm`` (no epsilon added to the norm);
    ``norm`` defaults to :func:`global_norm` of ``grads``."""
    norm = global_norm(grads) if norm is None else norm
    keep = norm < max_norm
    return [torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm) for g in grads]


def _adam(grads: List[torch.Tensor], keys: List[str], state: OptState,
          lr: float) -> List[torch.Tensor]:
    state.count += 1
    bc1, bc2 = 1.0 - B1 ** state.count, 1.0 - B2 ** state.count
    updates = []
    for k, g in zip(keys, grads):
        mu = state.mu[k].mul_(B1).add_((1 - B1) * g)
        nu = state.nu[k].mul_(B2).add_((1 - B2) * (g * g))
        updates.append((mu / bc1) / (torch.sqrt(nu / bc2) + EPS) * -lr)
    return updates


@torch.no_grad()
def apply_gradients(params: Tensors, grads: Tensors, state: OptState,
                    config: Config, lr: float,
                    norm_fn: Optional[Callable[[Tensors], torch.Tensor]] = None) -> None:
    """One optimizer call: accumulate, and on an update step clip, scale
    and add the updates to ``params`` in place.  ``norm_fn(grads)`` gives
    the clip's global norm where ``params`` are one rank's shards of a
    larger tree (``parallel.train_step.global_norm``)."""
    keys = sorted(params)  # the reference's leaf order (sorted dict keys)
    kernel = config.optimizer == "adam" and params[keys[0]].is_cuda
    profiling.count("optim.kernel_calls" if kernel else "optim.plain_calls", 1)
    k_acc = config.grad_accum_steps
    if k_acc > 1:
        n = state.mini_step
        for k in keys:
            state.acc[k] += (grads[k] - state.acc[k]) / (n + 1)
        if n + 1 < k_acc:
            state.mini_step = n + 1
            return
        grads = state.acc
    g = [grads[k] for k in keys]
    norm = None if norm_fn is None else norm_fn(grads)
    if kernel:
        norm = adam_kernels.sumsq_norm(g) if norm is None else norm
        state.count += 1
        adam_kernels.adam_clip([params[k] for k in keys], g, [state.mu[k] for k in keys],
                               [state.nu[k] for k in keys], norm, count=state.count, lr=lr,
                               max_norm=config.max_grad_norm, b1=B1, b2=B2, eps=EPS)
    else:
        g = clip_by_global_norm(g, config.max_grad_norm, norm)
        if config.optimizer == "adam":
            updates = _adam(g, keys, state, lr)
        else:
            updates = [gi * -lr for gi in g]
        for k, u in zip(keys, updates):
            params[k] += u
    if k_acc > 1:
        state.acc = {k: torch.zeros_like(v) for k, v in state.acc.items()}
        state.mini_step = 0
