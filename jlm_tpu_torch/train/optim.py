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
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from jlm_tpu_torch.config import Config

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


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    """As ``optax.clip_by_global_norm``: unchanged when ``norm < max_norm``,
    otherwise ``g / norm * max_norm`` (no epsilon added to the norm)."""
    norm = global_norm(grads)
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
                    config: Config, lr: float) -> None:
    """One optimizer call: accumulate, and on an update step clip, scale
    and add the updates to ``params`` in place."""
    keys = sorted(params)  # the reference's leaf order (sorted dict keys)
    k_acc = config.grad_accum_steps
    if k_acc > 1:
        n = state.mini_step
        for k in keys:
            state.acc[k] += (grads[k] - state.acc[k]) / (n + 1)
        if n + 1 < k_acc:
            state.mini_step = n + 1
            return
        grads = state.acc
    g = clip_by_global_norm([grads[k] for k in keys], config.max_grad_norm)
    if config.optimizer == "adam":
        updates = _adam(g, keys, state, lr)
    else:
        updates = [gi * -lr for gi in g]
    for k, u in zip(keys, updates):
        params[k] += u
    if k_acc > 1:
        state.acc = {k: torch.zeros_like(v) for k, v in state.acc.items()}
        state.mini_step = 0
