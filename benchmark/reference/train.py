"""Reference training steps and the comparison that judges the program's.

Plain PyTorch in fp32 (TF32 off), independent of the program: the model
family's loss of each window (``loss_fn``), autograd, the clip by the global
norm (``optax.clip_by_global_norm``: unchanged under the limit, else scaled
to it) and Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected), over the same
truncated-BPTT windows as the trainer (the id stream cut to ``[batch, -1]``,
windows of ``window`` steps; a loss that carries state between windows
keeps it itself).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from benchmark.reference.precision import fp32_products

B1, B2, EPS = 0.9, 0.999, 1e-8

Loss = Callable[[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor], torch.Tensor]


def _windows(ids: np.ndarray, batch: int, window: int):
    n = (len(ids) - 1) // batch * batch
    xs = ids[:n].reshape(batch, -1)
    ys = ids[1:n + 1].reshape(batch, -1)
    for start in range(0, xs.shape[1] - window + 1, window):
        yield xs[:, start:start + window], ys[:, start:start + window]


def adam_steps(init: Dict[str, torch.Tensor], loss_fn: Loss, train: Dict[str, Any],
               ids: np.ndarray, tp: Dict[str, Any], device) -> Dict[str, Any]:
    """Losses of every window of ``ids`` (``loss_fn(params, x, y)``, the
    parameters by ``a/0/b`` name), the first step's clipped gradient and each
    leaf's change after the last step."""
    fp32_products()
    p = {k: v.detach().clone().float().requires_grad_(True) for k, v in init.items()}
    keys = sorted(p)
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    losses: List[float] = []
    grad1: Optional[Dict[str, torch.Tensor]] = None
    for count, (x, y) in enumerate(_windows(ids, tp["batch"], tp["window"]), start=1):
        x = torch.from_numpy(np.ascontiguousarray(x)).to(device)
        y = torch.from_numpy(np.ascontiguousarray(y)).to(device)
        loss = loss_fn(p, x, y)
        grads = torch.autograd.grad(loss, [p[k] for k in keys])
        with torch.no_grad():
            norm = torch.sqrt(sum((g ** 2).sum() for g in grads))
            if float(norm) >= train["max_grad_norm"]:
                grads = [g / norm * train["max_grad_norm"] for g in grads]
            if grad1 is None:
                grad1 = {k: g.clone() for k, g in zip(keys, grads)}
            bc1, bc2 = 1 - B1 ** count, 1 - B2 ** count
            for k, g in zip(keys, grads):
                mu[k].mul_(B1).add_((1 - B1) * g)
                nu[k].mul_(B2).add_((1 - B2) * g * g)
                p[k] -= train["learning_rate"] * (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + EPS)
        losses.append(float(loss.detach()))
    return {"losses": losses, "grad1": grad1,
            "delta": {k: (p[k].detach() - init[k].float()) for k in keys}}


def _norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tree.items()}


def leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             keep: Optional[List[str]] = None) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    over the larger of that leaf's reference norm and the median leaf's."""
    pn, rn = _norms(prog), _norms(ref)
    med = float(np.median(list(rn.values())))
    return max(abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in (keep or list(rn)))


def compare_steps(losses: List[float], grad1: Dict[str, torch.Tensor],
                  delta: Dict[str, torch.Tensor], ref: Dict[str, Any]) -> Dict[str, float]:
    """``loss_gap``: the widest relative gap of a step's loss; ``grad_gap``:
    :func:`leaf_gap` of the first gradient; ``update_gap``: of each leaf's
    change after the set-up steps, over the leaves whose reference gradient
    is above a thousandth of the median leaf's (a leaf below moves by
    Adam's round-off alone)."""
    rl = ref["losses"]
    if len(losses) != len(rl):
        return {"loss_gap": float("inf"), "grad_gap": float("inf"), "update_gap": float("inf")}
    gn = _norms(ref["grad1"])
    med = float(np.median(list(gn.values())))
    keep = [k for k, v in gn.items() if v >= 1e-3 * med]
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, rl)),
            "grad_gap": leaf_gap(grad1, ref["grad1"]),
            "update_gap": leaf_gap(delta, ref["delta"], keep)}
