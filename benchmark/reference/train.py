"""Reference training steps and the comparison that judges the program's.

Plain PyTorch in fp32 (TF32 off), independent of the program: the LSTM
stepped in a Python loop over the window, the full-softmax cross-entropy
over materialised logits, autograd, the clip by the global norm
(``optax.clip_by_global_norm``: unchanged under the limit, else scaled to
it) and Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected), over the same
truncated-BPTT windows as the trainer (the id stream cut to ``[batch, -1]``,
windows of ``window`` steps, the state carried between windows, detached).

``scan_operand`` and ``ce_operand`` round the products' operands of the
cell and of the head (the control: one precision lower); ``half_batch``
takes the loss over the first half of the rows (a planted fault).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from benchmark.reference.lm import Rounding, fp32_products

B1, B2, EPS = 0.9, 0.999, 1e-8


def _windows(ids: np.ndarray, batch: int, window: int):
    n = (len(ids) - 1) // batch * batch
    xs = ids[:n].reshape(batch, -1)
    ys = ids[1:n + 1].reshape(batch, -1)
    for start in range(0, xs.shape[1] - window + 1, window):
        yield xs[:, start:start + window], ys[:, start:start + window]


def reference_steps(init: Dict[str, torch.Tensor], model: Dict[str, Any],
                    train: Dict[str, Any], ids: np.ndarray, tp: Dict[str, Any], device,
                    scan_operand: Rounding = None, ce_operand: Rounding = None,
                    half_batch: bool = False) -> Dict[str, Any]:
    """Losses of every window of ``ids``, the first step's clipped gradient
    and each leaf's change after the last step."""
    fp32_products()
    if model["head"] != "full":
        raise ValueError("the reference trains the full head only")
    rs = scan_operand or (lambda t: t)
    rc = ce_operand or (lambda t: t)
    p = {k: v.detach().clone().float().requires_grad_(True) for k, v in init.items()}
    keys = sorted(p)
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    L, H, fb = model["num_layers"], model["hidden_size"], model["forget_bias"]
    B, T = tp["batch"], tp["window"]
    c = [torch.zeros((B, H), device=device) for _ in range(L)]
    h = [torch.zeros((B, H), device=device) for _ in range(L)]
    losses: List[float] = []
    grad1: Optional[Dict[str, torch.Tensor]] = None
    for count, (x, y) in enumerate(_windows(ids, B, T), start=1):
        x = torch.from_numpy(np.ascontiguousarray(x)).to(device)
        y = torch.from_numpy(np.ascontiguousarray(y)).to(device)
        seq = p["embedding"][x]  # [B, T, E]
        for l in range(L):
            W, b = p[f"lstm/{l}/W"], p[f"lstm/{l}/b"]
            outs = []
            cl, hl = c[l], h[l]
            for t in range(T):
                z = rs(torch.cat([seq[:, t], hl], dim=1)) @ rs(W) + b
                i, j, f, o = z[:, :H], z[:, H:2 * H], z[:, 2 * H:3 * H], z[:, 3 * H:]
                cl = torch.sigmoid(f + fb) * cl + torch.sigmoid(i) * torch.tanh(j)
                hl = torch.sigmoid(o) * torch.tanh(cl)
                outs.append(hl)
            c[l], h[l] = cl.detach(), hl.detach()
            seq = torch.stack(outs, dim=1)
        rows = B // 2 if half_batch else B
        hs = seq[:rows].reshape(rows * T, H)
        logits = rc(hs) @ rc(p["head/W"]) + p["head/b"]
        loss = torch.nn.functional.cross_entropy(logits, y[:rows].reshape(-1))
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
