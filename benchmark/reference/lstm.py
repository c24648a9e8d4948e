"""Plain PyTorch LSTM language model: the ``lstm`` family's reference.

Written from the model's equations, independent of the program: an
embedding lookup, L LSTM cells over ``z = [x; h] W + b`` split into gates
``i, j, f, o`` (``c' = sigmoid(f + forget_bias) c + sigmoid(i) tanh(j)``,
``h' = sigmoid(o) tanh(c')``), then the head (full, or D-softmax prefix
blocks ``h[:, :d_k] W_k + b_k`` in vocabulary order) and a max-subtracted
log-softmax.  Everything in fp32 with TF32 off.

``operand`` rounds the activations of every product before it (the control
runs the reference one precision lower: fp8 activations); None keeps fp32.

``reference_steps`` trains it: the LSTM stepped in a Python loop over the
window, the full-softmax cross-entropy over materialised logits, the state
carried between windows, detached; ``reference/train.py`` does the rest.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

from benchmark.reference.precision import Rounding, fp32_products
from benchmark.reference.train import adam_steps

State = Tuple[torch.Tensor, torch.Tensor]  # (c, h), each [L, rows, H]


class RefLM:
    """``params``: the fp32 tree (``embedding``, ``lstm`` list of ``W``/``b``,
    ``head`` ``W``/``b`` or ``blocks``); ``model``: the configuration's
    ``model`` section."""

    def __init__(self, params: Dict[str, Any], model: Dict[str, Any],
                 operand: Rounding = None):
        fp32_products()
        self.p = params
        self.model = model
        self.rnd = operand or (lambda t: t)

    def initial_state(self, rows: int, device) -> State:
        L, H = self.model["num_layers"], self.model["hidden_size"]
        z = torch.zeros((L, rows, H), dtype=torch.float32, device=device)
        return z, z.clone()

    def select(self, states: Sequence[State], pos: torch.Tensor, rows: torch.Tensor) -> State:
        """The state whose row k is row ``rows[k]`` of ``states[pos[k]]``."""
        flat = pos * states[0][0].shape[1] + rows
        return (torch.cat([c for c, _ in states], dim=1)[:, flat],
                torch.cat([h for _, h in states], dim=1)[:, flat])

    def cell(self, x: torch.Tensor, c: torch.Tensor, h: torch.Tensor, layer: Dict[str, Any]):
        H = h.shape[-1]
        z = self.rnd(torch.cat([x, h], dim=-1)) @ layer["W"] + layer["b"]
        i, j, f, o = z[..., :H], z[..., H:2 * H], z[..., 2 * H:3 * H], z[..., 3 * H:]
        c2 = torch.sigmoid(f + self.model["forget_bias"]) * c + torch.sigmoid(i) * torch.tanh(j)
        return c2, torch.sigmoid(o) * torch.tanh(c2)

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        head = self.p["head"]
        h = self.rnd(h)
        if "blocks" in head:
            dims = self.model["dsoftmax"]["block_dims"]
            return torch.cat([h[:, :d] @ blk["W"] + blk["b"]
                              for d, blk in zip(dims, head["blocks"])], dim=1)
        return h @ head["W"] + head["b"]

    def step(self, words: torch.Tensor, state: State):
        """Feed ``words [R]``: ``(logp [R, V], (c, h) [L, R, H])``."""
        c, h = state
        x = self.p["embedding"][words]
        cs, hs = [], []
        for l, layer in enumerate(self.p["lstm"]):
            cl, hl = self.cell(x, c[l], h[l], layer)
            cs.append(cl)
            hs.append(hl)
            x = hl
        return torch.log_softmax(self.logits(x), dim=-1), (torch.stack(cs), torch.stack(hs))


def reference_steps(init: Dict[str, torch.Tensor], model: Dict[str, Any],
                    train: Dict[str, Any], ids: np.ndarray, tp: Dict[str, Any], device,
                    scan_operand: Rounding = None, ce_operand: Rounding = None,
                    half_batch: bool = False) -> Dict[str, Any]:
    """:func:`reference.train.adam_steps` over the LSTM's loss.
    ``scan_operand`` and ``ce_operand`` round the products' operands of the
    cell and of the head (the control: one precision lower); ``half_batch``
    takes the loss over the first half of the rows (a planted fault)."""
    if model["head"] != "full":
        raise ValueError("the reference trains the full head only")
    rs = scan_operand or (lambda t: t)
    rc = ce_operand or (lambda t: t)
    L, H, fb = model["num_layers"], model["hidden_size"], model["forget_bias"]
    B, T = tp["batch"], tp["window"]
    c = [torch.zeros((B, H), device=device) for _ in range(L)]
    h = [torch.zeros((B, H), device=device) for _ in range(L)]

    def loss(p: Dict[str, torch.Tensor], x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
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
        return torch.nn.functional.cross_entropy(logits, y[:rows].reshape(-1))

    return adam_steps(init, loss, train, ids, tp, device)
