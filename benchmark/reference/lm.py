"""Plain PyTorch LSTM language model: the benchmark's reference.

Written from the model's equations, independent of the program: an
embedding lookup, L LSTM cells over ``z = [x; h] W + b`` split into gates
``i, j, f, o`` (``c' = sigmoid(f + forget_bias) c + sigmoid(i) tanh(j)``,
``h' = sigmoid(o) tanh(c')``), then the head (full, or D-softmax prefix
blocks ``h[:, :d_k] W_k + b_k`` in vocabulary order) and a max-subtracted
log-softmax.  Everything in fp32 with TF32 off.

``operand`` rounds the activations of every product before it (the control
runs the reference one precision lower: fp8 activations); None keeps fp32.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

Rounding = Optional[Callable[[torch.Tensor], torch.Tensor]]


def fp32_products() -> None:
    """True fp32 products on the card: TF32 would keep ~3 decimal digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_to(dtype) -> Callable[[torch.Tensor], torch.Tensor]:
    """Operands rounded to ``dtype`` and back to fp32 (products of rounded
    operands summed in fp32, as a tensor core of that type does).  The
    rounding passes gradients through unchanged: a cast's own backward
    would round them to ``dtype`` as well, and fp8 has no range for them."""
    return lambda t: t + (t.to(dtype).float() - t).detach()


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

    def initial_state(self, rows: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
        L, H = self.model["num_layers"], self.model["hidden_size"]
        z = torch.zeros((L, rows, H), dtype=torch.float32, device=device)
        return z, z.clone()

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

    def step(self, words: torch.Tensor, state):
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
