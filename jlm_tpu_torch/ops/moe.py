"""A routed expert layer: the router, the dispatch by expert, the grouped
expert products and a combine in a fixed order.

``route`` is the published gate (DeepSeek-V2's ``MoEGate`` with
``scoring_func="softmax"`` and ``topk_method="greedy"``): logits in fp32
(``x.float() @ W_g.float()``), a softmax over the experts, the top ``k``
(sorted, so the picks' order repeats), the weights renormalised only with
``norm_topk_prob``, else scaled by ``routed_scaling_factor``.

``experts`` dispatches the ``R * k`` (row, pick) pairs by expert with one
stable sort (each expert's rows in row order), runs every expert's
SiLU-gated MLP over its contiguous range of the sorted rows in two grouped
products (gate and up together, then down), puts the outputs back in
(row, pick) order and sums each row's ``k`` outputs times their weights in
fp32 over the picks' axis (no atomics: the order of every sum is fixed, so
runs repeat bit for bit).  On the card in bf16 the grouped products are
``torch._grouped_mm`` over the experts' row offsets (computed on the device:
no wait for the host); elsewhere one ``torch.mm`` per expert over its range.
Every row is dispatched, live or not.
"""

from __future__ import annotations

from typing import Tuple

import torch


def route(x: torch.Tensor, W_g: torch.Tensor, k: int, norm_topk_prob: bool = False,
          scaling: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(weights [R, k] fp32, expert ids [R, k])`` of rows ``x [R, D]``
    under the gate ``W_g [D, E]``."""
    scores = torch.softmax(x.float() @ W_g.float(), dim=-1)
    w, idx = torch.topk(scores, k, dim=-1, sorted=True)
    if norm_topk_prob and k > 1:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    else:
        w = w * scaling
    return w, idx


def grouped_mm(x: torch.Tensor, W: torch.Tensor, counts: torch.Tensor,
               offs: torch.Tensor) -> torch.Tensor:
    """``x [M, K]`` sorted by group (group g's rows ``counts[g]``, ending at
    ``offs[g]``) times each group's ``W [G, K, N]``: ``[M, N]``."""
    if x.is_cuda and x.dtype == torch.bfloat16:
        return torch._grouped_mm(x, W, offs=offs)
    out = x.new_empty((x.shape[0], W.shape[2]))
    start = 0
    for g, n in enumerate(counts.tolist()):
        if n:
            torch.mm(x[start:start + n], W[g], out=out[start:start + n])
        start += n
    return out


def experts(x: torch.Tensor, w: torch.Tensor, idx: torch.Tensor, gate_up: torch.Tensor,
            down: torch.Tensor) -> torch.Tensor:
    """``sum_i w_i E_{idx_i}(x)`` per row, ``[R, D]`` in ``x``'s dtype:
    ``gate_up [E, D, 2I]`` (gate columns first), ``down [E, I, D]``."""
    R, k = idx.shape
    E, _, I2 = gate_up.shape
    flat = idx.reshape(-1)
    order = torch.sort(flat, stable=True).indices  # pairs grouped by expert
    counts = torch.bincount(flat, minlength=E)
    offs = torch.cumsum(counts, 0).to(torch.int32)
    h = grouped_mm(x[order // k], gate_up, counts, offs)
    a = torch.nn.functional.silu(h[:, :I2 // 2]) * h[:, I2 // 2:]
    y = grouped_mm(a, down, counts, offs)
    back = torch.empty_like(y)
    back[order] = y  # (row, pick) order
    return (back.reshape(R, k, -1).float() * w[..., None]).sum(dim=1).to(x.dtype)


def mlp(x: torch.Tensor, gate_up: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    """A SiLU-gated MLP ``down(silu(gate x) * up x)``: ``gate_up [D, 2I]``
    (gate columns first), ``down [I, D]``."""
    h = x @ gate_up
    half = h.shape[1] // 2
    return (torch.nn.functional.silu(h[:, :half]) * h[:, half:]) @ down
