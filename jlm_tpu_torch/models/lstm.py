"""LSTM LM core as plain functions on tensors.

Counterpart of :mod:`jlm_tpu.models.lstm`: embedding (per-row int8
dequant), one fused-cell step through all layers (gate order i, j, f, o;
``config.forget_bias`` applied at run time), the output head (full or
D-softmax, prefix and disjoint), max-subtracted fp32 log-softmax, the full
LM step, ``forward_hidden``, the training path's loop over a BPTT window,
and ``forward_hidden_scan``, the same window through the fused scan
kernels of :mod:`jlm_tpu_torch.ops.lstm_scan`.  The math runs in the dtype
of the parameters it is given; a caller that needs true fp32 on the card
turns TF32 off (the engine's parity forward does).

The decode engine serves a D-softmax head through these functions (its
fp32 parity forward) and through the kernel forward, whose decode-side
head prep (``build_decode_head``) transposes the blocks.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from jlm_tpu_torch.config import Config
from jlm_tpu_torch.ops.lstm_scan import lstm_scan

State = Tuple[torch.Tensor, torch.Tensor]  # (c, h) each [L, B, H]


def _w(leaf) -> torch.Tensor:
    """An (optionally int8-quantized, per output column) weight as fp32."""
    if isinstance(leaf, dict) and "q" in leaf:
        return leaf["q"].float() * leaf["scale"][None, :]
    return leaf


def embed(params: Dict[str, Any], word_ids: torch.Tensor) -> torch.Tensor:
    """Embedding row gather with per-row dequant for int8 tables."""
    emb = params["embedding"]
    if isinstance(emb, dict) and "q" in emb:
        return emb["q"][word_ids].float() * emb["scale"][word_ids][..., None]
    return emb[word_ids]


def initial_state(config: Config, batch: int, device) -> State:
    shape = (config.num_layers, batch, config.hidden_size)
    return (torch.zeros(shape, dtype=torch.float32, device=device),
            torch.zeros(shape, dtype=torch.float32, device=device))


def lstm_step(params: Dict[str, Any], config: Config, x: torch.Tensor,
              state: State) -> Tuple[torch.Tensor, State]:
    """One step through all layers; returns ``(h_top [B, H], state')``."""
    c, h = state
    new_c, new_h = [], []
    for l, layer in enumerate(params["lstm"]):
        z = torch.cat([x, h[l]], dim=1) @ _w(layer["W"]) + layer["b"]
        i, j, f, o = z.chunk(4, dim=1)
        cl = torch.sigmoid(f + config.forget_bias) * c[l] + torch.sigmoid(i) * torch.tanh(j)
        hl = torch.sigmoid(o) * torch.tanh(cl)
        new_c.append(cl)
        new_h.append(hl)
        x = hl
    return x, (torch.stack(new_c), torch.stack(new_h))


def head_logits(params: Dict[str, Any], config: Config,
                h_top: torch.Tensor) -> torch.Tensor:
    """Output projection -> logits ``[B, V]``; full or D-softmax head.

    Block k of a D-softmax head projects ``h[:, :d_k]`` (prefix mode) or
    its own disjoint segment of ``h`` (disjoint mode) onto its ``s_k``
    words; the blocks' logits are concatenated in vocab order."""
    head = params["head"]
    if "blocks" in head:
        ds = config.dsoftmax
        outs, offset = [], 0
        for k, blk in enumerate(head["blocks"]):
            d = ds.block_dims[k]
            start = 0 if ds.mode == "prefix" else offset
            offset += 0 if ds.mode == "prefix" else d
            outs.append(h_top[:, start:start + d] @ _w(blk["W"]) + blk["b"])
        return torch.cat(outs, dim=1)
    return h_top @ _w(head["W"]) + head["b"]


def log_softmax(logits: torch.Tensor) -> torch.Tensor:
    """Max-subtracted fp32 log-softmax — the frozen parity numeric rule."""
    logits = logits.float()
    m = logits.amax(dim=-1, keepdim=True)
    return logits - (m + torch.log(torch.exp(logits - m).sum(dim=-1, keepdim=True)))


def step_logp(params: Dict[str, Any], config: Config, word_ids: torch.Tensor,
              state: State) -> Tuple[torch.Tensor, State]:
    """Full LM step: ids ``[B]`` -> ``(logp [B, V], state')``."""
    h_top, state = lstm_step(params, config, embed(params, word_ids), state)
    return log_softmax(head_logits(params, config, h_top)), state


def forward_hidden(params: Dict[str, Any], config: Config, ids: torch.Tensor,
                   state: State, remat: bool = False) -> Tuple[torch.Tensor, State]:
    """Run the LSTM over a window: ids ``[B, T]`` -> ``(hs [B, T, H], state')``.

    The training path's recurrent core (the caller applies the head and
    loss).  ``remat=True`` checkpoints each step: the backward recomputes
    the step's gates instead of keeping them, trading FLOPs for activation
    memory, with the same gradients."""
    xs = embed(params, ids)  # [B, T, E]
    hs = []
    for t in range(ids.shape[1]):
        if remat:
            h_top, state = checkpoint(lstm_step, params, config, xs[:, t], state,
                                      use_reentrant=False)
        else:
            h_top, state = lstm_step(params, config, xs[:, t], state)
        hs.append(h_top)
    return torch.stack(hs, dim=1), state


def forward_hidden_scan(params: Dict[str, Any], config: Config, ids: torch.Tensor,
                        state: State, compute_dtype=torch.float32
                        ) -> Tuple[torch.Tensor, State]:
    """:func:`forward_hidden` through the fused scan: one forward launch per
    layer over the whole window (and one backward launch per layer), the
    ``(c, h)`` carry kept on chip.  ``compute_dtype`` rounds the products'
    operands; hs and the state are fp32.  Counterpart of
    ``forward_hidden_pallas``."""
    c0, h0 = state
    xs = embed(params, ids)
    cs, hs_f = [], []
    for l, layer in enumerate(params["lstm"]):
        xs, c_f, h_f = lstm_scan(xs, _w(layer["W"]), layer["b"], c0[l], h0[l],
                                 config.forget_bias, compute_dtype)
        cs.append(c_f)
        hs_f.append(h_f)
    return xs, (torch.stack(cs), torch.stack(hs_f))
