"""LSTM LM core as plain functions on tensors.

Counterpart of :mod:`jlm_tpu.models.lstm`: embedding (per-row int8
dequant), one fused-cell step through all layers (gate order i, j, f, o;
``config.forget_bias`` applied at run time), the output head (full or
D-softmax, prefix and disjoint), the lazy column scoring of the
per-keystroke decoders (``candidate_logits``, ``node_logits``),
max-subtracted fp32 log-softmax, the full LM step, ``forward_hidden``,
the training path's loop over a BPTT window, and
``forward_hidden_scan``, the same window through the fused scan kernels
of :mod:`jlm_tpu_torch.ops.lstm_scan`.  The math runs in the dtype of the
parameters it is given; a caller that needs true fp32 on the card turns
TF32 off (the engine's parity forward does).

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


def _block_spans(config: Config):
    """``(first column of h, width, first vocab id, words)`` of each block
    of a D-softmax head, in vocab order."""
    ds = config.dsoftmax
    spans, offset, base = [], 0, 0
    for d, size in zip(ds.block_dims, ds.block_sizes):
        spans.append((0 if ds.mode == "prefix" else offset, d, base, size))
        offset += 0 if ds.mode == "prefix" else d
        base += size
    return spans


def _cols(W, ids: torch.Tensor) -> torch.Tensor:
    """Output columns ``ids`` of a head weight as fp32 ``[d, n]``; an int8
    weight's columns are dequantized after the gather."""
    if isinstance(W, dict):
        return W["q"][:, ids].float() * W["scale"][ids][None, :]
    return W[:, ids]


def candidate_logits(params: Dict[str, Any], config: Config, h_top: torch.Tensor,
                     words: torch.Tensor) -> torch.Tensor:
    """Unnormalized logits of the vocab columns ``words [N]`` only:
    ``h_top [..., H]`` -> ``[..., N]``.  The lazy scoring of the incremental
    decoder: a gather of the needed output columns instead of the whole
    projection; with a cached per-path logsumexp a keystroke costs O(N H)."""
    head = params["head"]
    if "blocks" not in head:
        return torch.einsum("...h,hn->...n", h_top, _cols(head["W"], words)) + head["b"][words]
    out = torch.zeros(h_top.shape[:-1] + (words.shape[0],), dtype=torch.float32,
                      device=h_top.device)
    for (start, d, base, size), blk in zip(_block_spans(config), head["blocks"]):
        in_blk = (words >= base) & (words < base + size)
        local = (words - base).clamp(0, size - 1)
        vals = (torch.einsum("...d,dn->...n", h_top[..., start:start + d], _cols(blk["W"], local))
                + blk["b"][local])
        out = torch.where(in_blk, vals, out)
    return out


def node_logits(params: Dict[str, Any], config: Config, h_src: torch.Tensor,
                words: torch.Tensor) -> torch.Tensor:
    """Raw logit of each node's own word from each beam path: ``h_src [...,
    N, B, H]`` and ``words [..., N]`` -> ``[..., N, B]``.

    The paired form of :func:`candidate_logits`: node n is scored only
    against its own column, one column gather and one contraction,
    O(N B H).  Shared by the incremental decoder and the multi-session
    server; full and D-softmax heads, int8 columns dequantized in fp32."""
    lead, N = words.shape[:-1], words.shape[-1]
    B, H = h_src.shape[-2], h_src.shape[-1]
    h_src = h_src.reshape(-1, N, B, H)
    words = words.reshape(-1, N)
    E = words.shape[0]
    head = params["head"]

    def cols_of(W, ids):  # -> fp32 [d, E, N]
        c = _cols(W, ids.reshape(-1))
        return c.reshape(c.shape[0], E, N)

    if "blocks" not in head:
        out = (torch.einsum("enbh,hen->enb", h_src, cols_of(head["W"], words))
               + head["b"][words][:, :, None])
        return out.reshape(*lead, N, B)
    out = torch.zeros((E, N, B), dtype=torch.float32, device=h_src.device)
    for (start, d, base, size), blk in zip(_block_spans(config), head["blocks"]):
        in_blk = (words >= base) & (words < base + size)
        local = (words - base).clamp(0, size - 1)
        vals = (torch.einsum("enbd,den->enb", h_src[..., start:start + d],
                             cols_of(blk["W"], local))
                + blk["b"][local][:, :, None])
        out = torch.where(in_blk[:, :, None], vals, out)
    return out.reshape(*lead, N, B)


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
