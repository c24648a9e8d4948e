"""Numpy LSTM LM — the inference-engine oracle.

The port's copy of :mod:`jlm_tpu.oracle.lm`.

Independent numpy re-implementation of the model spec (SURVEY.md §4.2; ref:
the numpy engine in JLM:decoder/ and TF graph in JLM:train/lm.py):

- embedding lookup → L × fused LSTM cells → output head → log-softmax;
- the cell computes ONE fused matmul ``[x; h] @ W + b`` split into gates
  ``i, j, f, o``; ``c' = σ(f + forget_bias)·c + σ(i)·tanh(j)``,
  ``h' = σ(o)·tanh(c')``;
- heads: full softmax or D-softmax (prefix-slice "D-softmax*" or disjoint
  segments, SURVEY.md §4.4);
- quantized weights are dequantized up front — oracle math is always fp32,
  which *defines* the int8 parity tolerance for the in-kernel-dequant path.

All reductions use max-subtracted fp32 logsumexp, the frozen numeric rule
for parity (SURVEY.md §9.3.5).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

from jlm_tpu_torch.config import Config
from jlm_tpu_torch.ops.quant import dequantize_params, is_quantized

State = Tuple[np.ndarray, np.ndarray]  # (c, h) each [L, B, H]


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


class OracleLM:
    def __init__(self, params: Dict[str, Any], config: Config):
        self.p = (
            dequantize_params(params) if is_quantized(params["embedding"]) else params
        )
        self.config = config

    def initial_state(self, batch: int) -> State:
        L, H = self.config.num_layers, self.config.hidden_size
        return (
            np.zeros((L, batch, H), np.float32),
            np.zeros((L, batch, H), np.float32),
        )

    def _head_logits(self, h: np.ndarray) -> np.ndarray:
        head = self.p["head"]
        if "blocks" in head:
            cfg = self.config.dsoftmax
            outs = []
            offset = 0
            for k, blk in enumerate(head["blocks"]):
                d = cfg.block_dims[k]
                if cfg.mode == "prefix":
                    hs = h[:, :d]
                else:
                    hs = h[:, offset : offset + d]
                    offset += d
                outs.append(hs @ blk["W"] + blk["b"])
            return np.concatenate(outs, axis=1)
        return h @ head["W"] + head["b"]

    def step(self, word_ids: np.ndarray, state: State) -> Tuple[np.ndarray, State]:
        """One LM step: feed ``word_ids [B]``, return ``(logp [B, V], state')``."""
        c, h = state
        fb = self.config.forget_bias
        H = self.config.hidden_size
        x = self.p["embedding"][word_ids]
        new_c, new_h = [], []
        for l, layer in enumerate(self.p["lstm"]):
            z = np.concatenate([x, h[l]], axis=1) @ layer["W"] + layer["b"]
            i, j, f, o = z[:, :H], z[:, H : 2 * H], z[:, 2 * H : 3 * H], z[:, 3 * H :]
            cl = _sigmoid(f + fb) * c[l] + _sigmoid(i) * np.tanh(j)
            hl = _sigmoid(o) * np.tanh(cl)
            new_c.append(cl)
            new_h.append(hl)
            x = hl
        logits = self._head_logits(x).astype(np.float32)
        m = logits.max(axis=1, keepdims=True)
        logp = logits - (m + np.log(np.exp(logits - m).sum(axis=1, keepdims=True)))
        return logp, (np.stack(new_c), np.stack(new_h))

    def sequence_nll(self, ids: np.ndarray) -> float:
        """Mean negative log-likelihood of a flat id sequence (PPL oracle)."""
        state = self.initial_state(1)
        total = 0.0
        for t in range(len(ids) - 1):
            logp, state = self.step(ids[t : t + 1], state)
            total -= float(logp[0, ids[t + 1]])
        return total / max(1, len(ids) - 1)
