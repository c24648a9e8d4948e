"""Training losses over the LSTM hidden sequence.

Counterpart of :mod:`jlm_tpu.models.heads`: full softmax cross-entropy
(full or D-softmax head, fused or plain) and log-uniform sampled softmax.
Every loss takes the ``[B, T, H]`` hidden sequence of
:func:`jlm_tpu_torch.models.lstm.forward_hidden` and returns the mean
token NLL.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from jlm_tpu_torch.config import Config
from jlm_tpu_torch.models.lstm import _w, head_logits, log_softmax
from jlm_tpu_torch.ops.softmax_ce import ce_loss_fused, ce_loss_fused_dsoftmax


def full_softmax_loss(params: Dict[str, Any], config: Config, hs: torch.Tensor,
                      targets: torch.Tensor, precision: str = "default") -> torch.Tensor:
    """Mean token NLL with the full (or D-softmax) projection.

    With ``config.fused_ce`` and fp weights the loss runs through the fused
    CE kernels (per block for a D-softmax head), logits never in device
    memory; otherwise plain ``log_softmax`` over the head's logits.  As in
    the reference, the fused route computes in bf16 unless ``precision``
    is ``"highest"``, whatever the parameters' dtype; ``"highest"`` takes
    the fp32 CE kernels on the card (exact fp32 products, no TF32)."""
    B, T, H = hs.shape
    head = params["head"]
    h, y = hs.reshape(B * T, H), targets.reshape(B * T)
    cd = torch.float32 if precision == "highest" else torch.bfloat16
    if config.fused_ce and "W" in head and not isinstance(head["W"], dict):
        return ce_loss_fused(h, head["W"], head["b"], y, cd).mean()
    if (config.fused_ce and "blocks" in head
            and not any(isinstance(blk["W"], dict) for blk in head["blocks"])):
        ds = config.dsoftmax
        return ce_loss_fused_dsoftmax(
            h, [blk["W"] for blk in head["blocks"]], [blk["b"] for blk in head["blocks"]],
            y, ds.block_sizes, ds.block_dims, ds.mode, cd).mean()
    logp = log_softmax(head_logits(params, config, h))
    return -logp.gather(1, y.long()[:, None])[:, 0].mean()


def log_uniform_logq(vocab_size: int, device=None) -> torch.Tensor:
    """log q(k) of the Zipfian (log-uniform) candidate sampler:
    ``q(k) = (log(k+2) - log(k+1)) / log(V+1)``."""
    k = torch.arange(vocab_size, dtype=torch.float32, device=device)
    norm = torch.full((), vocab_size + 1.0, device=device).log()  # divide by a tensor: IEEE
    return torch.log(torch.log1p(1.0 / (k + 1.0)) / norm)


def sample_log_uniform(generator: torch.Generator, vocab_size: int, n: int) -> torch.Tensor:
    """Draw ``n`` ids with ``P(k)`` proportional to ``log((k+2)/(k+1))`` by
    inverse CDF, on the generator's device."""
    u = torch.rand(n, generator=generator, device=generator.device)
    ids = torch.exp(u * math.log(vocab_size + 1.0)) - 2.0
    return ids.round().long().clamp(0, vocab_size - 1)


def sampled_softmax_loss(params: Dict[str, Any], config: Config, hs: torch.Tensor,
                         targets: torch.Tensor, sampled: torch.Tensor) -> torch.Tensor:
    """Sampled-softmax NLL (full head only) over the true class and the
    ``sampled`` ids ``[S]``, one draw shared by the whole batch; both are
    corrected by ``-log q``, and a sampled id equal to a row's true class
    (an accidental hit) is masked to -1e9."""
    head = params["head"]
    if "blocks" in head:
        raise ValueError("sampled softmax requires the full head")
    B, T, H = hs.shape
    h, t = hs.reshape(B * T, H), targets.reshape(B * T).long()
    logq = log_uniform_logq(config.vocab_size, h.device)
    W, b = _w(head["W"]), head["b"]
    true_logit = torch.einsum("nh,hn->n", h, W[:, t]) + b[t] - logq[t]
    samp_logit = h @ W[:, sampled] + b[sampled] - logq[sampled]  # [N, S]
    hit = sampled[None, :] == t[:, None]
    samp_logit = torch.where(hit, torch.full_like(samp_logit, -1e9), samp_logit)
    joint = torch.cat([true_logit[:, None], samp_logit], dim=1)
    return (-log_softmax(joint)[:, 0]).mean()
