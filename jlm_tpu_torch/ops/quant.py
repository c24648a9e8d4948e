"""int8 symmetric weight quantization (SURVEY.md §4.3).

The port's copy of :mod:`jlm_tpu.ops.quant` (numpy only).

Rebuild of the reference's 8-bit quantizer (ref: JLM:decoder/ model file —
quantize/dequantize helpers).  Scheme: linear symmetric int8 with an fp32
scale **per output channel**:

- 2-D weight ``W[in, out]`` → ``q[in, out] int8``, ``scale[out] fp32`` with
  ``scale = max|W[:, o]| / 127``; dequant is ``q * scale`` (broadcast over
  rows).  Per-output-channel scale keeps the dequant fusable after the
  matmul: ``(x @ q) * scale``.
- Embedding ``E[V, emb]`` → per-row scale ``scale[V]`` (each word vector has
  its own scale), since lookups are row gathers.
- Biases stay fp32.

The reference's scale granularity is [C-med] (per-tensor vs per-row,
SURVEY.md §4.3); per-channel is at least as accurate and defines this
build's parity tolerance.

A quantized leaf is a dict ``{"q": int8 array, "scale": fp32 array}``;
``quantize_params``/``dequantize_params`` walk the model pytree.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


def quantize_weight(w: np.ndarray, axis: int = 0) -> Dict[str, np.ndarray]:
    """Symmetric int8 quantization reducing over ``axis``.

    ``axis=0`` → per-column scale for ``[in, out]`` matmul weights;
    ``axis=1`` → per-row scale for embeddings.
    """
    absmax = np.maximum(np.abs(w).max(axis=axis), 1e-8)
    scale = (absmax / 127.0).astype(np.float32)
    q = np.clip(np.round(w / np.expand_dims(scale, axis)), -127, 127).astype(
        np.int8
    )
    return {"q": q, "scale": scale}


def dequantize_weight(leaf: Dict[str, Any], axis: int = 0, xp=np) -> Any:
    """Inverse of :func:`quantize_weight` (numpy or jax.numpy via ``xp``)."""
    scale = leaf["scale"]
    return leaf["q"].astype(xp.float32) * xp.expand_dims(scale, axis)


def is_quantized(leaf: Any) -> bool:
    return isinstance(leaf, dict) and "q" in leaf and "scale" in leaf


def quantize_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Quantize a model pytree (embedding per-row, matmul weights per-col).

    Layout contract (the build's weight spec, SURVEY.md §7 "Checkpoint"):
    ``{"embedding", "lstm": [{"W","b"}...], "head": {"W","b"} |
    {"blocks": [{"W","b"}...]}}``.
    """
    out: Dict[str, Any] = {}
    out["embedding"] = quantize_weight(np.asarray(params["embedding"]), axis=1)
    out["lstm"] = [
        {"W": quantize_weight(np.asarray(l["W"]), axis=0), "b": np.asarray(l["b"])}
        for l in params["lstm"]
    ]
    head = params["head"]
    if "blocks" in head:
        out["head"] = {
            "blocks": [
                {
                    "W": quantize_weight(np.asarray(b["W"]), axis=0),
                    "b": np.asarray(b["b"]),
                }
                for b in head["blocks"]
            ]
        }
    else:
        out["head"] = {
            "W": quantize_weight(np.asarray(head["W"]), axis=0),
            "b": np.asarray(head["b"]),
        }
    return out


def dequantize_params(params: Dict[str, Any], xp=np) -> Dict[str, Any]:
    """fp32 view of a (possibly) quantized pytree — oracle/parity path."""
    if not is_quantized(params["embedding"]):
        return params
    out: Dict[str, Any] = {}
    out["embedding"] = dequantize_weight(params["embedding"], axis=1, xp=xp)
    out["lstm"] = [
        {"W": dequantize_weight(l["W"], axis=0, xp=xp), "b": l["b"]}
        for l in params["lstm"]
    ]
    head = params["head"]
    if "blocks" in head:
        out["head"] = {
            "blocks": [
                {"W": dequantize_weight(b["W"], axis=0, xp=xp), "b": b["b"]}
                for b in head["blocks"]
            ]
        }
    else:
        out["head"] = {"W": dequantize_weight(head["W"], axis=0, xp=xp), "b": head["b"]}
    return out
