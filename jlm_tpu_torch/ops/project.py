"""Output projection with online logsumexp — the decode frame's normalizer.

Counterpart of :mod:`jlm_tpu.ops.project` (its ``_proj_kernel``, LSE-only,
full head).  ``project_ms`` returns the per-row partial softmax statistics
``(m, s)`` of ``logits = h @ W + b`` (``lse = m + log s``) and
``project_lse`` the log-sum-exp itself; ``[R, V]`` logits never reach
device memory on the card.

Weight modes, as in the reference:

- fp32 weights (plain version only; the card has no fp32 kernel yet);
- bf16 weights with fp32 accumulation;
- int8 ``{"q", "scale"}`` weights with ``int8_mxu=True``: activations are
  quantized per row (``s = max(max|h|, 1e-30) / 127``, round half to even)
  and the product is int8 x int8 -> int32, rescaled by row and column
  scale.  The in-kernel int8 *dequant* mode (``int8_mxu=False``), candidate
  extraction and the D-softmax head are not ported yet (ROADMAP.md).

On a CUDA tensor the wrapper launches ``csrc/project_lse.cu`` or raises;
on a CPU tensor it runs the plain version.  ``head`` may carry ``"WT"``, the
``[V, H]`` transposed weight the kernel reads (``build_decode_head`` makes
it once); without it the wrapper transposes per call.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, Optional, Tuple

import torch

from jlm_tpu.config import Config
from jlm_tpu_torch.models.lstm import DSOFTMAX_TODO
from jlm_tpu_torch.ops import _build

# Rows per block and vocab columns per tile of the kernel (project_lse.cu).
_TR, _TV = 128, 64
DEQUANT_TODO = ("int8 dequant head (int8_mxu=False) not ported yet "
                "(ROADMAP.md queue 2, kernel 1)")


def quantize_rows(h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 activation quantization (project.py:83-89):
    returns ``(q int8 [R, H], s fp32 [R, 1])`` with ``h ~= q * s``.

    Both steps are true IEEE divisions, as in the reference and the kernel:
    on CUDA, PyTorch turns ``tensor / python_float`` into a multiplication
    by the reciprocal, which moves ``s`` by an ulp and flips roundings."""
    hf = h.float()
    amax = torch.clamp(hf.abs().amax(dim=1, keepdim=True), min=1e-30)
    s = amax / torch.full_like(amax, 127.0)
    return torch.round(hf / s).to(torch.int8), s


def _split_head(head: Dict[str, Any]):
    if "blocks" in head:
        raise NotImplementedError(DSOFTMAX_TODO)
    W = head["W"]
    if isinstance(W, dict):
        return W["q"], W["scale"], head["b"]
    return W, None, head["b"]


def _logits_ref(h, W, scale, bias, compute_dtype, int8_mxu) -> torch.Tensor:
    h = h.to(compute_dtype)
    if scale is not None:
        if not int8_mxu:
            raise NotImplementedError(DEQUANT_TODO)
        q, s = quantize_rows(h)
        # int8 @ int8 in torch returns int8 (wraps), so multiply as fp32:
        # every partial sum is an integer below 2**24 for H <= 1040, exact.
        acc = q.float() @ W.float()
        return acc * s * scale.float()[None, :] + bias.float()[None, :]
    return h.float() @ W.to(compute_dtype).float() + bias.float()[None, :]


def project_ms_ref(h, W, scale, bias, *, compute_dtype=torch.float32,
                   int8_mxu: bool = False):
    """Plain version: ``(m, s)`` each ``[R, 1]`` from full logits."""
    logits = _logits_ref(h, W, scale, bias, compute_dtype, int8_mxu)
    m = logits.amax(dim=1, keepdim=True)
    return m, torch.exp(logits - m).sum(dim=1, keepdim=True)


def project_lse_ref(h, W, scale, bias, *, compute_dtype=torch.float32,
                    int8_mxu: bool = False) -> torch.Tensor:
    """Plain version of :func:`project_lse`: ``[R, 1]``."""
    m, s = project_ms_ref(h, W, scale, bias, compute_dtype=compute_dtype,
                          int8_mxu=int8_mxu)
    return m + torch.log(s)


def _launch(h, head, compute_dtype, int8_mxu, want_lse: bool):
    W, scale, bias = _split_head(head)
    R, H = h.shape
    V = bias.shape[0]
    quantized = scale is not None
    if compute_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"compute_dtype {compute_dtype}")
    if quantized and not int8_mxu:
        raise NotImplementedError(DEQUANT_TODO)
    if not quantized and compute_dtype != torch.bfloat16:
        raise NotImplementedError(
            f"project kernel takes bf16 or int8 weights, not {compute_dtype} "
            "(fp32 head kernel: ROADMAP.md queue 2, kernel 1)")
    wt = head.get("WT")
    if wt is None:
        wt = (W if quantized else W.to(compute_dtype)).t().contiguous()
    h = h.to(compute_dtype).contiguous()
    want_w = torch.int8 if quantized else torch.bfloat16
    for name, t in (("W^T", wt), ("bias", bias)) + (
            (("scale", scale),) if quantized else ()):
        if t.device != h.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {h.device}")
    if wt.dtype != want_w or tuple(wt.shape) != (V, H):
        raise ValueError(f"W^T must be {want_w} [{V}, {H}], got "
                         f"{wt.dtype} {tuple(wt.shape)}")
    if bias.dtype != torch.float32 or (quantized and scale.dtype != torch.float32):
        raise ValueError("bias and scale must be fp32")
    if H % 32:
        raise ValueError(f"hidden size {H} must be a multiple of 32")

    if R == 0:
        empty = torch.empty((0, 1), dtype=torch.float32, device=h.device)
        return empty, empty, empty
    n_tiles = -(-V // _TV)
    row_blocks = -(-R // _TR)
    sms = torch.cuda.get_device_properties(h.device).multi_processor_count
    splits = min(n_tiles, max(1, -(-8 * sms // row_blocks)))
    per_split = -(-n_tiles // splits)
    splits = -(-n_tiles // per_split)
    part = torch.empty((2, splits, R), dtype=torch.float32, device=h.device)
    def col():
        return torch.empty((R, 1), dtype=torch.float32, device=h.device)

    outs = (None, None, col()) if want_lse else (col(), col(), None)
    P = ctypes.c_void_p
    ptr = lambda t: P(t.data_ptr()) if t is not None else P(None)  # noqa: E731
    err = _build.lib().jlm_project_ms(
        ptr(h), int(h.dtype == torch.bfloat16), ptr(wt), int(quantized),
        ptr(scale), ptr(bias), ptr(part[0]), ptr(part[1]),
        ptr(outs[0]), ptr(outs[1]), ptr(outs[2]),
        R, H, V, splits, per_split, P(_build.stream_ptr(h)),
    )
    _build.check(err, "project_lse kernel")
    project_lse.launches += 1
    return outs


def project_ms(
    h: torch.Tensor,  # [R, H]
    head: Dict[str, Any],  # {"W", "b"[, "WT"]}; W may be an int8 quant dict
    config: Optional[Config] = None,
    *,
    compute_dtype=torch.float32,
    int8_mxu: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row partial softmax statistics ``(m, s)``, each ``[R, 1]``."""
    if h.is_cuda:
        m, s, _ = _launch(h, head, compute_dtype, int8_mxu, want_lse=False)
        return m, s
    W, scale, bias = _split_head(head)
    return project_ms_ref(h, W, scale, bias, compute_dtype=compute_dtype,
                          int8_mxu=int8_mxu)


def project_lse(
    h: torch.Tensor,  # [R, H]
    head: Dict[str, Any],
    config: Optional[Config] = None,
    *,
    compute_dtype=torch.float32,
    int8_mxu: bool = False,
) -> torch.Tensor:
    """Per-row log-sum-exp of the full output projection: ``[R, 1]``.

    ``project_lse.launches`` counts kernel launches from either wrapper.
    """
    if h.is_cuda:
        return _launch(h, head, compute_dtype, int8_mxu, want_lse=True)[2]
    W, scale, bias = _split_head(head)
    return project_lse_ref(h, W, scale, bias, compute_dtype=compute_dtype,
                           int8_mxu=int8_mxu)


project_lse.launches = 0
