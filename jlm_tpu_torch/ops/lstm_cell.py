"""Fused single-step LSTM cell for the decode frame.

Counterpart of :mod:`jlm_tpu.ops.lstm_cell` (its ``_cell_kernel``): one
step ``z = [x, h] @ W + b`` with gates i, j, f, o, fp32 accumulation, and
``c' = sigmoid(f + forget_bias) * c + sigmoid(i) * tanh(j)``,
``h' = sigmoid(o) * tanh(c')``.  ``c`` is read in its own dtype, ``c'`` is
returned in ``c_out_dtype`` (default fp32) and ``h'`` in ``compute_dtype``.

On a CUDA tensor the wrapper launches ``csrc/lstm_cell.cu`` (bf16 compute
on the tensor cores, or exact fp32 compute on the CUDA cores) or raises;
on a CPU tensor it runs the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from jlm_tpu_torch.ops import _build


def lstm_cell_ref(x, h, c, W, b, forget_bias: float = 1.0):
    """Plain cell in fp32 on the given values (mirrors ``lstm_cell_ref``)."""
    z = torch.cat([x, h], dim=1).float() @ W.float() + b.float()
    i, j, f, o = z.chunk(4, dim=1)
    c_new = torch.sigmoid(f + forget_bias) * c.float() + torch.sigmoid(i) * torch.tanh(j)
    return c_new, torch.sigmoid(o) * torch.tanh(c_new)


def _launch(x, h, c, W, b, forget_bias, c_out_dtype):
    R, E = x.shape
    H = h.shape[1]
    f32 = x.dtype == torch.float32
    if c_out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"c_out_dtype {c_out_dtype}")
    if c.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"c dtype {c.dtype}")
    if E % 32 or H % 32:
        raise ValueError(f"E={E} and H={H} must be multiples of 32")
    shapes = {"h": (h, (R, H)), "c": (c, (R, H)), "W": (W, (E + H, 4 * H)),
              "b": (b, (4 * H,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {shape} on {x.device}")
    if b.dtype != torch.float32:
        raise ValueError("b must be fp32")
    c_new = torch.empty((R, H), dtype=c_out_dtype, device=x.device)
    h_new = torch.empty((R, H), dtype=x.dtype, device=x.device)
    if R:
        P = ctypes.c_void_p
        err = _build.lib().jlm_lstm_cell(
            P(x.data_ptr()), P(h.data_ptr()), P(c.data_ptr()),
            int(c.dtype == torch.float32), P(W.data_ptr()), P(b.data_ptr()),
            P(c_new.data_ptr()), int(c_out_dtype == torch.float32),
            P(h_new.data_ptr()), int(f32), R, E, H, float(forget_bias),
            P(_build.stream_ptr(x)),
        )
        _build.check(err, "lstm_cell kernel")
        lstm_cell_step.launches += 1
    return c_new, h_new


def lstm_cell_step(
    x: torch.Tensor,  # [R, E]
    h: torch.Tensor,  # [R, H]
    c: torch.Tensor,  # [R, H] any float dtype
    W: torch.Tensor,  # [E+H, 4H]
    b: torch.Tensor,  # [4H] fp32
    forget_bias: float = 1.0,
    *,
    compute_dtype=torch.float32,
    c_out_dtype=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fused LSTM cell step: returns ``(c', h')``.

    ``lstm_cell_step.launches`` counts kernel launches.
    """
    c_out_dtype = torch.float32 if c_out_dtype is None else c_out_dtype
    x, h, W = x.to(compute_dtype), h.to(compute_dtype), W.to(compute_dtype)
    if x.is_cuda:
        if compute_dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"lstm_cell kernel computes in bf16 or fp32, not {compute_dtype}")
        return _launch(x.contiguous(), h.contiguous(), c, W.contiguous(), b,
                       forget_bias, c_out_dtype)
    c_new, h_new = lstm_cell_ref(x, h, c, W, b, forget_bias)
    return c_new.to(c_out_dtype), h_new.to(compute_dtype)


lstm_cell_step.launches = 0
