"""Fused LSTM over a BPTT window (time-block scan), forward and backward.

Counterpart of :mod:`jlm_tpu.ops.lstm_scan` (its ``_lstm_fwd_kernel`` and
``_lstm_bwd_kernel``): gate order i, j, f, o,
``c' = sigmoid(f + forget_bias) * c + sigmoid(i) * tanh(j)``,
``h' = sigmoid(o) * tanh(c')``, over ``xs [B, T, E]`` with fused weights
``W [E+H, 4H]``.

- ``lstm_scan_fwd`` -> ``(hs [B,T,H], cs [B,T,H], c_T, h_T)``, all fp32;
- ``lstm_scan_bwd`` walks time in reverse: it recomputes each step's gates
  from the saved ``(x_t, h_{t-1})`` and ``cs``, carries ``(dc, dh)`` and
  returns ``(dz [B,T,4H], dx [B,T,E], dc0, dh0)``;
- ``lstm_scan``: the scan as an autograd Function whose backward is
  ``lstm_scan_bwd``; ``dW = [x; h_prev]^T dz`` and ``db = sum dz`` stay one
  ``torch.matmul`` and one sum, as the reference computes them outside its
  kernel.

``compute_dtype`` is what x, h, W (forward, recompute) and dz, W (the
backward's products) are rounded to before each product; sums, gates and
carries are fp32 either way.  On a CUDA tensor the wrappers launch
``csrc/lstm_scan.cu`` or raise (the kernels multiply on the CUDA cores,
so fp32 compute is exact fp32, never TF32); on a CPU tensor they run the
plain versions ``lstm_scan_ref`` and ``lstm_scan_bwd_ref``.  One launch covers
the whole window, so the reference's ``time_block`` and its VMEM fallback
have no counterpart; shapes the kernels do not take raise.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from jlm_tpu_torch.ops import _build

Tensor = torch.Tensor

UNITS = 4           # hidden units per block: 16 gate columns of W
MAX_DX_ROWS = 4     # dx columns per block in the backward (E <= 4 * H / UNITS)


# ---------------------------------------------------------------- plain

def _mm(a: Tensor, b: Tensor, compute_dtype) -> Tensor:
    """``a @ b`` with operands rounded to ``compute_dtype``, fp32 sums."""
    return a.to(compute_dtype).float() @ b.to(compute_dtype).float()


def lstm_scan_ref(xs, W, b, c0, h0, forget_bias: float = 1.0,
                  compute_dtype=torch.float32):
    """Plain forward: ``(hs, cs, c_T, h_T)``, fp32."""
    T = xs.shape[1]
    c, h = c0.float(), h0.float()
    hs, cs = [], []
    for t in range(T):
        z = _mm(torch.cat([xs[:, t], h], dim=1), W, compute_dtype) + b.float()
        i, j, f, o = z.chunk(4, dim=1)
        c = torch.sigmoid(f + forget_bias) * c + torch.sigmoid(i) * torch.tanh(j)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
        cs.append(c)
    return torch.stack(hs, dim=1), torch.stack(cs, dim=1), c, h


def lstm_scan_bwd_ref(xs, W, b, c0, h0, hs, cs, d_hs, d_cf, d_hf,
                      forget_bias: float = 1.0, compute_dtype=torch.float32):
    """Plain backward, the kernel's algorithm: ``(dz, dx, dc0, dh0)``.

    Per step, from the last: recompute ``z`` from the saved ``(x_t,
    h_{t-1})``, take ``tanh(c_t)`` from the saved ``cs``, form the gate
    grads ``dz_t`` from the carried ``(dc, dh)``, then ``dx_t = dz_t Wx^T``,
    ``dh <- dz_t Wh^T`` and ``dc <- dc_tot * sigmoid(f + forget_bias)``."""
    B, T, E = xs.shape
    H = h0.shape[-1]
    Wx, Wh = W[:E], W[E:]
    h_prev = torch.cat([h0[:, None].float(), hs[:, :-1]], dim=1)
    c_prev = torch.cat([c0[:, None].float(), cs[:, :-1]], dim=1)
    dc, dh = d_cf.float(), d_hf.float()
    dz = torch.empty((B, T, 4 * H), dtype=torch.float32, device=xs.device)
    dx = torch.empty((B, T, E), dtype=torch.float32, device=xs.device)
    for t in range(T - 1, -1, -1):
        z = _mm(torch.cat([xs[:, t], h_prev[:, t]], dim=1), W, compute_dtype) + b.float()
        zi, zj, zf, zo = z.chunk(4, dim=1)
        si, tj = torch.sigmoid(zi), torch.tanh(zj)
        sf, so = torch.sigmoid(zf + forget_bias), torch.sigmoid(zo)
        tc = torch.tanh(cs[:, t])
        dh_tot = d_hs[:, t].float() + dh
        dc_tot = dh_tot * so * (1.0 - tc * tc) + dc
        dz_t = torch.cat([dc_tot * tj * si * (1.0 - si),
                          dc_tot * si * (1.0 - tj * tj),
                          dc_tot * c_prev[:, t] * sf * (1.0 - sf),
                          dh_tot * tc * so * (1.0 - so)], dim=1)
        dz[:, t] = dz_t
        dx[:, t] = _mm(dz_t, Wx.t(), compute_dtype)
        dh = _mm(dz_t, Wh.t(), compute_dtype)
        dc = dc_tot * sf
    return dz, dx, dc, dh


# ---------------------------------------------------------------- kernels

def _ptr(t: Optional[Tensor]):
    return ctypes.c_void_p(t.data_ptr() if t is not None else None)


def _mode(compute_dtype) -> int:
    if compute_dtype == torch.float32:
        return 0
    if compute_dtype == torch.bfloat16:
        return 1
    raise ValueError(f"compute_dtype must be float32 or bfloat16, not {compute_dtype}")


def _f32(t: Tensor, shape, device, name: str) -> Tensor:
    if tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(f"{name} must be {tuple(shape)} on {device}, got "
                         f"{tuple(t.shape)} on {t.device}")
    return t.float().contiguous()


def _check_fit(bwd: int, B: int, E: int, H: int, device) -> None:
    """Raise unless the kernel takes these dims and its grid of ``H / 4``
    blocks can be co-resident (the grid-wide barrier needs every block)."""
    if H % UNITS or E % 4:
        raise ValueError(f"lstm_scan kernels need H % {UNITS} == 0 and E % 4 == 0 "
                         f"(E={E}, H={H})")
    grid = H // UNITS
    if bwd and -(-E // grid) > MAX_DX_ROWS:
        raise ValueError(f"lstm_scan backward takes E <= {MAX_DX_ROWS * grid} "
                         f"at H={H} (E={E})")
    fits = _build.lib().jlm_lstm_scan_max_blocks(bwd, B, E, H, device.index or 0)
    if fits < 0:
        _build.check(-fits, "lstm_scan occupancy query")
    if fits < grid:
        raise ValueError(
            f"lstm_scan {'backward' if bwd else 'forward'} at B={B}, E={E}, H={H} "
            f"needs {grid} co-resident blocks, the card holds {fits} "
            "(shared memory per block grows with E + H and H)")


def lstm_scan_fwd(xs: Tensor, W: Tensor, b: Tensor, c0: Tensor, h0: Tensor,
                  forget_bias: float = 1.0, compute_dtype=torch.float32):
    """``(hs [B,T,H], cs [B,T,H], c_T [B,H], h_T [B,H])``, fp32; cs is what
    the backward needs besides hs.

    ``lstm_scan_fwd.launches`` counts launches of the forward kernel."""
    if not xs.is_cuda:
        return lstm_scan_ref(xs, W, b, c0, h0, forget_bias, compute_dtype)
    mode = _mode(compute_dtype)
    B, T, E = xs.shape
    H = h0.shape[-1]
    dev = xs.device
    xs = xs.float().contiguous()
    W = _f32(W, (E + H, 4 * H), dev, "W")
    b = _f32(b, (4 * H,), dev, "b")
    c0, h0 = _f32(c0, (B, H), dev, "c0"), _f32(h0, (B, H), dev, "h0")
    hs = torch.empty((B, T, H), dtype=torch.float32, device=dev)
    cs = torch.empty((B, T, H), dtype=torch.float32, device=dev)
    c_T = torch.empty((B, H), dtype=torch.float32, device=dev)
    h_T = torch.empty((B, H), dtype=torch.float32, device=dev)
    if B * T == 0:
        return hs, cs, c0.clone(), h0.clone()
    _check_fit(0, B, E, H, dev)
    err = _build.lib().jlm_lstm_scan_fwd(
        _ptr(xs), _ptr(W), _ptr(b), _ptr(c0), _ptr(h0), _ptr(hs), _ptr(cs),
        _ptr(c_T), _ptr(h_T), B, T, E, H, ctypes.c_float(forget_bias), mode,
        ctypes.c_void_p(_build.stream_ptr(xs)))
    _build.check(err, "lstm_scan_fwd kernel")
    lstm_scan_fwd.launches += 1
    return hs, cs, c_T, h_T


def lstm_scan_bwd(xs: Tensor, W: Tensor, b: Tensor, c0: Tensor, h0: Tensor,
                  hs: Tensor, cs: Tensor, d_hs: Tensor, d_cf: Tensor, d_hf: Tensor,
                  forget_bias: float = 1.0, compute_dtype=torch.float32):
    """``(dz [B,T,4H], dx [B,T,E], dc0 [B,H], dh0 [B,H])``, fp32.

    ``lstm_scan_bwd.launches`` counts launches of the backward kernel."""
    if not xs.is_cuda:
        return lstm_scan_bwd_ref(xs, W, b, c0, h0, hs, cs, d_hs, d_cf, d_hf,
                                 forget_bias, compute_dtype)
    mode = _mode(compute_dtype)
    B, T, E = xs.shape
    H = h0.shape[-1]
    dev = xs.device
    xs = xs.float().contiguous()
    W = _f32(W, (E + H, 4 * H), dev, "W")
    b = _f32(b, (4 * H,), dev, "b")
    c0, h0 = _f32(c0, (B, H), dev, "c0"), _f32(h0, (B, H), dev, "h0")
    hs, cs, d_hs = (_f32(t, (B, T, H), dev, n) for t, n in
                    ((hs, "hs"), (cs, "cs"), (d_hs, "d_hs")))
    d_cf, d_hf = _f32(d_cf, (B, H), dev, "d_cf"), _f32(d_hf, (B, H), dev, "d_hf")
    dz = torch.empty((B, T, 4 * H), dtype=torch.float32, device=dev)
    dx = torch.empty((B, T, E), dtype=torch.float32, device=dev)
    dc0 = torch.empty((B, H), dtype=torch.float32, device=dev)
    dh0 = torch.empty((B, H), dtype=torch.float32, device=dev)
    if B * T == 0:
        return dz, dx, d_cf.clone(), d_hf.clone()
    _check_fit(1, B, E, H, dev)
    err = _build.lib().jlm_lstm_scan_bwd(
        _ptr(xs), _ptr(W), _ptr(b), _ptr(c0), _ptr(h0), _ptr(hs), _ptr(cs),
        _ptr(d_hs), _ptr(d_cf), _ptr(d_hf), _ptr(dz), _ptr(dx), _ptr(dc0), _ptr(dh0),
        B, T, E, H, ctypes.c_float(forget_bias), mode,
        ctypes.c_void_p(_build.stream_ptr(xs)))
    _build.check(err, "lstm_scan_bwd kernel")
    lstm_scan_bwd.launches += 1
    return dz, dx, dc0, dh0


lstm_scan_fwd.launches = 0
lstm_scan_bwd.launches = 0


# ------------------------------------------------------------ autograd

class _LSTMScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xs, W, b, c0, h0, forget_bias, compute_dtype):
        hs, cs, c_T, h_T = lstm_scan_fwd(xs, W, b, c0, h0, forget_bias, compute_dtype)
        ctx.save_for_backward(xs, W, b, c0, h0, hs, cs)
        ctx.forget_bias, ctx.compute_dtype = forget_bias, compute_dtype
        return hs, c_T, h_T

    @staticmethod
    def backward(ctx, d_hs, d_cf, d_hf):
        xs, W, b, c0, h0, hs, cs = ctx.saved_tensors
        B, T, E = xs.shape
        dz, dx, dc0, dh0 = lstm_scan_bwd(xs, W, b, c0, h0, hs, cs, d_hs, d_cf, d_hf,
                                         ctx.forget_bias, ctx.compute_dtype)
        h_prev = torch.cat([h0[:, None].float(), hs[:, :-1]], dim=1)
        xh = torch.cat([xs.float(), h_prev], dim=2).reshape(B * T, -1)
        dW = xh.t() @ dz.reshape(B * T, -1)
        db = dz.sum(dim=(0, 1))
        return (dx.to(xs.dtype), dW.to(W.dtype), db.to(b.dtype), dc0.to(c0.dtype),
                dh0.to(h0.dtype), None, None)


def lstm_scan(xs: Tensor, W: Tensor, b: Tensor, c0: Tensor, h0: Tensor,
              forget_bias: float = 1.0, compute_dtype=torch.float32
              ) -> Tuple[Tensor, Tensor, Tensor]:
    """Fused LSTM over ``[B, T, E]`` -> ``(hs [B,T,H], c_T, h_T)``, fp32,
    differentiable in every input.  A caller that needs a true fp32
    ``dW`` on the card turns TF32 off (the training path does)."""
    return _LSTMScan.apply(xs, W, b, c0, h0, forget_bias, compute_dtype)
