"""Fused LSTM over a BPTT window (time-block scan), forward and backward.

Counterpart of :mod:`jlm_tpu.ops.lstm_scan` (its ``_lstm_fwd_kernel`` and
``_lstm_bwd_kernel``): gate order i, j, f, o,
``c' = sigmoid(f + forget_bias) * c + sigmoid(i) * tanh(j)``,
``h' = sigmoid(o) * tanh(c')``, over ``xs [B, T, E]`` with fused weights
``W [E+H, 4H]``.

- ``lstm_scan_fwd`` -> ``(hs [B,T,H], cs [B,T,H], c_T, h_T)``, all fp32, in
  two stages: the input product of every step as one GEMM (``scan_xw``:
  ``Zx = xs Wx``) and the recurrence (``scan_fwd_recur``: per step ``z =
  (Zx_t + h_{t-1} Wh) + b``, the reference's order, and the gates);
- ``lstm_scan_bwd`` walks time in reverse: it recomputes each step's gates
  from the saved ``(x_t, h_{t-1})`` and ``cs``, carries ``(dc, dh)`` and
  returns ``(dz [B,T,4H], dx [B,T,E], dc0, dh0)``, in three stages: the
  gates of every step as one product (``scan_gates``), the recurrence
  (``scan_recur``: dz and the carried dh = dz_t Wh^T), and dx as one
  product (``scan_dx``);
- ``lstm_scan``: the scan as an autograd Function whose backward is
  ``lstm_scan_bwd``; ``dW = [x; h_prev]^T dz`` and ``db = sum dz`` stay one
  ``torch.matmul`` and one sum, as the reference computes them outside its
  kernel.

``compute_dtype`` is what x, h, W (forward, recompute) and dz, W (the
backward's products) are rounded to before each product; sums, gates and
carries are fp32 either way.  On a CUDA tensor the wrappers launch
``csrc/lstm_scan.cu`` or raise (the kernels multiply on the CUDA cores,
so fp32 compute is exact fp32, never TF32); on a CPU tensor they run the
plain versions ``scan_xw_ref``, ``scan_fwd_recur_ref``, ``scan_gates_ref``,
``scan_recur_ref`` and ``scan_dx_ref`` (``lstm_scan_ref`` and
``lstm_scan_bwd_ref`` are the whole forward and backward in the
reference's per-step order, the stages' referees).  The forward's two
launches and the backward's three cover the whole window, so the
reference's ``time_block`` and its VMEM fallback have no counterpart.  E
and H that are not multiples of 4 are zero-padded (``pad_scan``): a padded
unit has zero weights and bias and starts at c = h = 0, so it stays at
c = h = 0 and feeds nothing back; the padding is dropped from the outputs
and the gradients.

The two recurrences' grid (``_plan``, kept per width): a block per group
of ``nu`` units (8 where H / 8 fills the card, else 4) with their 4 nu
gate columns of Wh (forward) or their nu rows of Wh (backward, the same
bytes) resident in shared memory where all such blocks fit (H = 512,
H = 1,024); else Wh read from the L2 each step by as many blocks as fit.
Their carries live in device memory, so they take any batch.  The fp32
GEMMs split K where the output's tiles would leave most SMs idle
(``_gemm_plan``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from jlm_tpu_torch.ops import _build
from jlm_tpu_torch.ops.lstm_cell import pad_gates

Tensor = torch.Tensor

PAD = 4             # E and H are padded to multiples of this
GEMM_TILE, GEMM_K = 128, 16  # the fp32 GEMM's block tile and K chunk


# ---------------------------------------------------------------- plain

def _mm(a: Tensor, b: Tensor, compute_dtype) -> Tensor:
    """``a @ b`` with operands rounded to ``compute_dtype``, fp32 sums."""
    return a.to(compute_dtype).float() @ b.to(compute_dtype).float()


def _cell(z, c, forget_bias: float):
    """One step's gates from ``z [B, 4H]`` and the carried ``c``: ``(c', h')``."""
    i, j, f, o = z.chunk(4, dim=1)
    c = torch.sigmoid(f + forget_bias) * c + torch.sigmoid(i) * torch.tanh(j)
    return c, torch.sigmoid(o) * torch.tanh(c)


def lstm_scan_ref(xs, W, b, c0, h0, forget_bias: float = 1.0,
                  compute_dtype=torch.float32):
    """Plain forward: ``(hs, cs, c_T, h_T)``, fp32."""
    T = xs.shape[1]
    c, h = c0.float(), h0.float()
    hs, cs = [], []
    for t in range(T):
        c, h = _cell(_mm(torch.cat([xs[:, t], h], dim=1), W, compute_dtype) + b.float(), c,
                     forget_bias)
        hs.append(h)
        cs.append(c)
    return torch.stack(hs, dim=1), torch.stack(cs, dim=1), c, h


def scan_xw_ref(xs, Wx, compute_dtype=torch.float32):
    """Plain input product of every step: ``Zx = xs Wx``, ``xs [..., E]``,
    ``Wx [E, 4H]`` (W's x rows) -> ``[..., 4H]`` fp32 (no bias)."""
    return _mm(xs, Wx, compute_dtype)


def scan_fwd_recur_ref(Zx, Wh, b, c0, h0, forget_bias: float = 1.0,
                       compute_dtype=torch.float32):
    """Plain forward recurrence over the input products ``Zx [B,T,4H]``:
    per step ``z = (Zx_t + h_{t-1} Wh) + b`` (``Wh [H, 4H]``, W's h rows)
    and the gates -> ``(hs, cs, c_T, h_T)``."""
    T = Zx.shape[1]
    c, h = c0.float(), h0.float()
    hs, cs = [], []
    for t in range(T):
        c, h = _cell(Zx[:, t] + _mm(h, Wh, compute_dtype) + b.float(), c, forget_bias)
        hs.append(h)
        cs.append(c)
    return torch.stack(hs, dim=1), torch.stack(cs, dim=1), c, h


def _gate_grads(z, c_t, c_prev, d_h, dh, dc, forget_bias: float):
    """One step's gate grads from its pre-activations ``z [B, 4H]`` and the
    carried ``(dc, dh)``: ``(dz_t [B, 4H], dc_{t-1})``."""
    zi, zj, zf, zo = z.chunk(4, dim=1)
    si, tj = torch.sigmoid(zi), torch.tanh(zj)
    sf, so = torch.sigmoid(zf + forget_bias), torch.sigmoid(zo)
    tc = torch.tanh(c_t)
    dh_tot = d_h.float() + dh
    dc_tot = dh_tot * so * (1.0 - tc * tc) + dc
    dz_t = torch.cat([dc_tot * tj * si * (1.0 - si),
                      dc_tot * si * (1.0 - tj * tj),
                      dc_tot * c_prev * sf * (1.0 - sf),
                      dh_tot * tc * so * (1.0 - so)], dim=1)
    return dz_t, dc_tot * sf


def _h_prev(h0, hs):
    return torch.cat([h0[:, None].float(), hs[:, :-1].float()], dim=1)


def lstm_scan_bwd_ref(xs, W, b, c0, h0, hs, cs, d_hs, d_cf, d_hf,
                      forget_bias: float = 1.0, compute_dtype=torch.float32, xh=None):
    """Plain backward in the reference kernel's order: ``(dz, dx, dc0, dh0)``.

    Per step, from the last: recompute ``z`` from the saved ``(x_t,
    h_{t-1})`` (``xh [B, T, E+H]`` where given), take ``tanh(c_t)`` from the
    saved ``cs``, form the gate grads ``dz_t`` from the carried ``(dc, dh)``,
    then ``dx_t = dz_t Wx^T``, ``dh <- dz_t Wh^T`` and ``dc <- dc_tot *
    sigmoid(f + forget_bias)``."""
    B, T, E = xs.shape
    H = h0.shape[-1]
    Wx, Wh = W[:E], W[E:]
    if xh is None:
        xh = torch.cat([xs.float(), _h_prev(h0, hs)], dim=2)
    xh = xh.reshape(B, T, E + H)
    c_prev = torch.cat([c0[:, None].float(), cs[:, :-1]], dim=1)
    dc, dh = d_cf.float(), d_hf.float()
    dz = torch.empty((B, T, 4 * H), dtype=torch.float32, device=xs.device)
    dx = torch.empty((B, T, E), dtype=torch.float32, device=xs.device)
    for t in range(T - 1, -1, -1):
        z = _mm(xh[:, t], W, compute_dtype) + b.float()
        dz_t, dc = _gate_grads(z, cs[:, t], c_prev[:, t], d_hs[:, t], dh, dc, forget_bias)
        dz[:, t] = dz_t
        dx[:, t] = _mm(dz_t, Wx.t(), compute_dtype)
        dh = _mm(dz_t, Wh.t(), compute_dtype)
    return dz, dx, dc, dh


def scan_gates_ref(xh, W, b, compute_dtype=torch.float32):
    """Plain gate recompute of every step: ``Z = [x; h_prev] W + b``,
    ``xh [..., E+H]`` -> ``[..., 4H]`` fp32."""
    return _mm(xh, W, compute_dtype) + b.float()


def scan_recur_ref(Z, Wh, c0, cs, d_hs, d_cf, d_hf, forget_bias: float = 1.0,
                   compute_dtype=torch.float32):
    """Plain recurrence over the recomputed gates ``Z [B,T,4H]``: per step,
    from the last, ``dz_t`` from the carried ``(dc, dh)``, then ``dh <-
    dz_t Wh^T`` (``Wh [H, 4H]``, W's h rows) -> ``(dz, dc0, dh0)``."""
    T = Z.shape[1]
    c_prev = torch.cat([c0[:, None].float(), cs[:, :-1]], dim=1)
    dc, dh = d_cf.float(), d_hf.float()
    dz = torch.empty(Z.shape, dtype=torch.float32, device=Z.device)
    for t in range(T - 1, -1, -1):
        dz_t, dc = _gate_grads(Z[:, t], cs[:, t], c_prev[:, t], d_hs[:, t], dh, dc,
                               forget_bias)
        dz[:, t] = dz_t
        dh = _mm(dz_t, Wh.t(), compute_dtype)
    return dz, dc, dh


def scan_dx_ref(dz, Wx, compute_dtype=torch.float32):
    """Plain ``dx = dz Wx^T``: ``dz [..., 4H]``, ``Wx [E, 4H]`` (W's x rows)
    -> ``[..., E]`` fp32."""
    return _mm(dz, Wx.t(), compute_dtype)


# ---------------------------------------------------------------- kernels

def _ptr(t: Optional[Tensor]):
    """A tensor's address as ctypes takes it for a ``c_void_p`` (None: NULL)."""
    return t.data_ptr() if t is not None else None


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


def _round4(n: int) -> int:
    return -(-n // PAD) * PAD


def pad_scan(xs: Tensor, W: Tensor, b: Tensor, c0: Tensor, h0: Tensor):
    """The scan's operands with E and H zero-padded to multiples of 4: xs
    ``[B, T, Ep]``, W ``[Ep + Hp, 4 Hp]`` (each gate's columns and h's rows
    padded, x's rows padded), b ``[4 Hp]``, c0 and h0 ``[B, Hp]``."""
    E, H = xs.shape[-1], h0.shape[-1]
    Ep, Hp = _round4(E), _round4(H)
    pad = torch.nn.functional.pad
    Wp = pad_gates(W, E, H, Ep, Hp).reshape(Ep + Hp, 4 * Hp)
    return (pad(xs, (0, Ep - E)), Wp, pad(b.reshape(4, H), (0, Hp - H)).reshape(4 * Hp),
            pad(c0, (0, Hp - H)), pad(h0, (0, Hp - H)))


def unpad_gates(z: Tensor, H: int) -> Tensor:
    """``[..., 4 Hp]`` gate columns -> ``[..., 4 H]``."""
    return z.reshape(*z.shape[:-1], 4, -1)[..., :H].reshape(*z.shape[:-1], 4 * H)


def _plan(H: int, compute_dtype, device, nu: Optional[int] = None, fwd: bool = False
          ) -> Tuple[int, int, int, int]:
    """``(resident, nu, grid, groups per block)`` of a recurrence launch
    (``scan_fwd_recur`` where ``fwd``, else ``scan_recur``): ``nu`` units a
    block (8 where ``H / 8`` blocks fill the card, else 4; or as given),
    their 4 nu columns (forward) or nu rows (backward) of Wh resident in
    shared memory where all ``H / nu`` blocks can be co-resident (the
    grid-wide barrier needs every block), else read from the L2 each step
    by as many blocks as fit, each owning ``ceil(H / nu / grid)`` groups.
    The batch does not enter: the carries live in device memory."""
    if nu is None:
        nu = 8 if H % 8 == 0 and H // 8 >= 128 else 4
    if nu not in (4, 8) or H % nu:
        raise ValueError(f"the scan's recurrences take 4 or 8 units a block dividing H "
                         f"(nu={nu}, H={H})")
    groups, bf16 = H // nu, _mode(compute_dtype)
    lib, index = _build.lib(), device.index or 0
    name = "scan_fwd_recur" if fwd else "scan_recur"

    def fits(resident):
        n = lib.jlm_scan_recur_max_blocks(int(fwd), resident, bf16, nu, H, index)
        if n < 0:
            _build.check(-n, f"{name} occupancy query")
        return n

    if fits(1) >= groups:
        return 1, nu, groups, 1
    n = fits(0)
    if n == 0:
        raise ValueError(f"{name} at H={H}: not one block of {nu} units fits on an SM")
    grid = min(groups, n)
    return 0, nu, grid, -(-groups // grid)


def _gemm_plan(M: int, N: int, K: int, sms: int) -> Tuple[int, int]:
    """``(splits, kc)`` of an fp32 GEMM launch: 128 x 128 output tiles, two
    blocks an SM.  Where the tiles would leave more than half the SMs
    without a block, K is split into ranges of ``kc`` (a multiple of the
    16-deep chunk, at least 8 chunks) so that tiles x splits fills the
    card's block slots (the launch is cooperative: its blocks sum the
    ranges' partial tiles in range order after a grid barrier); at half
    the SMs or more the sum's traffic costs more than the idle SMs
    (scan_gates and scan_xw at H = 512 on an H100)."""
    tiles = -(-M // GEMM_TILE) * -(-N // GEMM_TILE)
    chunks = -(-K // GEMM_K)
    splits = max(1, min(2 * sms // tiles, chunks // 8)) if 2 * tiles <= sms else 1
    kc = -(-chunks // splits) * GEMM_K
    return -(-K // kc), kc


_SMS = {}
_PLANS = {}
_GEMM_PLANS = {}


def _gemm(A: Tensor, Bm: Tensor, bias: Optional[Tensor], C: Tensor, kn: bool,
          compute_dtype) -> None:
    """``C = A @ Bm (+ bias)`` by ``scan_gemm_kernel`` (``kn``: ``Bm`` is
    ``[K, N]``; else it is given as its transpose ``[N, K]``), fp32 with K
    split as ``_gemm_plan`` says."""
    M, K = A.shape
    N = C.shape[1]
    if K % 4 or N % 4:
        raise ValueError(f"scan GEMM needs K % 4 == 0 and N % 4 == 0 (K={K}, N={N})")
    mode = _mode(compute_dtype)
    splits, kc, ws = 1, K, None
    if not mode:
        key = (M, N, K, A.device.index)
        if key not in _GEMM_PLANS:
            dev = A.device.index or 0
            if dev not in _SMS:
                _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
            _GEMM_PLANS[key] = _gemm_plan(M, N, K, _SMS[dev])
        splits, kc = _GEMM_PLANS[key]
        if splits > 1:
            ws = torch.empty((splits, M, N), dtype=torch.float32, device=A.device)
    err = _build.lib().jlm_scan_gemm(
        _ptr(A), A.stride(0), _ptr(Bm), Bm.stride(0), _ptr(bias), _ptr(C), C.stride(0),
        M, N, K, int(kn), splits, kc, _ptr(ws), mode, _build.stream_ptr(A))
    _build.check(err, "scan_gemm kernel")


def _xw_launch(xs: Tensor, Wx: Tensor, compute_dtype) -> Tensor:
    """Zx [M, 4H] from contiguous fp32 ``xs [M, E]`` and ``Wx [E, 4H]``."""
    Zx = torch.empty((xs.shape[0], Wx.shape[1]), dtype=torch.float32, device=xs.device)
    if xs.shape[0]:
        _gemm(xs, Wx, None, Zx, True, compute_dtype)
        scan_xw.launches += 1
    return Zx


def _gates_launch(xh: Tensor, W: Tensor, b: Tensor, compute_dtype) -> Tensor:
    """Z [M, 4H] from contiguous fp32 ``xh [M, E+H]``, W, b on the card."""
    Z = torch.empty((xh.shape[0], W.shape[1]), dtype=torch.float32, device=xh.device)
    if xh.shape[0]:
        _gemm(xh, W, b, Z, True, compute_dtype)
        scan_gates.launches += 1
    return Z


def _dx_launch(dz: Tensor, Wx: Tensor, compute_dtype) -> Tensor:
    """dx [M, E] from contiguous fp32 ``dz [M, 4H]`` and ``Wx [E, 4H]``."""
    dx = torch.empty((dz.shape[0], Wx.shape[0]), dtype=torch.float32, device=dz.device)
    if dz.shape[0]:
        _gemm(dz, Wx, None, dx, False, compute_dtype)
        scan_dx.launches += 1
    return dx


def _kept_plan(H: int, compute_dtype, device, nu: Optional[int], fwd: bool):
    """``_plan``, kept per (H, mode, device, nu, direction): the card's
    occupancy does not change."""
    key = (H, _mode(compute_dtype), device.index, nu, fwd)
    if key not in _PLANS:
        _PLANS[key] = _plan(H, compute_dtype, device, nu, fwd)
    return _PLANS[key]


def _fwd_recur_launch(Zx, Wh, b, c0, h0, forget_bias, compute_dtype, nu):
    """``scan_fwd_recur``'s launch on checked contiguous fp32 operands."""
    B, T, H4 = Zx.shape
    H, dev = H4 // 4, Zx.device
    hs = torch.empty((B, T, H), dtype=torch.float32, device=dev)
    cs = torch.empty((B, T, H), dtype=torch.float32, device=dev)
    c_T = torch.empty((B, H), dtype=torch.float32, device=dev)
    h_T = torch.empty((B, H), dtype=torch.float32, device=dev)
    if B * T == 0:
        return hs, cs, c0.clone(), h0.clone()
    resident, nu, grid, nvb = _kept_plan(H, compute_dtype, dev, nu, True)
    err = _build.lib().jlm_scan_fwd_recur(
        _ptr(Zx), _ptr(Wh), _ptr(b), _ptr(c0), _ptr(h0), _ptr(hs), _ptr(cs), _ptr(c_T),
        _ptr(h_T), B, T, H, ctypes.c_float(forget_bias), _mode(compute_dtype), resident, nu,
        grid, nvb, _build.stream_ptr(Zx))
    _build.check(err, "scan_fwd_recur kernel")
    scan_fwd_recur.launches += 1
    return hs, cs, c_T, h_T


def _recur_launch(Z, out, Wh, c0, cs, d_hs, d_cf, d_hf, forget_bias, compute_dtype, nu):
    """``scan_recur``'s launch on checked contiguous fp32 operands."""
    B, T, H4 = Z.shape
    H, dev = H4 // 4, Z.device
    mode = _mode(compute_dtype)
    dc0 = torch.empty((B, H), dtype=torch.float32, device=dev)
    dh0 = torch.empty((B, H), dtype=torch.float32, device=dev)
    if B * T == 0:
        return out, d_cf.clone(), d_hf.clone()
    resident, nu, grid, nvb = _kept_plan(H, compute_dtype, dev, nu, False)
    dzb = torch.empty(Z.shape, dtype=torch.bfloat16, device=dev) if mode else None
    err = _build.lib().jlm_scan_recur(
        _ptr(Z), _ptr(out), _ptr(dzb), _ptr(Wh), _ptr(cs), _ptr(c0), _ptr(d_hs), _ptr(d_cf),
        _ptr(d_hf), _ptr(dc0), _ptr(dh0), B, T, H, ctypes.c_float(forget_bias), mode, resident,
        nu, grid, nvb, _build.stream_ptr(Z))
    _build.check(err, "scan_recur kernel")
    scan_recur.launches += 1
    return out, dc0, dh0


def scan_xw(xs: Tensor, Wx: Tensor, compute_dtype=torch.float32) -> Tensor:
    """``Zx = xs Wx``: ``xs [..., E]``, ``Wx [E, 4H]`` (W's x rows, read as
    they lie) -> ``[..., 4H]`` fp32, no bias: the forward's input product of
    every step as one GEMM.

    ``scan_xw.launches`` counts launches of its kernel."""
    if not xs.is_cuda:
        return scan_xw_ref(xs, Wx, compute_dtype)
    _mode(compute_dtype)
    E, H4 = Wx.shape
    lead = xs.shape[:-1]
    A = _f32(xs, (*lead, E), xs.device, "xs").reshape(-1, E)
    return _xw_launch(A, _f32(Wx, (E, H4), xs.device, "Wx"), compute_dtype).reshape(*lead, H4)


def scan_fwd_recur(Zx: Tensor, Wh: Tensor, b: Tensor, c0: Tensor, h0: Tensor,
                   forget_bias: float = 1.0, compute_dtype=torch.float32,
                   nu: Optional[int] = None):
    """The forward's recurrence over the input products ``Zx [B,T,4H]``
    (``Wh [H, 4H]``, W's h rows; ``b [4H]``): ``(hs [B,T,H], cs [B,T,H],
    c_T [B,H], h_T [B,H])``, fp32.  ``nu`` sets the units a block on the
    card (``_plan``); unused on the CPU.

    ``scan_fwd_recur.launches`` counts launches of its kernel."""
    if not Zx.is_cuda:
        return scan_fwd_recur_ref(Zx, Wh, b, c0, h0, forget_bias, compute_dtype)
    _mode(compute_dtype)
    B, T, H4 = Zx.shape
    H, dev = H4 // 4, Zx.device
    if H4 % 16:
        raise ValueError(f"scan_fwd_recur needs H % 4 == 0, got Zx {tuple(Zx.shape)}")
    return _fwd_recur_launch(
        _f32(Zx, (B, T, H4), dev, "Zx"), _f32(Wh, (H, H4), dev, "Wh"), _f32(b, (H4,), dev, "b"),
        _f32(c0, (B, H), dev, "c0"), _f32(h0, (B, H), dev, "h0"), forget_bias, compute_dtype, nu)


def lstm_scan_fwd(xs: Tensor, W: Tensor, b: Tensor, c0: Tensor, h0: Tensor,
                  forget_bias: float = 1.0, compute_dtype=torch.float32):
    """``(hs [B,T,H], cs [B,T,H], c_T [B,H], h_T [B,H])``, fp32, as two
    stages: ``scan_xw`` (xs Wx over all B T rows) and ``scan_fwd_recur``; cs
    is what the backward needs besides hs.

    ``lstm_scan_fwd.launches`` counts calls that launched the two kernels."""
    B, T, E = xs.shape
    H = h0.shape[-1]
    if not xs.is_cuda:
        return scan_fwd_recur(scan_xw(xs, W[:E], compute_dtype), W[E:], b, c0, h0,
                              forget_bias, compute_dtype)
    _mode(compute_dtype)
    dev = xs.device
    xs = xs.float().contiguous()
    W = _f32(W, (E + H, 4 * H), dev, "W")
    b = _f32(b, (4 * H,), dev, "b")
    c0, h0 = _f32(c0, (B, H), dev, "c0"), _f32(h0, (B, H), dev, "h0")
    if E % PAD or H % PAD:
        hs, cs, c_T, h_T = lstm_scan_fwd(*pad_scan(xs, W, b, c0, h0), forget_bias,
                                         compute_dtype)
        return tuple(t[..., :H].contiguous() for t in (hs, cs, c_T, h_T))
    Zx = _xw_launch(xs.view(B * T, E), W[:E], compute_dtype).view(B, T, 4 * H)
    out = _fwd_recur_launch(Zx, W[E:], b, c0, h0, forget_bias, compute_dtype, None)
    if B * T:
        lstm_scan_fwd.launches += 1
    return out


def scan_gates(xh: Tensor, W: Tensor, b: Tensor, compute_dtype=torch.float32) -> Tensor:
    """``Z = [x; h_prev] W + b`` over ``xh [..., E+H]`` -> ``[..., 4H]``
    fp32: the backward's gate recompute of every step as one product.

    ``scan_gates.launches`` counts launches of its kernel."""
    if not xh.is_cuda:
        return scan_gates_ref(xh, W, b, compute_dtype)
    _mode(compute_dtype)
    K, N = W.shape
    lead = xh.shape[:-1]
    A = _f32(xh, (*lead, K), xh.device, "xh").reshape(-1, K)
    Z = _gates_launch(A, _f32(W, (K, N), xh.device, "W"), _f32(b, (N,), xh.device, "b"),
                      compute_dtype)
    return Z.reshape(*lead, N)


def scan_dx(dz: Tensor, Wx: Tensor, compute_dtype=torch.float32) -> Tensor:
    """``dx = dz Wx^T``: ``dz [..., 4H]``, ``Wx [E, 4H]`` (W's x rows, read
    as they lie) -> ``[..., E]`` fp32.

    ``scan_dx.launches`` counts launches of its kernel."""
    if not dz.is_cuda:
        return scan_dx_ref(dz, Wx, compute_dtype)
    _mode(compute_dtype)
    E, H4 = Wx.shape
    lead = dz.shape[:-1]
    A = _f32(dz, (*lead, H4), dz.device, "dz").reshape(-1, H4)
    return _dx_launch(A, _f32(Wx, (E, H4), dz.device, "Wx"), compute_dtype).reshape(*lead, E)


def scan_recur(Z: Tensor, Wh: Tensor, c0: Tensor, cs: Tensor, d_hs: Tensor, d_cf: Tensor,
               d_hf: Tensor, forget_bias: float = 1.0, compute_dtype=torch.float32,
               out: Optional[Tensor] = None, nu: Optional[int] = None):
    """The backward's recurrence over the recomputed gates ``Z [B,T,4H]``
    (``Wh [H, 4H]``, W's h rows): ``(dz [B,T,4H], dc0 [B,H], dh0 [B,H])``,
    fp32.  On the card dz is written into ``out`` (``Z`` itself may be
    given: each step reads its gates before it writes them); ``nu`` sets the
    units a block (``_plan``).  On the CPU both are unused and dz is a
    new tensor.

    ``scan_recur.launches`` counts launches of its kernel."""
    if not Z.is_cuda:
        return scan_recur_ref(Z, Wh, c0, cs, d_hs, d_cf, d_hf, forget_bias, compute_dtype)
    _mode(compute_dtype)
    B, T, H4 = Z.shape
    H, dev = H4 // 4, Z.device
    if H4 % 4 or Z.dtype != torch.float32 or not Z.is_contiguous():
        raise ValueError(f"scan_recur needs a contiguous fp32 Z [B, T, 4H], got "
                         f"{tuple(Z.shape)} {Z.dtype}")
    if out is None:
        out = torch.empty_like(Z)
    elif out.shape != Z.shape or out.dtype != torch.float32 or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous fp32 {tuple(Z.shape)}")
    return _recur_launch(Z, out, _f32(Wh, (H, H4), dev, "Wh"), _f32(c0, (B, H), dev, "c0"),
                         _f32(cs, (B, T, H), dev, "cs"), _f32(d_hs, (B, T, H), dev, "d_hs"),
                         _f32(d_cf, (B, H), dev, "d_cf"), _f32(d_hf, (B, H), dev, "d_hf"),
                         forget_bias, compute_dtype, nu)


def lstm_scan_bwd(xs: Tensor, W: Tensor, b: Tensor, c0: Tensor, h0: Tensor,
                  hs: Tensor, cs: Tensor, d_hs: Tensor, d_cf: Tensor, d_hf: Tensor,
                  forget_bias: float = 1.0, compute_dtype=torch.float32,
                  xh: Optional[Tensor] = None):
    """``(dz [B,T,4H], dx [B,T,E], dc0 [B,H], dh0 [B,H])``, fp32, as three
    stages: ``scan_gates`` (into the dz buffer), ``scan_recur`` (dz over the
    gates, in place) and ``scan_dx``.  ``xh`` is ``[x; h_prev]`` ``[B, T,
    E+H]`` where the caller has it (the autograd Function builds it for dW
    too); it is built here otherwise.

    ``lstm_scan_bwd.launches`` counts calls that launched the three kernels."""
    B, T, E = xs.shape
    H = h0.shape[-1]
    if not xs.is_cuda:
        if xh is None:
            xh = torch.cat([xs.float(), _h_prev(h0, hs)], dim=2)
        Z = scan_gates(xh, W, b, compute_dtype)
        dz, dc0, dh0 = scan_recur(Z, W[E:], c0, cs, d_hs, d_cf, d_hf, forget_bias,
                                  compute_dtype)
        return dz, scan_dx(dz, W[:E], compute_dtype), dc0, dh0
    _mode(compute_dtype)
    dev = xs.device
    xs = xs.float().contiguous()
    W = _f32(W, (E + H, 4 * H), dev, "W")
    b = _f32(b, (4 * H,), dev, "b")
    c0, h0 = _f32(c0, (B, H), dev, "c0"), _f32(h0, (B, H), dev, "h0")
    hs, cs, d_hs = (_f32(t, (B, T, H), dev, n) for t, n in
                    ((hs, "hs"), (cs, "cs"), (d_hs, "d_hs")))
    d_cf, d_hf = _f32(d_cf, (B, H), dev, "d_cf"), _f32(d_hf, (B, H), dev, "d_hf")
    if E % PAD or H % PAD:
        pad = torch.nn.functional.pad
        Hp = _round4(H)
        dz, dx, dc0, dh0 = lstm_scan_bwd(
            *pad_scan(xs, W, b, c0, h0),
            *(pad(t, (0, Hp - H)) for t in (hs, cs, d_hs, d_cf, d_hf)),
            forget_bias, compute_dtype)
        return (unpad_gates(dz, H).contiguous(), dx[..., :E].contiguous(),
                dc0[:, :H].contiguous(), dh0[:, :H].contiguous())
    xh = (torch.cat([xs, _h_prev(h0, hs)], dim=2) if xh is None
          else _f32(xh, (B, T, E + H), dev, "xh"))
    Z = _gates_launch(xh.view(B * T, E + H), W, b, compute_dtype).view(B, T, 4 * H)
    dz, dc0, dh0 = _recur_launch(Z, Z, W[E:], c0, cs, d_hs, d_cf, d_hf, forget_bias,
                                 compute_dtype, None)
    dx = _dx_launch(dz.view(B * T, 4 * H), W[:E], compute_dtype).view(B, T, E)
    if B * T:
        lstm_scan_bwd.launches += 1
    return dz, dx, dc0, dh0


lstm_scan_fwd.launches = lstm_scan_bwd.launches = 0
scan_xw.launches = scan_fwd_recur.launches = 0
scan_gates.launches = scan_recur.launches = scan_dx.launches = 0


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
        xh = torch.cat([xs.float(), _h_prev(h0, hs)], dim=2)
        dz, dx, dc0, dh0 = lstm_scan_bwd(xs, W, b, c0, h0, hs, cs, d_hs, d_cf, d_hf,
                                         ctx.forget_bias, ctx.compute_dtype, xh=xh)
        dW = xh.reshape(B * T, -1).t() @ dz.reshape(B * T, -1)
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
