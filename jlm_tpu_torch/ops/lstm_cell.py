"""Fused single-step LSTM cell for the decode frame.

Counterpart of :mod:`jlm_tpu.ops.lstm_cell` (its ``_cell_kernel``): one
step ``z = [x, h] @ W + b`` with gates i, j, f, o, fp32 accumulation, and
``c' = sigmoid(f + forget_bias) * c + sigmoid(i) * tanh(j)``,
``h' = sigmoid(o) * tanh(c')``.  ``c`` is read in its own dtype, ``c'`` is
returned in ``c_out_dtype`` (default fp32) and ``h'`` in ``compute_dtype``.

On a CUDA tensor the wrapper launches ``csrc/lstm_cell.cu`` (bf16 compute
on ``wgmma`` with TMA loads, or exact fp32 compute on the CUDA cores) or
raises; on a CPU tensor it runs the plain version.  The bf16 kernel reads
the weight as its gate-tiled copy (:func:`cell_weight_tiles`), which is
kept on the weight tensor and remade only after the weight changes in
place; ``build_decode_head`` makes it once per layer.  A caller that hands
a weight in another dtype gets a new cast, and so a new copy, every call.

Any E and H: the fp32 kernel takes multiples of 32, the bf16 kernel
multiples of 8 (TMA's 16-byte rows), and the wrapper zero-pads other
widths (``pad_cell``): zero columns of x and rows of W for E; for H zero
units — zero columns of h and c, zero gate columns and rows of W (the gate
copy is already zero past H) and zero bias — whose c' and h' stay 0, so the
units kept are unchanged; the outputs are sliced back.  An aligned width
launches with no copy.
"""

from __future__ import annotations

from typing import Tuple

import torch

from jlm_tpu_torch.ops import _build

UNITS = 64  # hidden units per block of the bf16 kernel (4 gates: 256 columns)
KC = 64     # K per stage of the bf16 kernel


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def lstm_cell_ref(x, h, c, W, b, forget_bias: float = 1.0):
    """Plain cell in fp32 on the given values (mirrors ``lstm_cell_ref``)."""
    z = torch.cat([x, h], dim=1).float() @ W.float() + b.float()
    i, j, f, o = z.chunk(4, dim=1)
    c_new = torch.sigmoid(f + forget_bias) * c.float() + torch.sigmoid(i) * torch.tanh(j)
    return c_new, torch.sigmoid(o) * torch.tanh(c_new)


def pad_gates(W: torch.Tensor, E: int, H: int, Ep: int, Hp: int) -> torch.Tensor:
    """``W [E+H, 4H]`` zero-padded to ``[Ep + Hp, 4, Hp]``: x's rows up to
    ``Ep``, h's rows up to ``Hp`` and each gate's columns up to ``Hp``."""
    pad = torch.nn.functional.pad
    Wg = pad(W.reshape(E + H, 4, H), (0, Hp - H))  # [K, gate, Hp]
    return torch.cat([pad(Wg[:E], (0, 0, 0, 0, 0, Ep - E)),
                      pad(Wg[E:], (0, 0, 0, 0, 0, Hp - H))])


def pad_cell(x, h, c, W, b, Ep: int, Hp: int):
    """The cell's operands zero-padded to ``Ep`` inputs and ``Hp`` units
    (``W`` to ``[Ep + Hp, 4 Hp]``, ``b`` per gate); ``W`` may be None (the
    bf16 kernel reads its gate copy, already zero past H)."""
    E, H = x.shape[1], h.shape[1]
    pad = torch.nn.functional.pad
    x, h, c = pad(x, (0, Ep - E)), pad(h, (0, Hp - H)), pad(c, (0, Hp - H))
    b = pad(b.reshape(4, H), (0, Hp - H)).reshape(4 * Hp)
    if W is not None:
        W = pad_gates(W, E, H, Ep, Hp).reshape(Ep + Hp, 4 * Hp)
    return x, h, c, W, b


def _tiles(W: torch.Tensor, E: int, H: int) -> torch.Tensor:
    Ex, Hp = _round_up(E, KC), _round_up(H, UNITS)
    return (pad_gates(W, E, H, Ex, Hp).reshape(Ex + Hp, 4, Hp // UNITS, UNITS)
            .permute(2, 1, 3, 0).reshape(4 * Hp, Ex + Hp).contiguous())


def cell_weight_tiles(W: torch.Tensor, E: int, H: int) -> torch.Tensor:
    """The bf16 kernel's copy of ``W [E+H, 4H]``: ``[4 Hp, Ex + Hp]``,
    K-major, with ``Ex`` and ``Hp`` = E and H rounded up to 64.  Row
    ``ub*256 + g*64 + u`` is gate g's column for unit ``ub*64 + u``, so a
    block of 64 units reads its four gates as one 256-row tile; K holds
    x's rows of W, zeros up to ``Ex``, then h's rows, zeros up to ``Hp``.
    Units past H are zero rows.  The copy is kept on ``W`` and remade when
    W's version counter moves (an inference tensor has none: its copy is
    made on every call)."""
    if W.is_inference():
        return _tiles(W, E, H)
    kept = getattr(W, "_cell_tiles", None)
    if kept is None or kept[0] != W._version:
        kept = W._cell_tiles = (W._version, _tiles(W, E, H))
    return kept[1]


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (TMA's rule)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch_any(x, h, c, W, b, forget_bias, c_out_dtype):
    """Pad to the kernel's widths where needed, launch, slice back; x, h
    and W are contiguous in the compute dtype."""
    R, E = x.shape
    H = h.shape[1]
    f32 = x.dtype == torch.float32
    if c_out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"c_out_dtype {c_out_dtype}")
    if c.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"c dtype {c.dtype}")
    if W.shape != (E + H, 4 * H):
        raise ValueError(f"W must be [{E + H}, {4 * H}], got {tuple(W.shape)}")
    m = 32 if f32 else 8  # the kernel's width multiple
    if E % m or H % m:
        Ep, Hp = _round_up(E, m), _round_up(H, m)
        if f32:
            x, h, c, W, b = pad_cell(x, h, c, W, b, Ep, Hp)
        else:
            w = cell_weight_tiles(W, E, H)
            x, h, c, _, b = pad_cell(x, h, c, None, b, Ep, Hp)
        c_new, h_new = _launch(x, h, c, W if f32 else w, b, forget_bias, c_out_dtype,
                               tiles=not f32)
        return c_new[:, :H].contiguous(), h_new[:, :H].contiguous()
    return _launch(x, h, c, W, b, forget_bias, c_out_dtype)


def _launch(x, h, c, W, b, forget_bias, c_out_dtype, tiles: bool = False):
    """Check and launch at aligned widths; x, h and W are contiguous in the
    compute dtype (with ``tiles``, W is already the bf16 gate copy).
    Straight-line checks: this Python runs before every launch, and a
    one-call time counts it."""
    R, E = x.shape
    H = h.shape[1]
    f32 = x.dtype == torch.float32
    if f32:
        w, w_shape = W, (E + H, 4 * H)
    else:
        w = _aligned(W if tiles else cell_weight_tiles(W, E, H))
        w_shape = (4 * _round_up(H, UNITS), _round_up(E, KC) + _round_up(H, UNITS))
        x, h = _aligned(x), _aligned(h)
    dev = x.device
    for name, t, shape in (("h", h, (R, H)), ("c", c, (R, H)), ("b", b, (4 * H,)),
                           ("W", w, w_shape)):
        if t.shape != shape or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {shape} on {dev}")
    if b.dtype != torch.float32:
        raise ValueError("b must be fp32")
    ptrs = [t.data_ptr() for t in (x, h, c, w, b)]
    if f32 and (ptrs[0] | ptrs[1] | ptrs[2] | ptrs[3] | ptrs[4]) % 16:
        # the fp32 kernel's cp.async moves 16-byte pieces of all five
        x, h, c, w, b = (_aligned(t) for t in (x, h, c, w, b))
        ptrs = [t.data_ptr() for t in (x, h, c, w, b)]
    # new_empty: less Python before the launch than torch.empty(..., device=)
    h_new = h.new_empty((R, H))
    c_new = h.new_empty((R, H)) if c_out_dtype == h.dtype else h.new_empty(
        (R, H), dtype=c_out_dtype)
    if R:
        lib = _build.lib()
        entry = lib.jlm_lstm_cell_f32 if f32 else lib.jlm_lstm_cell_bf16
        err = entry(
            ptrs[0], ptrs[1], ptrs[2], int(c.dtype == torch.float32), ptrs[3], ptrs[4],
            c_new.data_ptr(), int(c_out_dtype == torch.float32), h_new.data_ptr(),
            R, E, H, float(forget_bias), _build.stream_ptr(x),
        )
        _build.check(err, "lstm_cell kernel")
        lstm_cell_step.launches += 1
        lstm_cell_step.shapes[R, E] = lstm_cell_step.shapes.get((R, E), 0) + 1
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

    ``lstm_cell_step.launches`` counts kernel launches;
    ``lstm_cell_step.shapes`` counts the same by ``(R, E)``, the rows and
    the input width as launched (E padded to the kernel's multiple).
    """
    c_out_dtype = torch.float32 if c_out_dtype is None else c_out_dtype
    if x.dtype != compute_dtype:
        x = x.to(compute_dtype)
    if h.dtype != compute_dtype:
        h = h.to(compute_dtype)
    if W.dtype != compute_dtype:
        W = W.to(compute_dtype)
    if x.is_cuda:
        if compute_dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"lstm_cell kernel computes in bf16 or fp32, not {compute_dtype}")
        return _launch_any(x.contiguous(), h.contiguous(), c, W.contiguous(), b,
                           forget_bias, c_out_dtype)
    c_new, h_new = lstm_cell_ref(x, h, c, W, b, forget_bias)
    return c_new.to(c_out_dtype), h_new.to(compute_dtype)


lstm_cell_step.launches = 0
lstm_cell_step.shapes = {}
