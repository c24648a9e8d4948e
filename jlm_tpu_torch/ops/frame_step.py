"""Fused decode-frame row step: the LSTM cell and the candidate dots.

Counterpart of :mod:`jlm_tpu.ops.frame_step` (its ``_cell_cand_kernel``):
one cell step over the ``R = S * B`` sentence-major beam rows, ``z = [x, h]
@ W + b`` with gates i, j, f, o and fp32 accumulation, then per sentence
``cand[s] = h'[s] @ cols[s]^T + cbias[s]`` against the pre-gathered
candidate columns (the ``prepare`` payload's frame slice, EOS last).  The
dots read h' rounded to the compute dtype, the value the split frame's
``cand_dot`` reads.  Returns ``(c' fp32 [R, H], h' compute dtype [R, H],
cand fp32 [S, B, C1])``.

On a CUDA tensor the wrapper launches ``csrc/cell_cand.cu`` (bf16 compute
on ``wgmma`` + TMA, reading the cell's gate-tiled weight copy
``cell_weight_tiles``, or exact fp32 compute on the CUDA cores) or raises;
on a CPU tensor it runs the plain version ``cell_cand_ref``.  The kernel
holds at most 16 beam rows of a sentence: wider beams go in groups of at
most 16 rows (``beam_groups``), one launch each, the rows of each group
gathered into their own ``[S * b, ...]`` operands.  Any E and H: the bf16
kernel takes multiples of 8, the fp32 kernel multiples of 32; other widths
are zero-padded as the cell pads them (``lstm_cell.pad_cell``), ``cols``
with zero columns, and sliced back.  Both kernels give each block a unit
group of a few whole sentences and sum the groups' candidate dots in
group order through a scratch buffer (``partial_sums_shape``), so the
logits come out the same on every run.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from jlm_tpu_torch.ops import _build
from jlm_tpu_torch.ops.cand_dot import beam_groups
from jlm_tpu_torch.ops.lstm_cell import (
    _aligned, _round_up, cell_weight_tiles, lstm_cell_ref, pad_cell)
from jlm_tpu_torch.ops.project import pad_cols

_MAX_B = 16  # beam rows per sentence: one m16 tile of the candidate dot
_MAX_C1 = 256  # candidate columns per sentence: one TMA box of the bf16 kernel
# (row slots, hidden units) of a block: G = rows // B whole sentences
_BLOCK = {torch.bfloat16: (128, 64), torch.float32: (64, 32)}
_done = {}  # device index -> the kernels' zeroed counters (each launch leaves them zeroed)


def partial_sums_shape(S: int, B: int, H: int, C1: int, dtype) -> Tuple[int, int, int]:
    """``(sentence blocks, unit groups, floats a block)`` of the kernel's
    scratch of partial candidate sums in compute ``dtype``: the grid is
    unit groups x sentence blocks, and a block's slice holds its ``G B C1``
    dots, rounded up to whole float4s."""
    rows, units = _BLOCK[dtype]
    G = rows // B
    return -(-S // G), -(-H // units), -(-G * B * C1 // 4) * 4


def _counters(device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 counters on ``device``, kept between
    calls: each launch counts its blocks in them and zeroes them again (so
    two launches must not run at once on two streams)."""
    kept = _done.get(device.index)
    if kept is None or kept.numel() < n:
        kept = _done[device.index] = torch.zeros(max(n, 4096), dtype=torch.int32,
                                                 device=device)
    return kept


def cell_cand_ref(x, h, c, W, b, cols, cbias, B: int, forget_bias: float = 1.0, *,
                  compute_dtype=torch.float32):
    """Plain version: the plain cell, h' rounded to ``compute_dtype``, and
    an fp32 batched product of it with the candidate columns."""
    c_new, h_new = lstm_cell_ref(x, h, c, W, b, forget_bias)
    hc = h_new.to(compute_dtype)
    S = cols.shape[0]
    cand = (torch.einsum("sbh,sch->sbc", hc.float().reshape(S, B, -1), cols.float())
            + cbias.float()[:, None, :])
    return c_new, hc, cand


def _launch(x, h, c, W, b, cols, cbias, B, forget_bias):
    """Pad E and H to the kernel's multiples where needed, launch, slice
    back."""
    R, E = x.shape
    H = h.shape[1]
    f32 = x.dtype == torch.float32
    if tuple(W.shape) != (E + H, 4 * H):
        raise ValueError(f"W must be [{E + H}, {4 * H}], got {tuple(W.shape)}")
    w = W if f32 else cell_weight_tiles(W, E, H)
    Ep, Hp = (_round_up(E, 32), _round_up(H, 32)) if f32 else (_round_up(E, 8),
                                                               _round_up(H, 8))
    if (Ep, Hp) == (E, H):
        return _launch_aligned(x, h, c, w, b, cols, cbias, B, forget_bias)
    x, h, c, Wp, b = pad_cell(x, h, c, W if f32 else None, b, Ep, Hp)
    c_new, h_new, cand = _launch_aligned(x, h, c, Wp if f32 else w, b, pad_cols(cols, Hp),
                                         cbias, B, forget_bias)
    return c_new[:, :H].contiguous(), h_new[:, :H].contiguous(), cand


def _launch_aligned(x, h, c, w, b, cols, cbias, B, forget_bias):
    """Check and launch; w is W (fp32) or its bf16 gate copy."""
    R, E = x.shape
    H = h.shape[1]
    S, C1 = cols.shape[:2]
    f32 = x.dtype == torch.float32
    if c.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"c dtype {c.dtype}")
    if R != S * B or not 1 <= B <= _MAX_B:
        raise ValueError(f"need R = S * B with B <= {_MAX_B}, got R={R} S={S} B={B}")
    if not f32 and not 1 <= C1 <= _MAX_C1:
        raise ValueError(f"the bf16 kernel takes 1 to {_MAX_C1} candidate columns, not {C1}")
    w_shape = ((E + H, 4 * H) if f32 else
               (4 * _round_up(H, 64), _round_up(E, 64) + _round_up(H, 64)))
    if not f32:
        x, h, w, cols = (_aligned(t) for t in (x, h, w, cols))
    shapes = {"h": (h, (R, H)), "c": (c, (R, H)), "W": (w, w_shape),
              "b": (b, (4 * H,)), "cols": (cols, (S, C1, H)), "cbias": (cbias, (S, C1))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {shape} on {x.device}")
    if b.dtype != torch.float32 or cbias.dtype != torch.float32:
        raise ValueError("b and cbias must be fp32")
    c_new = torch.empty((R, H), dtype=torch.float32, device=x.device)
    h_new = torch.empty((R, H), dtype=x.dtype, device=x.device)
    cand = torch.empty((S, B, C1), dtype=torch.float32, device=x.device)
    if S:
        P = ctypes.c_void_p
        # each unit group's partial candidate sums, and their counters
        n_sb, n_ug, pstride = partial_sums_shape(S, B, H, C1, x.dtype)
        scratch = cand.new_empty((n_sb * n_ug * pstride,))
        done = _counters(x.device, n_sb)
        err = _build.lib().jlm_cell_cand(
            P(x.data_ptr()), P(h.data_ptr()), P(c.data_ptr()), int(c.dtype == torch.float32),
            P(w.data_ptr()), P(b.data_ptr()), P(cols.data_ptr()), P(cbias.data_ptr()),
            P(c_new.data_ptr()), P(h_new.data_ptr()), P(cand.data_ptr()),
            P(scratch.data_ptr()), P(done.data_ptr()),
            S, B, E, H, C1, int(f32), float(forget_bias), P(_build.stream_ptr(x)),
        )
        _build.check(err, "cell_cand kernel")
        cell_cand_step.launches += 1
    return c_new, h_new, cand


def cell_cand_step(
    x: torch.Tensor,  # [R, E] (R = S*B, sentence-major beam rows)
    h: torch.Tensor,  # [R, H]
    c: torch.Tensor,  # [R, H] fp32 or bf16
    W: torch.Tensor,  # [(E+H), 4H]
    b: torch.Tensor,  # [4H] fp32
    cols: torch.Tensor,  # [S, C1, H] candidate columns (the payload's frame slice)
    cbias: torch.Tensor,  # [S, C1] fp32
    B: int,
    forget_bias: float = 1.0,
    *,
    compute_dtype=torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused frame row step: ``(c', h', cand)``; ``cand`` holds the raw
    candidate logits with bias (the caller subtracts the lse).

    ``cell_cand_step.launches`` counts kernel launches: one per group of
    beam rows."""
    x, h, W, cols = (t.to(compute_dtype) for t in (x, h, W, cols))
    if not x.is_cuda:
        return cell_cand_ref(x, h, c, W, b, cols, cbias, B, forget_bias,
                             compute_dtype=compute_dtype)
    if compute_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the cell_cand kernel computes in bf16 or fp32, not {compute_dtype}")
    groups = beam_groups(B, _MAX_B)
    if len(groups) == 1 or x.shape[0] != cols.shape[0] * B:
        return _launch(x.contiguous(), h.contiguous(), c, W.contiguous(), b,
                       cols.contiguous(), cbias, B, forget_bias)
    S = cols.shape[0]

    def rows(t, b0, b1):  # the group's beam rows of every sentence
        return t.reshape(S, B, -1)[:, b0:b1].reshape(S * (b1 - b0), -1).contiguous()

    parts = [_launch(rows(x, b0, b1), rows(h, b0, b1), rows(c, b0, b1), W.contiguous(), b,
                     cols.contiguous(), cbias, b1 - b0, forget_bias) for b0, b1 in groups]
    c_new, h_new = (torch.cat([p[i].reshape(S, b1 - b0, -1)
                               for p, (b0, b1) in zip(parts, groups)], dim=1).reshape(S * B, -1)
                    for i in (0, 1))
    return c_new, h_new, torch.cat([p[2] for p in parts], dim=1)


cell_cand_step.launches = 0
