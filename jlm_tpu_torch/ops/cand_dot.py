"""Per-sentence candidate-column scoring for the decode frame.

Counterpart of :mod:`jlm_tpu.ops.cand_dot` (its ``_cand_kernel``):
``out[s] = h3[s] @ cols[s]^T + bias[s]`` — ``h3 [S, B, H]`` beam states,
``cols [S, C1, H]`` the sentence's candidate head rows (EOS last),
``bias [S, C1]`` fp32 — returning ``[S, B, C1]`` fp32.

On a CUDA tensor the wrapper launches ``csrc/cand_dot.cu`` (bf16 or fp32,
fp32 accumulation) or raises; on a CPU tensor it runs the plain version.
The kernel holds at most 16 beam rows of a sentence: wider beams go in
groups of at most 16 rows (``beam_groups``), one launch each; a hidden size
that is not a multiple of 4 is zero-padded (``pad_cols``), which leaves
every dot unchanged.
"""

from __future__ import annotations

import ctypes

import torch

from jlm_tpu_torch.ops import _build
from jlm_tpu_torch.ops.project import pad_cols

_MAX_B = 16  # beam rows per sentence the kernel holds in registers


def beam_groups(B: int, size: int = _MAX_B):
    """``[(first, end), ...]``: the beam rows of a sentence in groups of at
    most ``size``."""
    return [(b, min(b + size, B)) for b in range(0, B, size)]


def cand_dot_ref(h3, cols, bias) -> torch.Tensor:
    """Plain version: fp32 batched matmul plus bias."""
    return torch.einsum("sbh,sch->sbc", h3.float(), cols.float()) + bias.float()[:, None, :]


def cand_dot(h3: torch.Tensor, cols: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Per-sentence candidate logits ``[S, B, C1]`` fp32 (bias added).

    ``cand_dot.launches`` counts kernel launches: one per group of beam
    rows.
    """
    if not h3.is_cuda:
        return cand_dot_ref(h3, cols, bias)
    S, B, H = h3.shape
    C1 = cols.shape[1]
    if h3.dtype not in (torch.bfloat16, torch.float32) or cols.dtype != h3.dtype:
        raise ValueError(f"h3/cols must share bf16 or fp32, got {h3.dtype}/{cols.dtype}")
    if bias.dtype != torch.float32:
        raise ValueError("bias must be fp32")
    for name, t, shape in (("h3", h3, (S, B, H)), ("cols", cols, (S, C1, H)),
                           ("bias", bias, (S, C1))):
        if tuple(t.shape) != shape or t.device != h3.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {shape} on {h3.device}")
    Hp = -(-H // 4) * 4
    h3, cols = pad_cols(h3, Hp), pad_cols(cols, Hp)
    outs = []
    for b0, b1 in beam_groups(B):
        hg = h3[:, b0:b1].contiguous()
        out = torch.empty((S, b1 - b0, C1), dtype=torch.float32, device=h3.device)
        if S:
            P = ctypes.c_void_p
            err = _build.lib().jlm_cand_dot(
                P(hg.data_ptr()), P(cols.data_ptr()), int(h3.dtype == torch.float32),
                P(bias.data_ptr()), P(out.data_ptr()), S, b1 - b0, C1, Hp,
                P(_build.stream_ptr(h3)),
            )
            _build.check(err, "cand_dot kernel")
            cand_dot.launches += 1
        outs.append(out)
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


cand_dot.launches = 0
