"""Per-sentence candidate-column scoring for the decode frame.

Counterpart of :mod:`jlm_tpu.ops.cand_dot` (its ``_cand_kernel``):
``out[s] = h3[s] @ cols[s]^T + bias[s]`` — ``h3 [S, B, H]`` beam states,
``cols [S, C1, H]`` the sentence's candidate head rows (EOS last),
``bias [S, C1]`` fp32 — returning ``[S, B, C1]`` fp32.

On a CUDA tensor the wrapper launches ``csrc/cand_dot.cu`` (bf16 on the
tensor cores or exact fp32, fp32 accumulation) or raises; on a CPU tensor
it runs the plain version.  The kernel holds at most 16 beam rows and 256
candidate columns of a sentence: wider beams go in groups of at most 16
rows (``beam_groups``) and more candidates in groups of at most 256
columns, one launch each; a hidden size that is not a multiple of 16
(bf16) or 4 (fp32) is zero-padded (``pad_cols``), which leaves every dot
unchanged.
"""

from __future__ import annotations

import torch

from jlm_tpu_torch.ops import _build
from jlm_tpu_torch.ops.project import pad_cols

_MAX_B = 16  # beam rows per sentence: one m16 tile
_MAX_C1 = 256  # candidate columns per sentence a launch


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
    rows and candidate columns; ``cand_dot.shapes`` counts the same
    launches by ``(S, beam rows)``, the sentences and the group's rows.
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
    f32 = h3.dtype == torch.float32
    m = 4 if f32 else 16  # the kernel's K step
    Hp = -(-H // m) * m
    h3, cols = pad_cols(h3, Hp), pad_cols(cols, Hp)
    groups = [(c, min(c + _MAX_C1, C1)) for c in range(0, C1, _MAX_C1)]
    rows = []
    for b0, b1 in beam_groups(B):
        hg = h3 if (b0, b1) == (0, B) else h3[:, b0:b1].contiguous()
        parts = []
        for c0, c1 in groups:
            cg, bg = ((cols, bias) if (c0, c1) == (0, C1) else
                      (cols[:, c0:c1].contiguous(), bias[:, c0:c1].contiguous()))
            out = h3.new_empty((S, b1 - b0, c1 - c0), dtype=torch.float32)
            if S and C1:
                err = _build.lib().jlm_cand_dot(
                    hg.data_ptr(), cg.data_ptr(), int(f32), bg.data_ptr(), out.data_ptr(),
                    S, b1 - b0, c1 - c0, Hp, _build.stream_ptr(h3))
                _build.check(err, "cand_dot kernel")
                cand_dot.launches += 1
                key = (S, b1 - b0)
                cand_dot.shapes[key] = cand_dot.shapes.get(key, 0) + 1
            parts.append(out)
        rows.append(parts[0] if len(parts) == 1 else torch.cat(parts, dim=2))
    return rows[0] if len(rows) == 1 else torch.cat(rows, dim=1)


cand_dot.launches = 0
cand_dot.shapes = {}
