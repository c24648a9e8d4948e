"""Output projection with online logsumexp — the decode frame's normalizer.

Counterpart of :mod:`jlm_tpu.ops.project` (its ``_proj_kernel``).
``project_ms`` returns the per-row partial softmax statistics ``(m, s)`` of
``logits = h @ W + b`` (``lse = m + log s``), ``project_lse`` the
log-sum-exp itself, and ``project_candidates`` /
``project_candidates_dsoftmax`` the candidate log-probs
``log softmax(logits)[:, cand]``; ``[R, V]`` logits never reach device
memory on the card.

Heads, as in the reference (project.py:424-440): a full head ``{"W",
"b"}``, or a D-softmax head ``{"blocks": [{"W", "b"}, ...]}`` whose block k
projects ``h[:, :d_k]`` (prefix mode) or its own disjoint slice of ``h``
(``config.dsoftmax``); the blocks' ``(m, s)`` merge as ``m_g = max_k m_k``,
``s_g = sum_k s_k * exp(m_k - m_g)``.

Weight modes, per block:

- fp32 weights (``compute_dtype=torch.float32``: exact fp32 products);
- bf16 weights with fp32 accumulation;
- int8 ``{"q", "scale"}`` weights with ``int8_mxu=True``: activations are
  quantized per row over the block's own slice (``s = max(max|h|, 1e-30)
  / 127``, round half to even) and the product is int8 x int8 -> int32,
  rescaled by row and column scale;
- int8 weights with ``int8_mxu=False`` (dequant): ``w = (q * scale)``
  rounded once to ``compute_dtype`` before the product, fp32 accumulation.

Candidate extraction runs the same kernel with its candidate epilogue on:
each candidate's logit, the fp32 value the online lse takes, is stored
from the register that holds it, and the merge launch subtracts the lse.
Ids may repeat; an id outside ``[0, V)`` matches no column and gets
``-lse``, as the reference's one-hot product gives it.

On a CUDA tensor the wrapper launches ``csrc/project_lse.cu`` — one launch
per block and one merge — or raises; on a CPU tensor it runs the plain
version.  A block may carry ``"WT"``, the ``[V_k, d_k]`` transposed weight
the kernel reads (``build_decode_head`` makes it once); without it the
wrapper transposes per call.  A head whose every block carries ``"WT"`` is
checked once and its plan kept under ``"_plan"`` (see ``_block_plan``):
replace such a head's tensors only through ``build_decode_head``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any, Dict, List, Optional, Tuple

import torch

from jlm_tpu_torch.config import Config
from jlm_tpu_torch.ops import _build

# Kernel weight modes (project_lse.cu's ``Mode``); the rows per block of
# each mode's kernel, and the vocab columns per tile of both kernels.
BF16, INT8_MXU, DEQUANT_BF16, FP32, DEQUANT_FP32 = range(5)
_ROWS = {BF16: 128, INT8_MXU: 128, DEQUANT_BF16: 128, FP32: 64, DEQUANT_FP32: 64}
_TV = 64


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


def head_blocks(head: Dict[str, Any], config: Optional[Config],
                H: int) -> List[Tuple[int, int, Dict[str, Any]]]:
    """``(first column, width, block)`` of each block of ``head`` over an
    ``[R, H]`` activation; a full head is one block of width ``H``."""
    if "blocks" not in head:
        return [(0, H, head)]
    if config is None or config.dsoftmax is None:
        raise ValueError("a D-softmax head needs config.dsoftmax")
    ds = config.dsoftmax
    out, offset = [], 0
    for blk, d in zip(head["blocks"], ds.block_dims):
        out.append((0 if ds.mode == "prefix" else offset, d, blk))
        if ds.mode == "disjoint":
            offset += d
    return out


def _split_block(blk: Dict[str, Any]):
    W = blk["W"]
    if isinstance(W, dict):
        return W["q"], W["scale"], blk["b"]
    return W, None, blk["b"]


def merge_ms(ms, ss) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge per-block partials: ``m_g = max m_k``, ``s_g = sum s_k e^(m_k - m_g)``."""
    if len(ms) == 1:
        return ms[0], ss[0]
    m_all, s_all = torch.cat(ms, dim=1), torch.cat(ss, dim=1)
    m_g = m_all.amax(dim=1, keepdim=True)
    return m_g, (s_all * torch.exp(m_all - m_g)).sum(dim=1, keepdim=True)


def _logits_ref(h, W, scale, bias, compute_dtype, int8_mxu) -> torch.Tensor:
    h = h.to(compute_dtype)
    if scale is not None and int8_mxu:
        q, s = quantize_rows(h)
        # int8 @ int8 in torch returns int8 (wraps), so multiply as fp32:
        # every partial sum is an integer below 2**24 for H <= 1040, exact.
        acc = q.float() @ W.float()
        return acc * s * scale.float()[None, :] + bias.float()[None, :]
    if scale is not None:  # dequant before the product, rounded once
        W = W.float() * scale.float()[None, :]
    return h.float() @ W.to(compute_dtype).float() + bias.float()[None, :]


def project_ms_ref(h, head, config: Optional[Config] = None, *,
                   compute_dtype=torch.float32, int8_mxu: bool = False):
    """Plain version: ``(m, s)`` each ``[R, 1]`` from each block's full
    logits (on the block's slice of ``h``), merged."""
    ms, ss = [], []
    for off, d, blk in head_blocks(head, config, h.shape[1]):
        logits = _logits_ref(h[:, off:off + d], *_split_block(blk), compute_dtype, int8_mxu)
        m = logits.amax(dim=1, keepdim=True)
        ms.append(m)
        ss.append(torch.exp(logits - m).sum(dim=1, keepdim=True))
    return merge_ms(ms, ss)


def project_lse_ref(h, head, config: Optional[Config] = None, *,
                    compute_dtype=torch.float32, int8_mxu: bool = False) -> torch.Tensor:
    """Plain version of :func:`project_lse`: ``[R, 1]``."""
    m, s = project_ms_ref(h, head, config, compute_dtype=compute_dtype,
                          int8_mxu=int8_mxu)
    return m + torch.log(s)


def _full_head(weight, scale, bias) -> Dict[str, Any]:
    return {"W": weight if scale is None else {"q": weight, "scale": scale}, "b": bias}


def _candidates_ref(h, head, config, cand_ids, compute_dtype, int8_mxu):
    logits = [_logits_ref(h[:, off:off + d], *_split_block(blk), compute_dtype, int8_mxu)
              for off, d, blk in head_blocks(head, config, h.shape[1])]
    ms = [l.amax(dim=1, keepdim=True) for l in logits]
    m, s = merge_ms(ms, [torch.exp(l - mk).sum(dim=1, keepdim=True)
                         for l, mk in zip(logits, ms)])
    full = torch.cat(logits, dim=1)
    V = full.shape[1]
    ids = cand_ids.to(full.device).long()
    raw = full[:, ids.clamp(0, V - 1)]
    raw = torch.where(((ids >= 0) & (ids < V))[None, :], raw, torch.zeros_like(raw))
    return raw - (m + torch.log(s))


def project_candidates_ref(h, weight, scale, bias, cand_ids, *,
                           compute_dtype=torch.float32, int8_mxu: bool = False):
    """Plain version of :func:`project_candidates`: the full logits, their
    lse, and the candidate columns gathered."""
    return _candidates_ref(h, _full_head(weight, scale, bias), None, cand_ids,
                           compute_dtype, int8_mxu)


def project_candidates_dsoftmax_ref(h, blocks, config: Config, cand_ids, *,
                                    compute_dtype=torch.float32, int8_mxu: bool = False):
    """Plain version of :func:`project_candidates_dsoftmax`: each block's
    logits on its slice of h, the merged lse, the candidate columns of the
    blocks' logits side by side."""
    return _candidates_ref(h, {"blocks": list(blocks)}, config, cand_ids,
                           compute_dtype, int8_mxu)


def _mode(quantized: bool, compute_dtype, int8_mxu: bool) -> int:
    if quantized and int8_mxu:
        return INT8_MXU
    if compute_dtype == torch.bfloat16:
        return DEQUANT_BF16 if quantized else BF16
    return DEQUANT_FP32 if quantized else FP32


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _block_plan(head, config, H, device, compute_dtype, int8_mxu):
    """Per block ``(first column, width, W^T, mode, scale, bias, V)``, each
    tensor checked against what the kernel reads.  A head whose every block
    carries ``"WT"`` (as ``build_decode_head`` makes it) keeps its plan
    under ``"_plan"``, so a decode checks it once, not on every frame."""
    key = (H, device, compute_dtype, int8_mxu)
    cached = head.get("_plan")
    if cached is not None and cached[0] == key:
        return cached[1]
    blocks, plan = head_blocks(head, config, H), []
    for off, d, blk in blocks:
        W, scale, bias = _split_block(blk)
        V = bias.shape[0]
        quantized = scale is not None
        wt = blk.get("WT")
        if wt is None:
            wt = (W if quantized else W.to(compute_dtype)).t().contiguous()
        want_w = torch.int8 if quantized else compute_dtype
        for name, t in (("W^T", wt), ("bias", bias)) + (
                (("scale", scale),) if quantized else ()):
            if t.device != device or not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous on {device}")
        if wt.dtype != want_w or tuple(wt.shape) != (V, d):
            raise ValueError(f"W^T must be {want_w} [{V}, {d}], got "
                             f"{wt.dtype} {tuple(wt.shape)}")
        if bias.dtype != torch.float32 or (quantized and scale.dtype != torch.float32):
            raise ValueError("bias and scale must be fp32")
        if d % 32 or off % 32 or off + d > H:
            raise ValueError(f"block columns [{off}, {off + d}) of {H}: width and "
                             "offset must be multiples of 32")
        plan.append((off, d, wt, _mode(quantized, compute_dtype, int8_mxu), scale, bias, V))
    if all("WT" in blk for _, _, blk in blocks):
        head["_plan"] = (key, plan)
    return plan


def _launch(h, head, config, compute_dtype, int8_mxu, want: str, cand_ids=None):
    """One kernel launch per block of ``head`` and one merge.  ``want``:
    ``"ms"`` -> ``(m, s)``; ``"lse"`` -> ``lse``, each ``[R, 1]``;
    ``"cand"`` -> the log-probs ``[R, C]`` of ``cand_ids``."""
    if compute_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"compute_dtype {compute_dtype}")
    R, H = h.shape
    if H % 32:
        raise ValueError(f"hidden size {H} must be a multiple of 32")
    h = h.to(compute_dtype).contiguous()
    sms = _sm_count(h.device.index)
    plans, total = [], 0
    for off, d, wt, mode, scale, bias, V in _block_plan(head, config, H, h.device,
                                                        compute_dtype, int8_mxu):
        n_tiles, row_blocks = -(-V // _TV), -(-R // _ROWS[mode])
        splits = min(n_tiles, max(1, -(-8 * sms // max(row_blocks, 1))))
        per_split = -(-n_tiles // splits)
        splits = -(-n_tiles // per_split)
        plans.append((off, d, wt, mode, scale, bias, V, splits, per_split))
        total += splits

    def col():
        return torch.empty((R, 1), dtype=torch.float32, device=h.device)

    m = s = lse = cand = ids = slots = None
    if want == "cand":
        C = cand_ids.shape[0]
        cand = torch.zeros((R, C), dtype=torch.float32, device=h.device)
        if R == 0 or C == 0:
            return cand
        # sorted ids (the kernel binary-searches them) and their columns
        ids, slots = torch.sort(cand_ids.to(device=h.device, dtype=torch.int32),
                                stable=True)
        ids, slots = ids.contiguous(), slots.to(torch.int32).contiguous()
    elif want == "lse":
        lse = col()
        if R == 0:
            return lse
    else:
        m, s = col(), col()
        if R == 0:
            return m, s
    part = torch.empty((2, total, R), dtype=torch.float32, device=h.device)
    P = ctypes.c_void_p
    ptr = lambda t: P(t.data_ptr()) if t is not None else P(None)  # noqa: E731
    stream = P(_build.stream_ptr(h))
    counter = project_candidates if want == "cand" else project_lse
    lib, base, id_base = _build.lib(), 0, 0
    for off, d, wt, mode, scale, bias, V, splits, per_split in plans:
        err = lib.jlm_project_block(
            P(h.data_ptr() + off * h.element_size()), H, int(h.dtype == torch.bfloat16),
            ptr(wt), mode, ptr(scale), ptr(bias), ptr(part[0, base]), ptr(part[1, base]),
            R, d, V, splits, per_split, ptr(ids), ptr(slots),
            0 if ids is None else ids.shape[0], id_base, ptr(cand), stream,
        )
        _build.check(err, "project_lse kernel")
        counter.launches += 1
        base += splits
        id_base += V
    err = lib.jlm_project_merge(ptr(part[0]), ptr(part[1]), ptr(m), ptr(s), ptr(lse),
                                ptr(cand), 0 if cand is None else cand.shape[1], R,
                                total, stream)
    _build.check(err, "project_lse merge kernel")
    if want == "cand":
        return cand
    return lse if want == "lse" else (m, s)


def project_ms(
    h: torch.Tensor,  # [R, H]
    head: Dict[str, Any],  # {"W", "b"[, "WT"]} | {"blocks": [...]}; W may be int8
    config: Optional[Config] = None,  # config.dsoftmax for a D-softmax head
    *,
    compute_dtype=torch.float32,
    int8_mxu: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row partial softmax statistics ``(m, s)``, each ``[R, 1]``."""
    if h.is_cuda:
        return _launch(h, head, config, compute_dtype, int8_mxu, "ms")
    return project_ms_ref(h, head, config, compute_dtype=compute_dtype,
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

    ``project_lse.launches`` counts kernel launches from either wrapper:
    one per block of the head (the merge launch is not counted).
    """
    if h.is_cuda:
        return _launch(h, head, config, compute_dtype, int8_mxu, "lse")
    return project_lse_ref(h, head, config, compute_dtype=compute_dtype,
                           int8_mxu=int8_mxu)


def project_candidates(
    h: torch.Tensor,  # [R, H]
    weight: torch.Tensor,  # [H, V] fp32, bf16 or int8
    scale: Optional[torch.Tensor],  # [V] fp32 column scales of int8 weights, or None
    bias: torch.Tensor,  # [V] fp32
    cand_ids: torch.Tensor,  # [C] global vocab ids
    *,
    compute_dtype=torch.float32,
    int8_mxu: bool = False,
) -> torch.Tensor:
    """Candidate log-probs ``[R, C]`` fp32: ``log softmax(h @ W + b)[:, cand]``.

    ``project_candidates.launches`` counts kernel launches of either
    candidate wrapper: one per block of the head."""
    if h.is_cuda:
        return _launch(h, _full_head(weight, scale, bias), None, compute_dtype, int8_mxu,
                       "cand", cand_ids)
    return project_candidates_ref(h, weight, scale, bias, cand_ids,
                                  compute_dtype=compute_dtype, int8_mxu=int8_mxu)


def project_candidates_dsoftmax(
    h: torch.Tensor,  # [R, H]
    blocks,  # [{"W": [d_k, s_k] or {"q", "scale"}, "b": [s_k][, "WT"]}, ...]
    config: Config,  # config.dsoftmax
    cand_ids: torch.Tensor,  # [C] global vocab ids
    *,
    compute_dtype=torch.float32,
    int8_mxu: bool = False,
) -> torch.Tensor:
    """D-softmax candidate log-probs ``[R, C]``: one launch per block on its
    slice of h, each storing only its own ids into one ``[R, C]`` buffer
    zeroed once, and one merge that subtracts the blocks' global lse."""
    if h.is_cuda:
        return _launch(h, {"blocks": list(blocks)}, config, compute_dtype, int8_mxu,
                       "cand", cand_ids)
    return project_candidates_dsoftmax_ref(h, blocks, config, cand_ids,
                                           compute_dtype=compute_dtype, int8_mxu=int8_mxu)


project_lse.launches = 0
project_candidates.launches = 0
