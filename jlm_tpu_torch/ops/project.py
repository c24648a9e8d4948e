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
the epilogue that feeds the online lse stores each candidate's logit, in
the plain version's rounding, and the merge launch subtracts the lse.
Ids may repeat; an id outside ``[0, V)`` matches no column and gets
``-lse``, as the reference's one-hot product gives it.

On a CUDA tensor the wrapper launches ``csrc/project_lse.cu`` — one launch
per block and one merge, and for int8-MXU heads first one launch that
quantizes every block's activation slice — or raises; on a CPU tensor it
runs the plain version.  The int8-MXU, bf16 and bf16-dequant blocks run
``wgmma`` + TMA kernels at any width (int8-MXU keeps a block's quantized
rows resident up to a 1,024-wide slice and streams them with W^T past
it), the fp32 modes the fp32 kernel.  A block may carry
``"WT"``, the ``[V_k, d_k]`` transposed weight the kernel reads
(``build_decode_head`` makes it once); without it the wrapper transposes
per call.  A head whose every block carries ``"WT"`` is checked once and
its plan kept under ``"_plan"`` (see ``_block_plan``): replace such a
head's tensors only through ``build_decode_head``.

Widths and offsets that are not multiples of 32 (``padded_width``): the
plan pads each block's W^T with zero columns to the next multiple of 32
once (an int8-MXU block to 128, 256, 512 or 1,024, past that to a
multiple of 128: ``int8_width``), and
each call copies the block's h slice into a zero-padded buffer (the int8
quantization pass writes its zero columns itself); zeros change neither a
product nor an int8 row scale.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any, Dict, List, Optional, Tuple

import torch

from jlm_tpu_torch.config import Config
from jlm_tpu_torch.ops import _build

# Kernel weight modes (project_lse.cu's ``Mode``); the (rows per block,
# vocab columns per tile) of the bf16 and fp32 kernels.
BF16, INT8_MXU, DEQUANT_BF16, FP32, DEQUANT_FP32 = range(5)
_BF16_TILE = (128, 256)
_FP32_TILE = (128, 128)
_FP32_PER_SM = 2  # blocks of the fp32 kernel an SM holds
_ALIGN = 32  # hidden columns per kernel K step
_INT8_RESIDENT = 1024  # widest slice whose quantized rows the int8 kernel keeps resident
_INT8_CHUNK = 128  # K of a streamed int8 chunk (one 128-byte swizzle row)


def _int8_tile(dp: int) -> Tuple[int, int]:
    """(rows per block, vocab columns per tile) of the int8 kernel: rows
    resident up to 1,024 wide, streamed with W^T past it."""
    if dp > _INT8_RESIDENT:
        return _BF16_TILE
    return (256, 64) if dp <= 512 else (128, 32)


def padded_width(d: int, multiple: int = _ALIGN) -> int:
    """``d`` rounded up to a multiple of ``multiple``."""
    return -(-d // multiple) * multiple


def int8_width(d: int) -> int:
    """The int8 kernel's padded width of a ``d``-wide slice: 128, 256, 512
    or 1,024 (the resident kernel's K loop is unrolled for each), and past
    1,024 a multiple of 128 (the streamed kernel's K chunk)."""
    if d > _INT8_RESIDENT:
        return padded_width(d, _INT8_CHUNK)
    w = 128
    while w < d:
        w *= 2
    return w


def pad_cols(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t [..., n]`` zero-padded on the right to ``[..., width]``,
    contiguous (``t`` itself where it is already so)."""
    n = t.shape[-1]
    if n == width:
        return t.contiguous()
    return torch.nn.functional.pad(t, (0, width - n)).contiguous()


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
        # int8 @ int8 in torch returns int8 (wraps), so multiply as floats:
        # every partial sum is an integer below 2**24 for H <= 1040, exact
        # in fp32; wider slices multiply in fp64 (exact below 2**53).
        wide = W.shape[0] > 1040
        acc = (q.double() @ W.double()).float() if wide else q.float() @ W.float()
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
    """Per block ``(first column, width, W^T, mode, scale, bias, V, padded
    width)``, each tensor checked against what the kernel reads, W^T
    zero-padded to the padded width.  A head whose every block carries
    ``"WT"`` (as ``build_decode_head`` makes it) keeps its plan under
    ``"_plan"``, so a decode checks and pads it once, not on every frame."""
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
        if off + d > H:
            raise ValueError(f"block columns [{off}, {off + d}) exceed the hidden size {H}")
        mode = _mode(quantized, compute_dtype, int8_mxu)
        dp = int8_width(d) if mode == INT8_MXU else padded_width(d)
        plan.append((off, d, pad_cols(wt, dp), mode, scale, bias, V, dp))
    if all("WT" in blk for _, _, blk in blocks):
        head["_plan"] = (key, plan)
    return plan


# Each block's fixed cost in tile times, for vocab_splits: the int8 kernel
# loads its resident rows (about 4 tiles); the bf16 kernel and the int8
# kernel past 1,024 stream h with every tile, and pay their ring's fill and
# their epilogue (about 1); the fp32 kernels (this head's and the fused CE
# forward's, ops/softmax_ce.py::fwd_plan_f32) stream h too, and pay their
# first chunk and the merge of their column threads (about 1).
INT8_BLOCK_TILES = 4
BF16_BLOCK_TILES = 1
FP32_BLOCK_TILES = 1


def vocab_splits(n_tiles: int, row_blocks: int, sms: int, fixed: int) -> Tuple[int, int]:
    """``(splits, tiles per split)`` of a kernel's vocab: the split count
    whose waves of ``sms`` blocks (the blocks the card runs at once) take
    the fewest tile times, each block paying ``fixed`` tile times besides
    its own tiles.  A second wave costs a block's fixed time more than it
    saves, so one row block (a keystroke's rows) gets a whole wave."""
    best = None
    for sp in range(1, n_tiles + 1):
        per = -(-n_tiles // sp)
        sp = -(-n_tiles // per)
        cost = -(-row_blocks * sp // sms) * (per + fixed)
        if best is None or cost < best[0]:
            best = (cost, sp, per)
    return best[1], best[2]


def block_splits(mode: int, dp: int, V: int, R: int, sms: int) -> Tuple[int, int]:
    """``(splits, tiles per split)`` of one block's launch over ``R`` rows
    and ``V`` vocab columns (padded width ``dp``) on ``sms`` SMs: its
    kernel's tile, blocks an SM and fixed cost, through ``vocab_splits``."""
    if mode == INT8_MXU:
        rows, cols = _int8_tile(dp)
        return vocab_splits(-(-V // cols), -(-R // rows), sms,
                            INT8_BLOCK_TILES if dp <= _INT8_RESIDENT else BF16_BLOCK_TILES)
    if mode in (BF16, DEQUANT_BF16):
        rows, cols = _BF16_TILE
        return vocab_splits(-(-V // cols), -(-R // rows), sms, BF16_BLOCK_TILES)
    rows, cols = _FP32_TILE
    return vocab_splits(-(-V // cols), -(-R // rows), _FP32_PER_SM * sms, FP32_BLOCK_TILES)


def _launch(h, head, config, compute_dtype, int8_mxu, want: str, cand_ids=None):
    """One kernel launch per block of ``head`` and one merge (and, for an
    int8-MXU head, one quantization launch first).  ``want``: ``"ms"`` ->
    ``(m, s)``; ``"lse"`` -> ``lse``, each ``[R, 1]``; ``"cand"`` -> the
    log-probs ``[R, C]`` of ``cand_ids``."""
    if compute_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"compute_dtype {compute_dtype}")
    R, H = h.shape
    h = h.to(compute_dtype).contiguous()
    sms = _sm_count(h.device.index)
    plans, total = [], 0
    for off, d, wt, mode, scale, bias, V, dp in _block_plan(head, config, H, h.device,
                                                            compute_dtype, int8_mxu):
        splits, per_split = block_splits(mode, dp, V, R, sms)
        plans.append((off, d, wt, mode, scale, bias, V, dp, splits, per_split))
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
    C = 0 if ids is None else ids.shape[0]
    if plans[0][3] == INT8_MXU:  # every block of a head shares the mode
        n = len(plans)
        qcol = [sum(p[7] for p in plans[:k]) for k in range(n)]
        ldq = qcol[-1] + plans[-1][7]
        q = torch.empty((R, ldq), dtype=torch.int8, device=h.device)
        hs = torch.empty((n, R), dtype=torch.float32, device=h.device)
        ints = lambda vals: (ctypes.c_int * n)(*vals)  # noqa: E731
        err = lib.jlm_project_quantize(
            ptr(h), H, int(h.dtype == torch.bfloat16), R, n, ints(p[0] for p in plans),
            ints(p[1] for p in plans), ints(p[7] for p in plans), ints(qcol), ptr(q), ldq,
            ptr(hs), stream)
        _build.check(err, "project_lse quantization kernel")
    for k, (off, d, wt, mode, scale, bias, V, dp, splits, per_split) in enumerate(plans):
        if mode == INT8_MXU:
            err = lib.jlm_project_int8(
                P(q.data_ptr() + qcol[k]), ldq, R, dp, ptr(wt), ptr(scale), ptr(bias),
                ptr(hs[k]), ptr(part[0, base]), ptr(part[1, base]), V, splits, per_split,
                ptr(ids), ptr(slots), C, id_base, ptr(cand), stream)
        else:
            if dp != d or off % _ALIGN or H % _ALIGN:
                hk, ldh = pad_cols(h[:, off:off + d], dp), dp
            else:
                hk, ldh = h[:, off:], H
            if hk.data_ptr() % 16:  # vector loads and TMA read 16-byte aligned rows
                hk, ldh = hk[:, :dp].clone(), dp
            err = lib.jlm_project_block(
                ptr(hk), ldh, ptr(wt), mode, ptr(scale), ptr(bias), ptr(part[0, base]),
                ptr(part[1, base]), R, dp, V, splits, per_split, ptr(ids), ptr(slots), C,
                id_base, ptr(cand), stream)
        _build.check(err, "project_lse kernel")
        counter.launches += 1
        counter.rows[R] = counter.rows.get(R, 0) + 1
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
    one per block of the head (the merge launch is not counted);
    ``project_lse.rows`` counts the same launches by their row count R.
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
    candidate wrapper: one per block of the head (``.rows``: by R)."""
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
project_lse.rows = {}
project_candidates.launches = 0
project_candidates.rows = {}
