"""Fused softmax cross-entropy over a large vocabulary, for training.

Counterpart of :mod:`jlm_tpu.ops.softmax_ce`: the loss ``lse(l) - l[y]``
of ``l = h @ W + b`` and its gradients without the ``[N, V]`` logits in
device memory.  The pieces, as in the reference:

- ``ce_fwd_raw`` -> per-row partial ``(m, s, t)``: running max, sum of
  ``exp(l - m)``, and the target logit (0 where the target is outside
  ``[0, V)``, e.g. -1 for "another block owns it");
- ``ce_bwd`` -> ``(dh, dW, db)`` for the generalized cotangent
  ``gp = ga * exp(l - lse) + gb * onehot(y)`` (``gb=None`` means ``-ga``),
  through ``ce_bwd_dh`` and ``ce_bwd_dw``;
- ``ce_loss_fused``: the per-row loss as an autograd Function;
- ``ce_loss_fused_dsoftmax``: the D-softmax head, one call per frequency
  block on its hidden slice, block partials merged into one lse;
- ``ce_loss_ref``: plain CE over full fp32 logits.

``compute_dtype`` is what h, W and gp are rounded to before each product
(fp32 accumulation either way), as in the Pallas kernels; db sums the
unrounded gp.  On a CUDA tensor the wrappers launch ``csrc/softmax_ce.cu``
(bf16 compute on the tensor cores, or fp32 compute as exact fp32 FMAs on
the CUDA cores, no TF32) or raise; on a CPU tensor they run the plain
versions ``ce_fwd_raw_ref``, ``ce_bwd_dh_ref`` and ``ce_bwd_dw_ref``.
The kernels take any hidden slice that is a multiple of 128: another
width is zero-padded (``pad_hidden``: zero columns of h, zero rows of W),
which changes no logit, and the padding's rows of dh and dW are dropped.
The bf16 forward and backward (``wgmma`` + TMA) read ``W^T`` bf16, which
:func:`cast_wt` writes in the pass that casts W, once a step for both
(``ce_loss_fused``), and launch as :func:`fwd_plan` and :func:`bwd_plan`
lay them out (resident rows, ring slots, vocab splits, slices of D); the
fp32 forward reads h and W as they are (W padded to a multiple of 4
columns only where V is not one) and launches as :func:`fwd_plan_f32`
lays it out (128-row blocks over vocab splits of 128-column tiles); the
fp32 backward reads W as it is and ``h^T`` (transposed here) and launches
as :func:`bwd_plan_f32` lays it out (rows and columns a block, the logits
over all of D up to 1,024, output slices past it).  The plans are pure
functions of the shapes and the SM count.
"""

from __future__ import annotations

import ctypes
import functools
import types
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from jlm_tpu_torch.ops import _build
from jlm_tpu_torch.ops.project import FP32_BLOCK_TILES, vocab_splits

Tensor = torch.Tensor


# ---------------------------------------------------------------- plain

def _logits_ref(h, W, b, compute_dtype):
    return (h.to(compute_dtype).float() @ W.to(compute_dtype).float()
            + b.float()[None, :])


def ce_fwd_raw_ref(h, W, b, y, compute_dtype=torch.float32):
    """Plain version of :func:`ce_fwd_raw` over the full logits."""
    logits = _logits_ref(h, W, b, compute_dtype)
    V = logits.shape[1]
    m = logits.amax(dim=1)
    s = torch.exp(logits - m[:, None]).sum(dim=1)
    y = y.long()
    own = (y >= 0) & (y < V)
    t = logits.gather(1, y.clamp(0, V - 1)[:, None])[:, 0]
    return m, s, torch.where(own, t, torch.zeros_like(t))


def _gp_ref(h, W, b, y, lse, ga, gb, compute_dtype):
    logits = _logits_ref(h, W, b, compute_dtype)
    onehot = torch.arange(logits.shape[1], device=y.device)[None, :] == y.long()[:, None]
    return ga.float()[:, None] * torch.exp(logits - lse[:, None]) + gb.float()[:, None] * onehot


def ce_bwd_dh_ref(h, W, b, y, lse, ga, gb, compute_dtype=torch.float32):
    """Plain version of :func:`ce_bwd_dh` over the full logits."""
    gp = _gp_ref(h, W, b, y, lse, ga, gb, compute_dtype)
    return gp.to(compute_dtype).float() @ W.to(compute_dtype).float().t()


def ce_bwd_dw_ref(h, W, b, y, lse, ga, gb, compute_dtype=torch.float32):
    """Plain version of :func:`ce_bwd_dw` over the full logits."""
    gp = _gp_ref(h, W, b, y, lse, ga, gb, compute_dtype)
    return h.to(compute_dtype).float().t() @ gp.to(compute_dtype).float(), gp.sum(dim=0)


def ce_loss_ref(h, W, b, y) -> Tensor:
    """Plain fp32 CE per row (the reference's ``ce_loss_ref``)."""
    logits = h.float() @ W.float() + b.float()
    m = logits.amax(dim=1, keepdim=True)
    lse = m + torch.log(torch.exp(logits - m).sum(dim=1, keepdim=True))
    return (lse - logits.gather(1, y.long()[:, None]))[:, 0]


# ---------------------------------------------------------------- kernels

def pad_hidden(h: Tensor, W: Tensor, multiple: int = 128) -> Tuple[Tensor, Tensor]:
    """``h [N, D]`` with zero columns and ``W [D, V]`` with zero rows up to
    the next multiple of ``multiple``: the same logits."""
    D = h.shape[1]
    Dp = -(-D // multiple) * multiple
    if Dp == D:
        return h, W
    pad = torch.nn.functional.pad
    return pad(h, (0, Dp - D)), pad(W, (0, 0, 0, Dp - D))


def _check_dtype(compute_dtype):
    if compute_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the CE kernels compute in bf16 or fp32, not {compute_dtype}")


def _f32_args(h, W, b, y):
    """Cast, pad and check the operands of an fp32 launch; returns ``(h
    [N, Dp], W [Dp, V], b, y int32, N, Dp, V)``, h and W fp32, D
    zero-padded to ``Dp``, a multiple of 128."""
    N, D = h.shape
    V = b.shape[0]
    if tuple(W.shape) != (D, V):
        raise ValueError(f"W must be [{D}, {V}], got {tuple(W.shape)}")
    h, W = pad_hidden(h.float(), W.float())
    hb, Wb = h.contiguous(), W.contiguous()
    for name, t in (("W", Wb), ("b", b), ("y", y)):
        if t.device != h.device:
            raise ValueError(f"{name} must be on {h.device}")
    for t in (hb, Wb):
        if t.data_ptr() % 16:
            raise ValueError("h and W must be 16-byte aligned")
    return (hb, Wb, b.float().contiguous(), y.to(torch.int32).contiguous(), N, h.shape[1], V)


def _ptr(t: Optional[Tensor]):
    return ctypes.c_void_p(t.data_ptr() if t is not None else None)


def _row_terms(lse, ga, gb, N, device):
    """lse, ga and gb fp32 [N], checked."""
    f32 = [t.float().contiguous() for t in (lse, ga, gb)]
    for t in f32:
        if t.device != device or tuple(t.shape) != (N,):
            raise ValueError(f"lse, ga and gb must be [{N}] on {device}")
    return f32


# The bf16 kernels' shared-memory pieces (csrc/softmax_ce.cu): the
# backward's K chunk of 64 rows x 64 bf16 and the slots a plan may take;
# the forward's 128-row blocks and tiles, its ring slot (a K chunk of 128
# rows), the ring's slots at most, at least beside all of the rows and at
# least where rows stream (fwd_plan's choice), its bias slots; each
# kernel's barriers' bytes and a block's limit.
_CHUNK = 64 * 64 * 2
_MAX_OWN, _MAX_PASS = 4, 8
_SMEM_SMALL = (1 + 2 * _MAX_OWN + 2 * _MAX_PASS) * 8
_FT = 128
_SUB = _FT * 64 * 2
_MAX_SUB, _MIN_RING, _STREAM_RING, _NB = 12, 5, 7, 4
SMEM_LIMIT = 232_448


def bwd_smem(sw: int, n_own: int, n_pass: int) -> int:
    """Shared memory of a bf16 backward block (``bwd_smem`` of the .cu):
    the slice's q chunks, ``n_own`` slots of a slice (and of its kv terms,
    1 KB), ``n_pass`` pass slots (a kv chunk and a q chunk each), gp and
    the logits' exchange (three chunks), the barriers and 1,024 bytes of
    alignment."""
    own = sw // 64
    return (1024 + (own + n_own * own + 2 * n_pass + 3) * _CHUNK + n_own * 4 * 64 * 4
            + _SMEM_SMALL)


def fwd_smem(n_res: int, n_sub: int) -> int:
    """Shared memory of a bf16 forward block (``fwd_smem`` of the .cu):
    ``n_res`` resident q chunks and ``n_sub`` ring slots of 16 KB, the
    bias slots, the barriers and 1,024 bytes of alignment."""
    return 1024 + (n_res + n_sub) * _SUB + _NB * _FT * 4 + (1 + 2 * _MAX_SUB + 2 * _NB) * 8


@functools.lru_cache(maxsize=256)
def fwd_plan(N: int, D: int, V: int, sms: int):
    """Launch plan of the bf16 forward kernel at ``N`` rows, hidden width
    ``D`` (a multiple of 128), vocabulary ``V`` on ``sms`` SMs; a pure
    function.

    A block owns 128 rows (two warpgroups of 64) and walks 128-column vocab
    tiles of its split.  Its rows' ``D / 64`` K chunks all stay resident
    where they leave room for a ring of ``_MIN_RING`` slots (up to D =
    512); else the first ``n_res`` stay, as many as leave ``_STREAM_RING``
    slots (six of sixteen at D = 1,024), and the others stream through the
    ring beside the kv chunk of the same K, two slots a chunk: on an H100
    the deeper ring read faster than more resident rows at D = 1,024 and
    slower at 512 (PERF.md).  The ring takes what is left, up to
    ``_MAX_SUB`` slots.  Row blocks x ``splits`` of the vocab tiles
    (``tiles_per_split`` each, every split at least one), one block an
    SM."""
    if D % 128 or D <= 0 or N <= 0 or V <= 0:
        raise ValueError(f"fwd_plan: D a multiple of 128 and N, V > 0, got {N}, {D}, {V}")
    nd = D // 64
    if fwd_smem(nd, _MIN_RING) <= SMEM_LIMIT:
        n_res = nd
    else:
        n_res = max(r for r in range(nd) if fwd_smem(r, _STREAM_RING) <= SMEM_LIMIT)
    n_sub = max(n for n in range(_MIN_RING, _MAX_SUB + 1) if fwd_smem(n_res, n) <= SMEM_LIMIT)
    q_blocks, n_tiles = -(-N // _FT), -(-V // _FT)
    splits = max(1, min(n_tiles, sms // q_blocks))
    per_split = -(-n_tiles // splits)
    splits = -(-n_tiles // per_split)
    return types.MappingProxyType(dict(  # cached: read-only
        rows=_FT, cols=_FT, n_res=n_res, n_sub=n_sub, smem=fwd_smem(n_res, n_sub),
        grid=(q_blocks, splits), splits=splits, tiles_per_split=per_split))


@functools.lru_cache(maxsize=256)
def bwd_plan(kind: str, N: int, D: int, V: int, sms: int):
    """Launch plan of the bf16 backward kernel ``kind`` ("dh" or "dw") at
    ``N`` rows, hidden width ``D`` (a multiple of 128), vocabulary ``V`` on
    ``sms`` SMs; a pure function.

    The output is cut into slices of ``sw`` columns (all of D up to 512,
    else 512, 256 or 128, whichever divides D first), each a block's two
    consumer warpgroups' halves.  A block keeps its slice's q chunks and
    ``n_own`` slots of a tile's slice chunks: where every chunk is the
    slice's, as many as fit (2 to 4); else one, and the other K chunks (each
    with its q chunk) stream through ``n_pass`` slots, as many as fit (2 to
    8): more loads in flight beat keeping all of the rows resident, which
    at D = 1,024 left room for two pass slots (PERF.md, PR 12).

    dh: 64-row blocks x ``splits`` of the 64-column vocab tiles
    (``tiles_per_split`` each, every split at least one) x slices, one
    block an SM; dW: 64-column vocab blocks x slices, every row tile in
    each block."""
    if D % 128 or D <= 0 or kind not in ("dh", "dw"):
        raise ValueError(f"bwd_plan: kind dh or dw and D a multiple of 128, got {kind}, {D}")
    sw = D if D <= 512 else next(w for w in (512, 256, 128) if D % w == 0)
    slices = D // sw

    if D == sw:  # every chunk the slice's: as many slice slots as fit
        n_own = max(n for n in range(2, _MAX_OWN + 1) if bwd_smem(sw, n, 0) <= SMEM_LIMIT)
        n_pass = 0
    else:  # one slice slot, as many pass slots as fit
        n_own = 1
        n_pass = max(n for n in range(2, _MAX_PASS + 1) if bwd_smem(sw, 1, n) <= SMEM_LIMIT)
    plan = dict(sw=sw, slices=slices, n_own=n_own, n_pass=n_pass,
                smem=bwd_smem(sw, n_own, n_pass))
    q_blocks = -(-(N if kind == "dh" else V) // 64)
    if kind == "dh":
        n_tiles = -(-V // 64)
        splits = max(1, min(n_tiles, sms // (q_blocks * slices)))
        per_split = -(-n_tiles // splits)
        splits = -(-n_tiles // per_split)
        plan.update(grid=(q_blocks, splits, slices), splits=splits, tiles_per_split=per_split)
    else:
        plan.update(grid=(q_blocks, slices), splits=1, tiles_per_split=-(-N // 64))
    return types.MappingProxyType(plan)  # cached: read-only


# The fp32 backward's pieces (csrc/softmax_ce.cu, namespace bf32): a block's
# threads, a tile's logits (8 x 4 a thread), the output a block keeps in
# registers (q rows x slice columns, 128 a thread), the widest output
# slice, a thread's logits rows, the logits' K chunk, the output product's
# kv chunk, the ring's slots; the q rows a block may take.
F32_THREADS, F32_TILE, F32_OUT, F32_SW = 256, 8_192, 32_768, 1_024
F32_LR, F32_BK, F32_BV, F32_NS = 8, 32, 8, 4
F32_QS = (256, 128, 64, 32)


def bwd_smem_f32(kind: str, q: int, sw: int) -> int:
    """Shared memory of an fp32 backward block (``bwd_f32_smem`` of the
    .cu): ``F32_NS`` ring slots (a logits chunk of ``F32_BK`` rows of h^T and W, or
    an output chunk of 8 kv by the slice, padded rows in dW), gp, db's
    partial sums (dW) and a tile's terms."""
    kv = F32_TILE // q
    r, c = (kv, q) if kind == "dw" else (q, kv)
    slot = max(F32_BK * (q + kv), F32_BV * (sw + 4))
    return 4 * (4 * F32_NS + F32_NS * slot + F32_TILE + (F32_TILE // F32_LR if kind == "dw" else 0)
                + 4 * r + c)


@functools.lru_cache(maxsize=256)
def bwd_plan_f32(kind: str, N: int, D: int, V: int, sms: int):
    """Launch plan of the fp32 backward kernel ``kind`` ("dh" or "dw") at
    ``N`` rows, hidden width ``D`` (a multiple of 128), vocabulary ``V`` on
    ``sms`` SMs; a pure function.

    The output (dh rows, dW columns) is cut into ``slices`` of ``sw``
    columns of D over grid.z: one slice up to D = 1,024, so that a tile's
    logits are formed once; past it slices of at most 1,024 (multiples of
    128, the last one narrower where they do not divide D), each
    recomputing the logits.  A block owns ``q`` rows of its output, the
    most of 256, 128, 64 and 32 whose ``[q, sw]`` fits the 128 accumulators
    a thread (64 at D = 512, 32 at 1,024), and walks tiles of ``kv = 8,192
    / q``: the logits of a tile are ``q x kv``, 8 x 4 a thread, over
    ``k_chunks`` chunks of 32 of K, then the output product takes
    ``kv_chunks`` chunks of 8 kv.

    dh: ``q``-row blocks x ``splits`` of the ``kv``-column vocab tiles
    (``tiles_per_split`` each, every split at least one) x slices, one wave
    of one block an SM; dW: ``q``-column vocab blocks x slices, each walking
    every ``kv``-row tile."""
    if D % 128 or D <= 0 or N <= 0 or V <= 0 or kind not in ("dh", "dw"):
        raise ValueError(f"bwd_plan_f32: kind dh or dw, D a multiple of 128 and N, V > 0, "
                         f"got {kind}, {N}, {D}, {V}")
    slices = -(-D // F32_SW)
    sw = -(-D // (slices * 128)) * 128
    slices = -(-D // sw)
    q = max(q for q in F32_QS if q * sw <= F32_OUT)
    kv = F32_TILE // q
    plan = dict(q=q, kv=kv, sw=sw, slices=slices, k_chunks=D // F32_BK,
                kv_chunks=kv // F32_BV, smem=bwd_smem_f32(kind, q, sw))
    if kind == "dh":
        q_blocks, n_tiles = -(-N // q), -(-V // kv)
        splits = max(1, min(n_tiles, sms // (q_blocks * slices)))
        per_split = -(-n_tiles // splits)
        splits = -(-n_tiles // per_split)
        plan.update(grid=(q_blocks, splits, slices), splits=splits, tiles_per_split=per_split)
    else:
        plan.update(grid=(-(-V // q), 1, slices), splits=1, tiles_per_split=-(-N // kv))
    return types.MappingProxyType(plan)  # cached: read-only


# The fp32 forward's tile (csrc/softmax_ce.cu's ce_fwd_f32_kernel, on
# gemm_f32.cuh's loop): rows and vocab columns a block, blocks an SM.
F32_FWD_TILE, F32_FWD_PER_SM = 128, 2


@functools.lru_cache(maxsize=256)
def fwd_plan_f32(N: int, D: int, V: int, sms: int):
    """Launch plan of the fp32 forward kernel at ``N`` rows, hidden width
    ``D`` (a multiple of 128), vocabulary ``V`` on ``sms`` SMs; a pure
    function.

    A block owns 128 rows and walks the 128-column vocab tiles of its
    split, the K chunks of one tile running on into the next's.  Row
    blocks x ``splits`` of the vocab tiles (``tiles_per_split`` each, every
    split at least one), split as ``ops/project.py::vocab_splits`` splits
    the fp32 head: the fewest tile times over waves of two blocks an SM, a
    block's first chunk and final merge costing about one tile (8 row
    blocks x 33 splits of 12 tiles at N = 1,024, V = 50,000, one wave of
    264 on 132 SMs)."""
    if D % 128 or D <= 0 or N <= 0 or V <= 0:
        raise ValueError(f"fwd_plan_f32: D a multiple of 128 and N, V > 0, got {N}, {D}, {V}")
    q_blocks, n_tiles = -(-N // F32_FWD_TILE), -(-V // F32_FWD_TILE)
    splits, per_split = vocab_splits(n_tiles, q_blocks, F32_FWD_PER_SM * sms, FP32_BLOCK_TILES)
    return types.MappingProxyType(dict(  # cached: read-only
        rows=F32_FWD_TILE, cols=F32_FWD_TILE, grid=(q_blocks, splits), splits=splits,
        tiles_per_split=per_split))


def _pad_cols4(W: Tensor) -> Tuple[Tensor, int]:
    """``(W [D, ldw], ldw)``: W zero-padded to a multiple of 4 columns (a
    copy only where V is not one), so every row is 16-byte aligned."""
    V = W.shape[1]
    ldw = -(-V // 4) * 4
    return (torch.nn.functional.pad(W, (0, ldw - V)).contiguous() if ldw != V else W), ldw


def _f32_bwd_operands(h: Tensor, W: Tensor):
    """``(h^T [D, ldh], W [D, ldw], ldh, ldw)`` for the fp32 backward: h
    transposed and W as it is, each zero-padded to a multiple of 4 columns
    (:func:`_pad_cols4`: a copy of W only where V is not one), so every row
    is 16-byte aligned."""
    N = h.shape[0]
    ldh = -(-N // 4) * 4
    pad = torch.nn.functional.pad
    hT = (pad(h.t(), (0, ldh - N)) if ldh != N else h.t()).contiguous()
    Wp, ldw = _pad_cols4(W)
    return hT, Wp, ldh, ldw


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def cast_wt_ref(W: Tensor, Dp: int) -> Tensor:
    """Plain version of :func:`cast_wt`, through torch."""
    return torch.nn.functional.pad(W.t().to(torch.bfloat16), (0, Dp - W.shape[0])).contiguous()


def cast_wt(W: Tensor, Dp: int) -> Tensor:
    """``W [D, V]`` (fp32 or bf16) as ``W^T`` bf16 ``[V, Dp]``, zero past D:
    the bf16 kernels' cast of the weights, transposed in the same pass
    (``cast_wt_kernel``); ``cast_wt.launches`` counts its launches.  On a
    CPU tensor, :func:`cast_wt_ref`."""
    if not W.is_cuda:
        return cast_wt_ref(W, Dp)
    D, V = W.shape
    if W.dtype not in (torch.float32, torch.bfloat16):
        W = W.float()
    W = W.contiguous()
    wt = torch.empty((V, Dp), dtype=torch.bfloat16, device=W.device)
    err = _build.lib().jlm_ce_cast_wt(_ptr(W), _ptr(wt), D, V, Dp,
                                      int(W.dtype == torch.bfloat16),
                                      ctypes.c_void_p(_build.stream_ptr(W)))
    _build.check(err, "cast_wt kernel")
    cast_wt.launches += 1
    return wt


def _bf16_args(h, W, b, y, wt):
    """The bf16 kernels' operands: h bf16 [N, Dp] (D zero-padded to a
    multiple of 128), W^T bf16 [V, Dp] (``wt`` if the caller made it, else
    :func:`cast_wt` here), bias fp32 and targets int32."""
    N, D = h.shape
    V = b.shape[0]
    if tuple(W.shape) != (D, V):
        raise ValueError(f"W must be [{D}, {V}], got {tuple(W.shape)}")
    Dp = -(-D // 128) * 128
    hb = h.to(torch.bfloat16)
    hb = torch.nn.functional.pad(hb, (0, Dp - D)) if Dp != D else hb.contiguous()
    wt = cast_wt(W, Dp) if wt is None else wt
    if tuple(wt.shape) != (V, Dp) or wt.dtype != torch.bfloat16 or not wt.is_contiguous():
        raise ValueError(f"wt must be bf16 [{V}, {Dp}], got {wt.dtype} {tuple(wt.shape)}")
    for name, t in (("W", W), ("wt", wt), ("b", b), ("y", y)):
        if t.device != h.device:
            raise ValueError(f"{name} must be on {h.device}")
    for t in (hb, wt):
        if t.data_ptr() % 16:
            raise ValueError("h and W^T must be 16-byte aligned")
    return hb, wt, b.float().contiguous(), y.to(torch.int32).contiguous(), N, Dp, V


def ce_fwd_raw(h: Tensor, W: Tensor, b: Tensor, y: Tensor,
               compute_dtype=torch.float32, wt: Optional[Tensor] = None):
    """Per-row partial CE triple ``(m, s, t)``, each fp32 ``[N]``.

    ``ce_fwd_raw.launches`` counts launches of the ``ce_fwd`` kernel.  bf16
    compute reads ``W^T``: ``wt``, the :func:`cast_wt` of W, if the caller
    made it (``ce_loss_fused`` makes it once a step for the forward and the
    backward), else a cast here."""
    if not h.is_cuda:
        return ce_fwd_raw_ref(h, W, b, y, compute_dtype)
    _check_dtype(compute_dtype)
    bf16 = compute_dtype == torch.bfloat16
    if bf16:
        hb, Wb, bf, yi, N, D, V = _bf16_args(h, W, b, y, wt)
    else:
        hb, Wb, bf, yi, N, D, V = _f32_args(h, W, b, y)
    out = torch.zeros((3, N), dtype=torch.float32, device=h.device)  # m, s, t
    if N == 0:
        return out[0], out[1], out[2]
    stream = ctypes.c_void_p(_build.stream_ptr(h))
    if bf16:
        plan = fwd_plan(N, D, V, _sms(h.get_device()))
        splits, per_split = plan["splits"], plan["tiles_per_split"]
        part = torch.empty((2, splits, N), dtype=torch.float32, device=h.device)
        err = _build.lib().jlm_ce_fwd_bf16(
            _ptr(hb), _ptr(Wb), _ptr(bf), _ptr(yi), _ptr(part[0]), _ptr(part[1]),
            _ptr(out[0]), _ptr(out[1]), _ptr(out[2]), N, D, V, plan["n_res"], plan["n_sub"],
            splits, per_split, stream)
    else:
        plan = fwd_plan_f32(N, D, V, _sms(h.get_device()))
        splits = plan["splits"]
        Wp, ldw = _pad_cols4(Wb)
        part = torch.empty((2, splits, N), dtype=torch.float32, device=h.device)
        err = _build.lib().jlm_ce_fwd_f32(
            _ptr(hb), _ptr(Wp), _ptr(bf), _ptr(yi), _ptr(part[0]), _ptr(part[1]),
            _ptr(out[0]), _ptr(out[1]), _ptr(out[2]), N, D, V, ldw, splits,
            plan["tiles_per_split"], stream)
    _build.check(err, "ce_fwd kernel")
    ce_fwd_raw.launches += 1
    return out[0], out[1], out[2]


def _bwd_args(h, W, b, y, lse, ga, gb, compute_dtype, wt):
    """The operands of a backward launch in ``compute_dtype``: ``(h, W or
    W^T, b, y, (lse, ga, gb), N, Dp, V)``."""
    _check_dtype(compute_dtype)
    if compute_dtype == torch.bfloat16:
        hb, Wb, bf, yi, N, D, V = _bf16_args(h, W, b, y, wt)
    else:
        hb, Wb, bf, yi, N, D, V = _f32_args(h, W, b, y)
    return hb, Wb, bf, yi, _row_terms(lse, ga, gb, N, h.device), N, D, V


def _plan_args(plan):
    return plan["sw"], plan["n_own"], plan["n_pass"]


def ce_bwd_dh(h, W, b, y, lse, ga, gb, compute_dtype=torch.float32, wt=None) -> Tensor:
    """``dh = gp @ W^T`` in fp32 ``[N, D]``; ``ce_bwd_dh.launches`` counts
    launches of the ``ce_bwd_dh`` kernel.  bf16 compute may take ``wt``,
    the :func:`cast_wt` of W, as :func:`ce_fwd_raw` does."""
    if not h.is_cuda:
        return ce_bwd_dh_ref(h, W, b, y, lse, ga, gb, compute_dtype)
    D0 = h.shape[1]
    hb, Wb, bf, yi, (lse, ga, gb), N, D, V = _bwd_args(h, W, b, y, lse, ga, gb,
                                                      compute_dtype, wt)
    dh = torch.empty((N, D), dtype=torch.float32, device=h.device)
    if N == 0:
        return dh[:, :D0]
    stream = ctypes.c_void_p(_build.stream_ptr(h))
    if compute_dtype == torch.bfloat16:
        plan = bwd_plan("dh", N, D, V, _sms(h.get_device()))
        splits = plan["splits"]
        part = dh if splits == 1 else torch.empty((splits, N, D), dtype=torch.float32,
                                                  device=h.device)
        err = _build.lib().jlm_ce_bwd_dh_bf16(
            _ptr(hb), _ptr(Wb), _ptr(bf), _ptr(yi), _ptr(ga), _ptr(gb), _ptr(lse),
            _ptr(part), _ptr(dh), N, D, V, *_plan_args(plan), splits,
            plan["tiles_per_split"], stream)
    else:
        plan = bwd_plan_f32("dh", N, D, V, _sms(h.get_device()))
        splits = plan["splits"]
        hT, Wp, ldh, ldw = _f32_bwd_operands(hb, Wb)
        part = dh if splits == 1 else torch.empty((splits, N, D), dtype=torch.float32,
                                                  device=h.device)
        err = _build.lib().jlm_ce_bwd_dh_f32(
            _ptr(hT), _ptr(Wp), _ptr(bf), _ptr(yi), _ptr(ga), _ptr(gb), _ptr(lse),
            _ptr(part), _ptr(dh), N, ldh, D, V, ldw, plan["q"], plan["sw"], splits,
            plan["tiles_per_split"], stream)
    _build.check(err, "ce_bwd_dh kernel")
    ce_bwd_dh.launches += 1
    return dh[:, :D0].contiguous() if D != D0 else dh


def ce_bwd_dw(h, W, b, y, lse, ga, gb, compute_dtype=torch.float32,
              wt=None) -> Tuple[Tensor, Tensor]:
    """``dW = h^T @ gp`` fp32 ``[D, V]`` and ``db = sum_rows gp`` fp32
    ``[V]``; ``ce_bwd_dw.launches`` counts launches of the ``ce_bwd_dw``
    kernel.  bf16 compute may take ``wt`` as :func:`ce_bwd_dh` does."""
    if not h.is_cuda:
        return ce_bwd_dw_ref(h, W, b, y, lse, ga, gb, compute_dtype)
    D0 = h.shape[1]
    hb, Wb, bf, yi, (lse, ga, gb), N, D, V = _bwd_args(h, W, b, y, lse, ga, gb,
                                                      compute_dtype, wt)
    dW = torch.empty((D, V), dtype=torch.float32, device=h.device)
    db = torch.empty((V,), dtype=torch.float32, device=h.device)
    if N == 0:
        dW.zero_()
        db.zero_()
    else:
        stream = ctypes.c_void_p(_build.stream_ptr(h))
        if compute_dtype == torch.bfloat16:
            plan = bwd_plan("dw", N, D, V, _sms(h.get_device()))
            err = _build.lib().jlm_ce_bwd_dw_bf16(
                _ptr(hb), _ptr(Wb), _ptr(bf), _ptr(yi), _ptr(ga), _ptr(gb), _ptr(lse),
                _ptr(dW), _ptr(db), N, D, V, *_plan_args(plan), stream)
        else:
            plan = bwd_plan_f32("dw", N, D, V, _sms(h.get_device()))
            hT, Wp, ldh, ldw = _f32_bwd_operands(hb, Wb)
            err = _build.lib().jlm_ce_bwd_dw_f32(
                _ptr(hb), _ptr(hT), _ptr(Wp), _ptr(bf), _ptr(yi), _ptr(ga), _ptr(gb),
                _ptr(lse), _ptr(dW), _ptr(db), N, ldh, D, V, ldw, plan["q"], plan["sw"], stream)
        _build.check(err, "ce_bwd_dw kernel")
        ce_bwd_dw.launches += 1
    return (dW[:D0].contiguous(), db) if D != D0 else (dW, db)


ce_fwd_raw.launches = 0
ce_bwd_dh.launches = 0
ce_bwd_dw.launches = 0
cast_wt.launches = 0


def step_wt(h: Tensor, W: Tensor, compute_dtype) -> Optional[Tensor]:
    """The :func:`cast_wt` of W that one step's bf16 forward and backward
    share on the card, or None (fp32 compute, or a CPU tensor: the plain
    versions cast for themselves)."""
    if h.is_cuda and compute_dtype == torch.bfloat16:
        return cast_wt(W, -(-h.shape[1] // 128) * 128)
    return None


def ce_bwd(h, W, b, y, lse, ga, gb=None, compute_dtype=torch.float32,
           wt=None) -> Tuple[Tensor, Tensor, Tensor]:
    """Backward of the fused CE with cotangent ``gp = ga*p + gb*onehot(y)``
    (``gb=None``: plain CE, ``gb = -ga``): fp32 ``(dh, dW, db)``.  bf16
    compute on the card reads ``wt`` (the forward's, where the caller kept
    it), else casts W once here for both kernels."""
    gb = -ga if gb is None else gb
    h = h.to(compute_dtype)  # cast once for both kernels
    if wt is None:
        wt = step_wt(h, W, compute_dtype)
    if wt is None:
        W = W.to(compute_dtype)
    dh = ce_bwd_dh(h, W, b, y, lse, ga, gb, compute_dtype, wt=wt)
    dW, db = ce_bwd_dw(h, W, b, y, lse, ga, gb, compute_dtype, wt=wt)
    return dh, dW, db


# ------------------------------------------------------------ autograd

class _FusedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, W, b, y, compute_dtype):
        wt = step_wt(h, W, compute_dtype)
        m, s, t = ce_fwd_raw(h, W, b, y, compute_dtype, wt=wt)
        lse = m + torch.log(s)
        ctx.save_for_backward(h, W, b, y, lse, wt)
        ctx.compute_dtype = compute_dtype
        return lse - t

    @staticmethod
    def backward(ctx, g):
        h, W, b, y, lse, wt = ctx.saved_tensors
        dh, dW, db = ce_bwd(h, W, b, y, lse, g.float(), None, ctx.compute_dtype, wt=wt)
        return dh.to(h.dtype), dW.to(W.dtype), db.to(b.dtype), None, None


def ce_loss_fused(h: Tensor, W: Tensor, b: Tensor, y: Tensor,
                  compute_dtype=torch.float32) -> Tensor:
    """Per-row CE loss ``[N]`` without the logits in device memory.

    Saves ``(h, W, b, y, lse)``; the backward returns ``dh`` in h's dtype
    and ``dW``, ``db`` in the weights' dtypes.  bf16 compute on the card
    casts W once a step (:func:`step_wt`) and saves ``W^T`` too, held from
    the forward to the backward: ``V x Dp`` bf16, 51 MB at V = 50,000, D =
    512 (102 MB at D = 1,024)."""
    return _FusedCE.apply(h, W, b, y, compute_dtype)


def _ds_blocks(block_sizes: Sequence[int], block_dims: Sequence[int], mode: str):
    """``(vocab base, hidden start, hidden dim)`` per block."""
    bases = np.concatenate([[0], np.cumsum(block_sizes)[:-1]]).astype(np.int64)
    out, offset = [], 0
    for base, d in zip(bases, block_dims):
        out.append((int(base), 0 if mode == "prefix" else offset, d))
        if mode != "prefix":
            offset += d
    return out


def _local_targets(y, base, size):
    own = (y >= base) & (y < base + size)
    return torch.where(own, y - base, torch.full_like(y, -1))


class _FusedCEDSoftmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, y, spec, *wb):
        block_sizes, block_dims, mode, compute_dtype = spec
        K = len(block_sizes)
        ms, ss, wts, tgt = [], [], [], 0
        for k, (base, start, d) in enumerate(_ds_blocks(block_sizes, block_dims, mode)):
            hk = h[:, start:start + d]
            wts.append(step_wt(hk, wb[k], compute_dtype))
            m, s, t = ce_fwd_raw(hk, wb[k], wb[K + k], _local_targets(y, base, block_sizes[k]),
                                 compute_dtype, wt=wts[-1])
            ms.append(m)
            ss.append(s)
            tgt = tgt + t
        m_all, s_all = torch.stack(ms, dim=1), torch.stack(ss, dim=1)  # [N, K]
        m_g = m_all.amax(dim=1)
        s_g = (s_all * torch.exp(m_all - m_g[:, None])).sum(dim=1)
        lse = m_g + torch.log(s_g)
        ctx.save_for_backward(h, y, lse, *wb, *wts)
        ctx.spec = spec
        return lse - tgt

    @staticmethod
    def backward(ctx, g):
        h, y, lse, *rest = ctx.saved_tensors
        block_sizes, block_dims, mode, compute_dtype = ctx.spec
        K = len(block_sizes)
        wb, wts = rest[:2 * K], rest[2 * K:]
        dh = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
        dws, dbs = [], []
        for k, (base, start, d) in enumerate(_ds_blocks(block_sizes, block_dims, mode)):
            dh_k, dw_k, db_k = ce_bwd(h[:, start:start + d], wb[k], wb[K + k],
                                      _local_targets(y, base, block_sizes[k]), lse,
                                      g.float(), None, compute_dtype, wt=wts[k])
            dh[:, start:start + d] += dh_k
            dws.append(dw_k.to(wb[k].dtype))
            dbs.append(db_k.to(wb[K + k].dtype))
        return (dh.to(h.dtype), None, None, *dws, *dbs)


def ce_loss_fused_dsoftmax(h: Tensor, weights: Sequence[Tensor],
                           biases: Sequence[Tensor], y: Tensor,
                           block_sizes: Sequence[int], block_dims: Sequence[int],
                           mode: str = "prefix", compute_dtype=torch.float32) -> Tensor:
    """Per-row CE loss ``[N]`` for the D-softmax head: block k projects
    its hidden slice (``h[:, :d_k]`` in prefix mode, its own segment in
    disjoint mode) through the fused kernels with block-local targets
    (-1 where another block owns the target), and the block partials merge
    as ``m = max_k m_k``, ``s = sum_k s_k exp(m_k - m)``, ``t = sum_k t_k``.
    The backward runs each block's kernels with the GLOBAL lse and adds
    each block's dh into its slice in fp32; in bf16 on the card each
    block's ``W^T`` is cast once and kept from the forward to the backward,
    as :func:`ce_loss_fused` keeps its one."""
    spec = (tuple(block_sizes), tuple(block_dims), mode, compute_dtype)
    return _FusedCEDSoftmax.apply(h, y, spec, *weights, *biases)
