"""Vocab-sharded output head, globally consistent top-k, and the
vocab-parallel loss, one process per rank.

Counterpart of :mod:`jlm_tpu.parallel.sharded_head` (the sequence-sharded
layout; the reference's ``seq_shard=False`` layout is not ported and
raises).  Each rank holds its own columns of the head: every D-softmax
block is column-sharded, so rank ``v`` of ``n`` owns the ``v``-th
``size / n`` columns of every block (the per-rank work stays balanced over
the frequency tiers); a full head is one block.  The embedding and the
LSTM are replicated.

- :func:`make_sharded_forward` — the decode forward.  Sentence rows shard
  over both mesh axes (``min_batch = data * vocab``); each rank embeds and
  steps its own rows; at the head one all_gather of the vocab group's
  ``h_top``, the local head's logits, a global logsumexp by one MAX and
  one SUM, and (plain forward) the candidate and ``<eos>`` logits back to
  their owners by one reduce_scatter.  The kernel forward runs the cell,
  ``cand_dot`` over a replicated candidate table (no candidate exchange)
  and ``project_ms`` on the local columns, whose ``(m, s)`` merge across
  the group.
- :func:`sharded_topk` — local ``topk_stable``, gather of (value, global
  id), re-top-k: ``topk_stable`` on the whole row, ties included.
- :func:`vocab_parallel_nll` — Megatron-style vocab-parallel CE, plain or
  through the fused CE kernels on the local columns.  ``dh`` is each
  rank's columns' share, summed over the vocab group exactly once
  (:func:`_reduce_dh`).

Collectives: :mod:`jlm_tpu_torch.parallel.comm`.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from jlm_tpu_torch.config import Config, EOS_ID
from jlm_tpu_torch.models.lstm import _block_spans, embed, head_logits, lstm_step
from jlm_tpu_torch.parallel import comm
from jlm_tpu_torch.parallel.mesh import Mesh

SEQ_SHARD_ONLY = ("seq_shard=False (rows replicated over the vocab axis) is not ported: "
                  "the port runs the sequence-sharded layout only")


# --------------------------------------------------------------------------
# Static vocab layout
# --------------------------------------------------------------------------

def shard_layout(config: Config, n: int) -> List[Tuple[int, int, int, int, int]]:
    """Per block ``(first column of h, width d, global base, words,
    words a rank)``, in vocab order; a full head is one block.  Raises
    unless every block divides over ``n`` ranks."""
    if config.head == "dsoftmax":
        spans = _block_spans(config)
    else:
        spans = [(0, config.hidden_size, 0, config.vocab_size)]
    for _, _, _, size in spans:
        if size % n:
            what = "dsoftmax block sizes" if config.head == "dsoftmax" else "vocab"
            raise ValueError(f"{what} {[s[3] for s in spans]} must divide by mesh_vocab={n}")
    return [(start, d, base, size, size // n) for start, d, base, size in spans]


def vocab_layout(config: Config, n: int) -> Tuple[Callable, int]:
    """``(owner_pos, v_local)``: ``owner_pos(ids)`` maps global word ids to
    (owner rank, column in the owner's local head)."""
    layout = shard_layout(config, n)
    bases = [b for _, _, b, _, _ in layout]
    slices = [s for _, _, _, _, s in layout]
    local_bases = [sum(slices[:k]) for k in range(len(slices))]

    def owner_pos(ids: torch.Tensor):
        dev = ids.device
        base_t = torch.tensor(bases, dtype=torch.long, device=dev)
        blk = torch.searchsorted(base_t, ids.long(), right=True) - 1
        off = ids.long() - base_t[blk]
        sl = torch.tensor(slices, dtype=torch.long, device=dev)[blk]
        lb = torch.tensor(local_bases, dtype=torch.long, device=dev)[blk]
        return off // sl, lb + off % sl

    return owner_pos, sum(slices)


def local_ids(config: Config, mesh: Mesh) -> torch.Tensor:
    """The global ids of this rank's local head columns, in local order
    (ascending)."""
    vi = mesh.vocab_index
    return torch.cat([torch.arange(base + vi * s, base + (vi + 1) * s)
                      for _, _, base, _, s in shard_layout(config, mesh.vocab)])


# --------------------------------------------------------------------------
# Params: slice the head's columns, gather them back
# --------------------------------------------------------------------------

def _head_blocks(head: Dict[str, Any]) -> List[Dict[str, Any]]:
    return head["blocks"] if "blocks" in head else [head]


def _cols(leaf, lo: int, hi: int):
    if isinstance(leaf, dict):
        return {"q": leaf["q"][:, lo:hi].contiguous(), "scale": leaf["scale"][lo:hi].contiguous()}
    return leaf[..., lo:hi].contiguous()


def _is_full(head: Dict[str, Any], config: Config) -> bool:
    b = _head_blocks(head)[0]["b"]
    return b.shape[0] == shard_layout(config, 1)[0][3]


def shard_params(params: Dict[str, Any], config: Config, mesh: Mesh) -> Dict[str, Any]:
    """This rank's params: the head's columns of every block sliced to its
    own (``q`` and ``scale`` of an int8 head along the same axis); the
    embedding and the LSTM as they are.  Params whose head is already
    this rank's come back unchanged."""
    head = params["head"]
    if mesh.vocab == 1 or not _is_full(head, config):
        return params
    vi = mesh.vocab_index
    blocks = []
    for blk, (_, _, _, _, s) in zip(_head_blocks(head), shard_layout(config, mesh.vocab)):
        blocks.append({"W": _cols(blk["W"], vi * s, (vi + 1) * s),
                       "b": _cols(blk["b"], vi * s, (vi + 1) * s)})
    out = {k: v for k, v in params.items() if k != "_decode"}
    out["head"] = {"blocks": blocks} if "blocks" in head else blocks[0]
    return out


def _gather_cols(t: torch.Tensor, group) -> torch.Tensor:
    g = comm.all_gather(t.contiguous(), group)  # [n, ..., s]
    return torch.movedim(g, 0, -2).reshape(t.shape[:-1] + (-1,))


def unshard_params(params: Dict[str, Any], config: Config, mesh: Mesh) -> Dict[str, Any]:
    """The full params from every rank's head columns (one all_gather per
    leaf over the vocab group); collective: every rank of the group calls
    it."""
    head = params["head"]
    if mesh.vocab == 1 or _is_full(head, config):
        return params
    g = mesh.vocab_group

    def leaf(x):
        if isinstance(x, dict):
            return {"q": _gather_cols(x["q"], g), "scale": _gather_cols(x["scale"], g)}
        return _gather_cols(x.detach(), g)

    blocks = [{"W": leaf(b["W"]), "b": leaf(b["b"])} for b in _head_blocks(head)]
    out = {k: v for k, v in params.items() if k != "_decode"}
    out["head"] = {"blocks": blocks} if "blocks" in head else blocks[0]
    return out


# --------------------------------------------------------------------------
# Decode-time sharded forward (plugs into BeamDecoder as forward_fn)
# --------------------------------------------------------------------------

def merge_lse(m: torch.Tensor, s: Optional[torch.Tensor], group) -> torch.Tensor:
    """The global logsumexp ``[...]`` of the parts on the last axis of
    every rank's ``m [..., K]`` (each part's max) and ``s [..., K]`` (its
    sum of ``exp(x - m)``; ``None``: ones, so ``m`` holds logits): one MAX
    and one SUM over the group.  Differentiable in ``m`` and ``s`` on
    this rank (the SUM's gradient passes as it is, the max is a shift)."""
    m_g = comm.all_reduce_max(m.detach().amax(dim=-1), group)
    e = torch.exp(m - m_g[..., None])
    if s is not None:
        e = e * s
    return m_g + torch.log(comm.reduce_from(e.sum(dim=-1), group))


def _own_rows(x: torch.Tensor, mesh: Mesh, rows: int) -> torch.Tensor:
    vi = mesh.vocab_index
    return x[vi * rows:(vi + 1) * rows]


def make_sharded_forward(
    mesh: Mesh, config: Config, precision: str = "highest", seq_shard: bool = True,
    use_kernels: Optional[bool] = None, compute_dtype=torch.bfloat16,
    int8_mxu: Optional[bool] = None,
) -> Callable:
    """Batched decode forward with the head sharded over the vocab axis.

    Engine signature: ``(params, words [S_l, B], state [L, S_l*B, H],
    payload)`` on this rank's ``S_l`` sentences.  ``use_kernels`` (default:
    on when the mesh's device is CUDA) builds it from the kernels (see
    :func:`_make_sharded_kernel_forward`); else the plain fp32 head
    (``precision`` "highest": TF32 off).  Carries ``score_hidden``,
    ``place_params`` (the params this rank keeps), ``min_batch`` (the
    engine pads a chunk to a multiple of ``data * vocab`` sentences) and
    ``mesh``."""
    from jlm_tpu_torch.decoder.engine import lstm_only

    lstm_only("the vocab-sharded forward", config=config)
    if not seq_shard:
        raise ValueError(SEQ_SHARD_ONLY)
    if use_kernels is None:
        use_kernels = mesh.device.type == "cuda"
    if use_kernels:
        return _make_sharded_kernel_forward(mesh, config, compute_dtype, int8_mxu)
    from jlm_tpu_torch.decoder.engine import _set_fp32_matmuls

    if precision == "highest":
        _set_fp32_matmuls()
    n, g = mesh.vocab, mesh.vocab_group
    owner_pos, v_local = vocab_layout(config, n)

    def _sharded_head(head, h_top, ids):
        """``h_top [R_l, H]``, ``ids [S_l, C1]`` -> this rank's rows'
        log-probs of ``ids``, split ``([S_l, B, C1 - 1], [S_l, B])``."""
        S_l, C1 = ids.shape
        R_l = h_top.shape[0]
        B = R_l // S_l
        h_grp = comm.all_gather(h_top, g).reshape(-1, h_top.shape[1])
        ids_grp = comm.all_gather(ids, g).reshape(-1, C1)
        S_grp = ids_grp.shape[0]
        logits = head_logits({"head": head}, config, h_grp).float()  # [R_grp, Vl]
        lse = merge_lse(logits, None, g)
        owner, pos = owner_pos(ids_grp)
        mine = owner == mesh.vocab_index
        vals = logits.reshape(S_grp, B, v_local).gather(
            2, pos.clamp(0, v_local - 1)[:, None, :].expand(S_grp, B, C1))
        vals = torch.where(mine[:, None, :], vals, torch.zeros_like(vals))
        vals = comm.reduce_scatter(vals, g)  # [S_l, B, C1]: own sentences, summed
        vals = vals - _own_rows(lse, mesh, R_l).reshape(S_l, B, 1)
        return vals[:, :, :-1], vals[:, :, -1]

    def forward(params, words, state, cand_words):
        S, B = words.shape
        x = embed(params, words.reshape(S * B))
        h_top, state = lstm_step(params, config, x, state)
        eos = torch.full((S, 1), EOS_ID, dtype=cand_words.dtype, device=cand_words.device)
        cand_logp, eos_logp = _sharded_head(params["head"], h_top,
                                            torch.cat([cand_words, eos], dim=1))
        return cand_logp, eos_logp, state

    def score_hidden(params, h_top, cand_words):
        """Candidate log-probs ``[S', B, C]`` of this rank's ``h_top [S',
        B, H]`` (no LSTM step): the same head exchange, without ``<eos>``."""
        Sp, B, H = h_top.shape
        cand_logp, last = _sharded_head(params["head"], h_top.reshape(Sp * B, H), cand_words)
        return torch.cat([cand_logp, last[:, :, None]], dim=2)

    def place_params(params):
        return shard_params(params, config, mesh)

    forward.score_hidden = score_hidden
    forward.place_params = place_params
    forward.compute_dtype = torch.float32
    forward.min_batch = mesh.data * mesh.vocab
    forward.mesh = mesh
    return forward


def _make_sharded_kernel_forward(mesh: Mesh, config: Config, compute_dtype=torch.bfloat16,
                                 int8_mxu: Optional[bool] = None) -> Callable:
    """The kernel forward of ``make_kernel_forward`` on this rank's rows:
    ``lstm_cell_step`` per layer, ``cand_dot`` over the replicated
    candidate table ``head_T`` (each rank scores only its own sentences,
    no exchange), and ``project_ms`` on the rank's LOCAL head columns over
    the vocab group's gathered rows, each block's ``(m, s)`` merged
    locally (``merge_ms``) and then across the group by one MAX and one
    SUM.  ``place_params`` builds the decode-side head from the full head
    (gathered if the params are already sharded) and keeps only the local
    columns' ``head_c``."""
    from jlm_tpu_torch.decoder.engine import build_decode_head, make_kernel_forward
    from jlm_tpu_torch.ops.cand_dot import cand_dot
    from jlm_tpu_torch.ops.lstm_cell import lstm_cell_step
    from jlm_tpu_torch.ops.project import project_ms

    base = make_kernel_forward(config, compute_dtype, int8_mxu)  # prepare; fp32 rule
    if int8_mxu is None:
        int8_mxu = config.int8_mxu
    shard_layout(config, mesh.vocab)  # raises unless the blocks divide
    g = mesh.vocab_group

    def _lse(head_c, h_rows):
        """This rank's rows' global lse ``[R_l]``."""
        R_l, H = h_rows.shape
        h_grp = comm.all_gather(h_rows, g).reshape(-1, H)
        m, s = project_ms(h_grp, head_c, config, compute_dtype=compute_dtype,
                          int8_mxu=int8_mxu)  # [R_grp, 1]: this rank's columns
        return _own_rows(merge_lse(m, s, g), mesh, R_l)

    def forward(params, words, state, payload):
        S, B = words.shape
        dec = params["_decode"]
        x = embed(params, words.reshape(S * B))
        c, h = state
        new_c, new_h = [], []
        for l, layer in enumerate(dec["lstm_c"]):
            c_l, h_l = lstm_cell_step(
                x, h[l], c[l], layer["W"], layer["b"], config.forget_bias,
                compute_dtype=compute_dtype, c_out_dtype=compute_dtype)
            new_c.append(c_l)
            new_h.append(h_l)
            x = h_l
        lse = _lse(dec["head_c"], x)
        raw = cand_dot(x.reshape(S, B, -1), payload["cols"], payload["bias"])
        logp = raw - lse.reshape(S, B, 1)
        return logp[:, :, :-1], logp[:, :, -1], (torch.stack(new_c), torch.stack(new_h))

    def score_hidden(params, h_top, payload):
        S, B, H = h_top.shape
        x = h_top.to(compute_dtype).contiguous()
        lse = _lse(params["_decode"]["head_c"], x.reshape(S * B, H))
        raw = cand_dot(x, payload["cols"], payload["bias"])
        return (raw - lse.reshape(S, B, 1))[:, :, :-1]

    def place_params(params):
        full = unshard_params(params, config, mesh)
        dec = params.get("_decode")
        if dec is None:
            dec = build_decode_head(full, config, compute_dtype)
        local = shard_params(full, config, mesh)
        dec = dict(dec)
        dec["head_c"] = build_decode_head({"head": local["head"], "lstm": []}, config,
                                          compute_dtype)["head_c"]
        local["_decode"] = dec
        return local

    forward.prepare = base.prepare
    forward.score_hidden = score_hidden
    forward.place_params = place_params
    forward.compute_dtype = compute_dtype
    forward.min_batch = mesh.data * mesh.vocab
    forward.mesh = mesh
    return forward


# --------------------------------------------------------------------------
# Globally consistent sharded top-k
# --------------------------------------------------------------------------

def sharded_topk(mesh: Mesh, logits: torch.Tensor, k: int,
                 ids: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of a row-wise ``[B, V]`` array held as each rank's columns
    ``logits [B, V_l]``, equal to ``topk_stable`` on the whole rows, ties
    included (the lower global id first).

    ``ids [V_l]`` are the local columns' global ids (ascending; default
    the contiguous shard ``v * V_l + j``).  Local ``topk_stable`` -> one
    gather of the (value, global id) pairs over the vocab group ->
    ``topk_stable`` again over them in global-id order (for contiguous
    shards that is the shard-major order the gather gives)."""
    from jlm_tpu_torch.decoder.engine import topk_stable

    g = mesh.vocab_group
    Bn, vl = logits.shape
    kl = min(k, vl)
    vals, idx = topk_stable(logits, kl)
    gids = idx + mesh.vocab_index * vl if ids is None else ids.to(idx.device)[idx]
    av = comm.all_gather(vals, g).permute(1, 0, 2).reshape(Bn, -1)
    ai = comm.all_gather(gids, g).permute(1, 0, 2).reshape(Bn, -1)
    if ids is not None:
        order = torch.argsort(ai, dim=1, stable=True)
        av, ai = av.gather(1, order), ai.gather(1, order)
    fv, fi = topk_stable(av, k)
    return fv, ai.gather(1, fi)


# --------------------------------------------------------------------------
# Training: vocab-parallel cross-entropy
# --------------------------------------------------------------------------

def _reduce_dh(dh: torch.Tensor, group) -> torch.Tensor:
    """The one SUM of ``dh`` over the vocab group: each rank's ``dh`` is
    its own columns' share.  (JAX's ``shard_map`` transpose sums the
    replicated input's cotangent itself; in torch nothing else does.)"""
    return comm.all_reduce_sum(dh, group)


class _HeadInput(torch.autograd.Function):
    """The head's replicated input: identity forward, ``_reduce_dh``
    backward."""

    @staticmethod
    def forward(ctx, h, group):
        ctx.group = group
        return h.view_as(h)

    @staticmethod
    def backward(ctx, g):
        return _reduce_dh(g.contiguous(), ctx.group), None


def _ce_blocks(config: Config, mesh: Mesh):
    """Per local block ``(first column of h, width, first global id of this
    rank's slice, words a rank)``."""
    vi = mesh.vocab_index
    return [(start, d, base + vi * s, s)
            for start, d, base, _, s in shard_layout(config, mesh.vocab)]


class _VocabParallelCE(torch.autograd.Function):
    """Per-row CE over the vocab group through the fused CE kernels on
    this rank's columns: per block ``ce_fwd_raw`` with targets -1 off this
    rank's slice, ``(m, s, t)`` merged by one MAX and two SUMs; backward
    ``ce_bwd_dh`` / ``ce_bwd_dw`` from the global lse, ``dh`` summed over
    the group once (:func:`_reduce_dh`), ``dW`` and ``db`` local."""

    @staticmethod
    def forward(ctx, h, y, spec, *wb):
        from jlm_tpu_torch.ops.softmax_ce import _local_targets, ce_fwd_raw, step_wt

        blocks, group, compute_dtype = spec
        K = len(blocks)
        ms, ss, wts, tgt = [], [], [], 0
        for k, (start, d, lo, size) in enumerate(blocks):
            hk = h[:, start:start + d]
            wts.append(step_wt(hk, wb[k], compute_dtype))
            m, s, t = ce_fwd_raw(hk, wb[k], wb[K + k], _local_targets(y, lo, size),
                                 compute_dtype, wt=wts[-1])
            ms.append(m)
            ss.append(s)
            tgt = tgt + t
        lse = merge_lse(torch.stack(ms, dim=1), torch.stack(ss, dim=1), group)  # [N, K] parts
        wts = [w for w in wts if w is not None]
        ctx.save_for_backward(h, y, lse, *wb, *wts)
        ctx.spec = spec
        return lse - comm.all_reduce_sum(tgt, group)

    @staticmethod
    def backward(ctx, g):
        from jlm_tpu_torch.ops.softmax_ce import _local_targets, ce_bwd

        h, y, lse, *rest = ctx.saved_tensors
        blocks, group, compute_dtype = ctx.spec
        K = len(blocks)
        wb, wts = rest[:2 * K], rest[2 * K:]
        dh = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
        dws, dbs = [], []
        for k, (start, d, lo, size) in enumerate(blocks):
            dh_k, dw_k, db_k = ce_bwd(h[:, start:start + d], wb[k], wb[K + k],
                                      _local_targets(y, lo, size), lse, g.float(), None,
                                      compute_dtype, wt=wts[k] if wts else None)
            dh[:, start:start + d] += dh_k
            dws.append(dw_k.to(wb[k].dtype))
            dbs.append(db_k.to(wb[K + k].dtype))
        return (_reduce_dh(dh, group).to(h.dtype), None, None, *dws, *dbs)


def vocab_parallel_nll(mesh: Mesh, config: Config, precision: str = "default",
                       use_kernels: bool = False) -> Callable:
    """``loss(params, hs [b, T, H], targets [b, T])``: the mean token NLL
    over this rank's rows, with the head column-sharded over the vocab
    group (every rank of the group holds the same value).  The data-axis
    mean is the train step's (one SUM of the gradients over the data
    group, then a divide).

    Plain: local logits, the global lse by MAX + SUM, the target logit
    from its owner by a SUM.  ``use_kernels``: the fused CE kernels on the
    local columns (:class:`_VocabParallelCE`; fp32 or int8 heads are not
    trained there), computing in bf16 unless ``precision`` is "highest",
    as the single-device ``full_softmax_loss`` does."""
    g = mesh.vocab_group
    owner_pos, v_local = vocab_layout(config, mesh.vocab)
    blocks = _ce_blocks(config, mesh)
    cd = torch.float32 if precision == "highest" else torch.bfloat16

    def loss(params, hs, targets):
        head = params["head"]
        b, T, H = hs.shape
        h, t = hs.reshape(b * T, H), targets.reshape(b * T)
        if use_kernels:
            blks = _head_blocks(head)
            if any(isinstance(blk["W"], dict) for blk in blks):
                raise ValueError("the vocab-parallel fused CE trains fp32 or bf16 heads only")
            return _VocabParallelCE.apply(
                h, t, (blocks, g, cd), *[blk["W"] for blk in blks],
                *[blk["b"] for blk in blks]).mean()
        h = _HeadInput.apply(h, g) if mesh.vocab > 1 else h
        logits = head_logits({"head": head}, config, h).float()  # [N, V_l]
        lse = merge_lse(logits, None, g)
        owner, pos = owner_pos(t)
        tl = logits.gather(1, pos.clamp(0, v_local - 1)[:, None])[:, 0]
        tl = comm.reduce_from(torch.where(owner == mesh.vocab_index, tl,
                                          torch.zeros_like(tl)), g)
        return (lse - tl).mean()

    return loss
