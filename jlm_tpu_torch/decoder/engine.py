"""Device-resident batched beam-Viterbi decoding in PyTorch.

Counterpart of :mod:`jlm_tpu.decoder.engine`.  A chunk of lattices is
bit-packed on the host into ONE ``[S, T, N]`` int32 upload; the whole
search then runs on the device as a Python loop over frames that never
waits for the device (no ``.item()``, no data-dependent shapes, no branch
on a tensor value), so the host enqueues a chunk's work and moves on to
build the next chunk's lattices.  Per frame:

- gather each node's cached candidate log-prob from the beam at its start
  position (ring caches of ``R = 8`` rows: a node spans at most
  ``max_word_len < R`` kana) -> extension scores ``[S, N, B]``;
- per-sentence stable top-k (argmax passes; the lower flat index wins a
  tie) over the node-major, path-minor enumeration;
- gather the surviving LSTM states (``torch.gather`` — exact, so the TPU's
  one-hot selection matmuls are not needed);
- ONE batched LM forward over all ``S*B`` beam rows;
- rescore ``<eos>`` at each sentence's true length, in the loop.

Backtracking runs on the device, and one packed int32 blob per chunk
returns to the host.  In speed mode the state ring caches are bf16.

The LM forward (``forward_fn(params, words [S, B], (c, h) [L, S*B, H],
payload) -> (cand_logp [S, B, C], eos_logp [S, B], state)``) is chosen by
``BeamDecoder``'s ``precision`` or passed as its ``forward_fn``:
``make_full_softmax_forward`` is the fp32 parity forward,
``make_kernel_forward`` the forward through the three hand-written kernels
(bf16 speed mode, or fp32 compute), with a full or D-softmax head and bf16,
fp32 or int8 weights (native int8 x int8 or dequant), and
``make_fused_frame_forward`` the reference's ``fusedcand`` frame (one
layer): the fused cell + candidate-dot kernel, then the head normalizer.
A forward may carry
``prepare(params, look_w [S, T1, C]) -> payload``, run once per chunk;
every payload leaf is TIME-MAJOR (``[T1, S, ...]``) so a frame's slice is
contiguous.

An input longer than ``max_kana_len`` goes through ``decode_long``
(``decode`` and ``decode_batch`` route it there): multi-root overlap-save
chunks whose boundary beams seed the next chunk on the device, stitched on
the host after one fetch.

While the tracer of :mod:`jlm_tpu_torch.utils.profiling` is on,
``decode_stream`` is the span ``decode.job`` and each chunk's phases its
spans ``decode.pack``, ``decode.enqueue``, ``decode.fetch`` (the blob's copy,
which waits for the device) and ``decode.surfaces``; ``_pack`` counts the
chunk's sentences, kana and real nodes against the slots the search scans.

A vocab-sharded forward (``jlm_tpu_torch.parallel.make_sharded_forward``)
carries its ``mesh``: every rank builds the same lattices (the packers are
deterministic), pads the chunk to a multiple of ``min_batch`` (data x
vocab) sentences, scans its own rows, and gathers the result blobs, so
every rank returns the whole batch.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from jlm_tpu_torch.config import Config, EOS_ID, UNK_ID
from jlm_tpu_torch.data.corpus import Vocab
from jlm_tpu_torch.data.lexicon import Lexicon
from jlm_tpu_torch.decoder.lattice import Lattice, build_lattice
from jlm_tpu_torch.oracle.decoder import DecodeResult
from jlm_tpu_torch.models.lstm import _w, embed, head_logits, log_softmax, step_logp
from jlm_tpu_torch.models.params import params_to_torch, resolve_device
from jlm_tpu_torch.ops.cand_dot import cand_dot
from jlm_tpu_torch.ops.frame_step import cell_cand_step
from jlm_tpu_torch.ops.lstm_cell import cell_weight_tiles, lstm_cell_step
from jlm_tpu_torch.ops.project import head_blocks, project_lse
from jlm_tpu_torch.utils import profiling

ForwardFn = Callable[..., Tuple[torch.Tensor, torch.Tensor, Any]]

# bit-packing layout for the lattice upload (see pack_lattice_batch); the
# same layout as jlm_tpu.decoder.engine, pinned bit-equal by the tests
_WORD_BITS = 17  # vocab ids < 131072
_START_SHIFT = 17  # start position: 6 bits (T_max <= 63)
_CIDX_SHIFT = 23  # lookahead column: 6 bits (C_max <= 64)
_MASK_SHIFT = 29

_RING = 8  # ring rows of the per-position caches (> max_word_len)
NEG = -1e30  # dead score; liveness is tested as > NEG / 2


def topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k with ``lax.top_k``'s exact semantics: values descending, ties
    in ascending index order.  ``torch.topk`` does not keep tie order;
    ``torch.argmax`` returns the first maximum, so k argmax-and-mask passes
    reproduce the frozen rule bit for bit."""
    col = torch.arange(x.shape[1], device=x.device)[None, :]
    vals, idxs = [], []
    for _ in range(k):
        i = torch.argmax(x, dim=1, keepdim=True)
        vals.append(x.gather(1, i))
        idxs.append(i)
        x = torch.where(col == i, float("-inf"), x)
    return torch.cat(vals, dim=1), torch.cat(idxs, dim=1)


def upload(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``; to the card from pinned memory, so the
    copy does not block the host."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def fetch(tensors: List[torch.Tensor]) -> List[np.ndarray]:
    """Device int32 tensors as host arrays of their shapes, in ONE
    device-to-host copy."""
    host = torch.cat([t.reshape(-1) for t in tensors]).cpu().numpy()
    ends = np.cumsum([t.numel() for t in tensors])
    return [host[e - t.numel():e].reshape(t.shape) for t, e in zip(tensors, ends)]


def _set_fp32_matmuls() -> None:
    """True fp32 products on the card: the parity rule (TF32 keeps ~3
    decimal digits and would break path identity)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def full_softmax_forward(params, config: Config, words, state, cand_words):
    """Batched reference forward: full log-softmax then candidate gather."""
    S, B = words.shape
    logp, state = step_logp(params, config, words.reshape(S * B), state)
    lp = logp.reshape(S, B, -1)
    cand_logp = lp.gather(2, cand_words[:, None, :].expand(S, B, -1))
    return cand_logp, lp[:, :, EOS_ID], state


def make_full_softmax_forward(config: Config) -> ForwardFn:
    """The fp32 parity forward (plain torch, TF32 off), with the
    ``score_hidden`` hook: ``score_hidden(params, h_top [S, B, H],
    cand_words [S, C]) -> [S, B, C]`` scores a candidate table from top
    hidden states already computed (no LSTM step) — the multi-root
    ``decode_long`` seeding, where a chunk scores its own lookahead from
    the previous chunk's exported beams."""
    _set_fp32_matmuls()

    def forward(params, words, state, cand_words):
        return full_softmax_forward(params, config, words, state, cand_words)

    def score_hidden(params, h_top, cand_words):
        S, B, H = h_top.shape
        lp = log_softmax(head_logits(params, config, h_top.reshape(S * B, H))).reshape(S, B, -1)
        return lp.gather(2, cand_words[:, None, :].expand(S, B, -1))

    forward.compute_dtype = torch.float32
    forward.score_hidden = score_hidden
    return forward


def build_decode_head(params, config: Config, compute_dtype=torch.float32):
    """One-time decode-side head prep, stashed under ``params["_decode"]``
    (counterpart of the reference's, engine.py:159-225):

    - ``head_T [V, H]``: every word's output column as a row, dequantized,
      in ``compute_dtype`` — the candidate rows ``prepare`` gathers.  A
      D-softmax block's rows are zero-padded to H, on the right in prefix
      mode and around the block's own columns in disjoint mode, and the
      blocks' rows are concatenated in vocab order;
    - ``bias [V]`` fp32 (the blocks' biases concatenated);
    - ``head_c``: the projection head for ``project_lse`` — int8 dicts pass
      through, fp weights are cast to ``compute_dtype`` — plus, per block,
      ``"WT"``, the ``[V_k, d_k]`` transposed weight the kernel reads (the
      int8 ``q`` transposed, or the cast weight transposed; ``head_T``
      itself for a full fp head);
    - ``lstm_c``: per layer the dequantized cell weight in ``compute_dtype``
      (for bf16 with the gate-tiled copy the bf16 cell kernel reads,
      ``cell_weight_tiles``, made here and kept on it) and its fp32 bias.
    """
    head = params["head"]
    H = config.hidden_size
    lstm_c = []
    for layer in params["lstm"]:
        W = _w(layer["W"]).to(compute_dtype).contiguous()
        lstm_c.append({"W": W, "b": layer["b"].float().contiguous()})
        if compute_dtype == torch.bfloat16:
            cell_weight_tiles(W, W.shape[0] - H, H)

    def cast(W):  # -> (head_c weight, its [V_k, d_k] transpose)
        if isinstance(W, dict):
            return W, W["q"].t().contiguous()
        W = W.to(compute_dtype)
        return W, W.t().contiguous()

    if "blocks" not in head:
        W = head["W"]
        head_T = _w(W).t().to(compute_dtype).contiguous()
        W_c, WT = cast(W) if isinstance(W, dict) else (W.to(compute_dtype), head_T)
        return {"head_T": head_T, "bias": head["b"].float(),
                "head_c": {"W": W_c, "b": head["b"], "WT": WT}, "lstm_c": lstm_c}
    rows, blocks_c = [], []
    for off, d, blk in head_blocks(head, config, H):
        rows.append(torch.nn.functional.pad(_w(blk["W"]).float().t(), (off, H - off - d)))
        W_c, WT = cast(blk["W"])
        blocks_c.append({"W": W_c, "b": blk["b"], "WT": WT})
    return {"head_T": torch.cat(rows).to(compute_dtype).contiguous(),
            "bias": torch.cat([blk["b"].float() for blk in head["blocks"]]),
            "head_c": {"blocks": blocks_c}, "lstm_c": lstm_c}


def make_kernel_forward(config: Config, compute_dtype=torch.bfloat16,
                        int8_mxu: Optional[bool] = None) -> ForwardFn:
    """Batched forward through the three kernels (counterpart of
    ``make_pallas_forward``, engine.py:228-323): fused cell per layer, the
    vocab-tiled normalizer ``project_lse`` (full or D-softmax head; int8
    heads take the native int8 x int8 product when ``int8_mxu``, default
    ``config.int8_mxu``, else the dequant product), and ``cand_dot`` over
    candidate head rows pre-gathered once per chunk by ``prepare`` (EOS as
    the last column).  ``compute_dtype`` is bf16 (speed mode: bf16 ring
    caches and ``c'``) or fp32 (exact fp32 products, TF32 off: the parity
    mode)."""
    if compute_dtype == torch.float32:
        _set_fp32_matmuls()
    elif compute_dtype != torch.bfloat16:
        raise ValueError(f"compute_dtype must be bf16 or fp32, not {compute_dtype}")
    if int8_mxu is None:
        int8_mxu = config.int8_mxu

    def prepare(params, look_w):
        """[S, T1, C] ids -> time-major cols [T1, S, C+1, H], bias [T1, S, C+1]."""
        dec = params["_decode"]
        S, T1, C = look_w.shape
        eos = torch.full((S, T1, 1), EOS_ID, dtype=look_w.dtype, device=look_w.device)
        ids = torch.cat([look_w, eos], dim=2).transpose(0, 1).contiguous()
        return {"cols": dec["head_T"][ids], "bias": dec["bias"][ids]}

    def forward(params, words, state, payload):
        S, B = words.shape
        dec = params["_decode"]
        x = embed(params, words.reshape(S * B))
        c, h = state
        new_c, new_h = [], []
        for l, layer in enumerate(dec["lstm_c"]):
            c_l, h_l = lstm_cell_step(
                x, h[l], c[l], layer["W"], layer["b"], config.forget_bias,
                compute_dtype=compute_dtype, c_out_dtype=compute_dtype,
            )
            new_c.append(c_l)
            new_h.append(h_l)
            x = h_l
        lse = project_lse(x, dec["head_c"], config, compute_dtype=compute_dtype,
                          int8_mxu=int8_mxu)  # [S*B, 1]
        raw = cand_dot(x.reshape(S, B, -1), payload["cols"], payload["bias"])
        logp = raw - lse.reshape(S, B, 1)
        return logp[:, :, :-1], logp[:, :, -1], (torch.stack(new_c), torch.stack(new_h))

    def score_hidden(params, h_top, payload):
        """Candidate log-probs ``[S, B, C]`` from top hidden states
        ``h_top [S, B, H]`` (no LSTM step): one ``cand_dot`` and one
        ``project_lse`` over the S*B rows; ``payload`` is ``prepare``'s
        output for one position of each of the S rows' windows."""
        S, B, H = h_top.shape
        x = h_top.to(compute_dtype).contiguous()
        lse = project_lse(x.reshape(S * B, H), params["_decode"]["head_c"], config,
                          compute_dtype=compute_dtype, int8_mxu=int8_mxu)
        raw = cand_dot(x, payload["cols"], payload["bias"])
        return (raw - lse.reshape(S, B, 1))[:, :, :-1]

    forward.prepare = prepare
    forward.score_hidden = score_hidden
    forward.compute_dtype = compute_dtype
    return forward


def make_fused_frame_forward(config: Config, compute_dtype=torch.bfloat16,
                             int8_mxu: Optional[bool] = None) -> ForwardFn:
    """The one-layer frame through two kernels (counterpart of the
    ``fusedcand`` variant of scripts/profile_frame_combos.py:75-121): the
    fused cell + candidate dots ``cell_cand_step``, whose h' never leaves
    the kernel between the cell and the dots, then ``project_lse`` on h'.
    ``prepare``, ``compute_dtype`` and ``int8_mxu`` as in
    :func:`make_kernel_forward`, which stays the default forward, as the
    reference engine keeps the split frame."""
    if config.num_layers != 1:
        raise ValueError(f"the fused frame takes one layer, not {config.num_layers}")
    base = make_kernel_forward(config, compute_dtype, int8_mxu)
    if int8_mxu is None:
        int8_mxu = config.int8_mxu

    def forward(params, words, state, payload):
        S, B = words.shape
        dec = params["_decode"]
        x = embed(params, words.reshape(S * B))
        c, h = state
        layer = dec["lstm_c"][0]
        c_l, h_top, raw = cell_cand_step(
            x, h[0], c[0], layer["W"], layer["b"], payload["cols"], payload["bias"], B,
            config.forget_bias, compute_dtype=compute_dtype)
        lse = project_lse(h_top, dec["head_c"], config, compute_dtype=compute_dtype,
                          int8_mxu=int8_mxu)  # [S*B, 1]
        logp = raw - lse.reshape(S, B, 1)
        return logp[:, :, :-1], logp[:, :, -1], (c_l[None], h_top[None])

    forward.prepare = base.prepare
    forward.score_hidden = base.score_hidden
    forward.compute_dtype = compute_dtype
    return forward


def pack_lattice_batch(lattices: List[Lattice]) -> Tuple[np.ndarray, np.ndarray]:
    """Bit-pack node tensors of a lattice batch into one int32 array.

    Layout per node: ``word | start<<17 | cand_idx<<23 | mask<<29``.
    """
    words = np.stack([l.node_word for l in lattices]).astype(np.int64)
    starts = np.stack([l.node_start for l in lattices]).astype(np.int64)
    cidx = np.stack([l.node_cand_idx for l in lattices]).astype(np.int64)
    mask = np.stack([l.node_mask for l in lattices]).astype(np.int64)
    if words.max(initial=0) >= (1 << _WORD_BITS):
        raise ValueError("vocab too large to pack")
    if starts.max(initial=0) >= 64 or cidx.max(initial=0) >= 64:
        raise ValueError("start position or lookahead column >= 64")
    packed = words | (starts << _START_SHIFT) | (cidx << _CIDX_SHIFT) | (
        mask << _MASK_SHIFT
    )
    lengths = np.asarray([l.length for l in lattices], np.int32)
    return packed.astype(np.int32), lengths


def _count_chunk(packed: np.ndarray, lengths: np.ndarray, n: int) -> None:
    """The tracer's counters of one packed chunk ``[rows, t_bucket, N]`` whose
    first ``n`` rows are real sentences (the rest bucket padding): kana and
    real nodes against the frame and node slots the search scans."""
    rows, T, N = packed.shape
    profiling.count("decode.chunks", 1)
    profiling.count("decode.sentences", n)
    profiling.count("decode.rows", rows)
    profiling.count("decode.kana", int(lengths[:n].sum()))
    profiling.count("decode.frame_slots", rows * T)
    profiling.count("decode.nodes", np.count_nonzero(packed[:n] & (1 << _MASK_SHIFT)))
    profiling.count("decode.node_slots", rows * T * N)


def _unpack_lattice(packed: torch.Tensor, config: Config):
    """Device-side unpack + lookahead-table reconstruction (one scatter).

    Masked nodes scatter into one extra dummy slot, sliced off afterwards
    (an out-of-range index would be a device-side assert)."""
    S, T_max, _ = packed.shape
    C = config.max_lookahead
    word = packed & ((1 << _WORD_BITS) - 1)
    start = (packed >> _START_SHIFT) & 0x3F
    cidx = (packed >> _CIDX_SHIFT) & 0x3F
    mask = ((packed >> _MASK_SHIFT) & 1) == 1
    dummy = (T_max + 1) * C
    flat_pos = torch.where(mask, start * C + cidx, dummy).reshape(S, -1)
    look_flat = torch.full((S, dummy + 1), -1, dtype=torch.int32, device=packed.device)
    look_flat.scatter_(1, flat_pos.long(), word.reshape(S, -1))
    look_w = look_flat[:, :dummy].reshape(S, T_max + 1, C)
    look_m = look_w >= 0
    return word, start, cidx, mask, look_w.clamp(min=0), look_m


def _at(payload, t: int):
    """Frame ``t`` of a time-major payload (a tensor or a dict of them)."""
    if isinstance(payload, dict):
        return {k: v[t] for k, v in payload.items()}
    return payload[t]


def _decode_scan(params, packed: torch.Tensor, lengths: torch.Tensor,
                 root: Optional[Dict[str, torch.Tensor]] = None,
                 seed: Optional[Dict[str, torch.Tensor]] = None, *,
                 config: Config, forward_fn: ForwardFn, chain: bool = False,
                 seed_m: int = 0, export_rings: bool = False,
                 walk: bool = True) -> Dict[str, torch.Tensor]:
    """Search one chunk on the device.

    With ``walk`` (the default) returns the walked top-K ``paths`` (``[S,
    K, T, 2]``: (end position, node) per step, end to start), their
    ``final_topk`` scores, where each walk stopped (``root_pos``,
    ``root_beam``: position 0, or a seeded row) and the packed result
    ``blob`` (``[S, K*(3 + 2*T)]`` int32: final score bits, root beam, root
    position, paths); without it the raw backpointers ``bp`` (src, path,
    node, each ``[S, T_scan, B]``) for the host to stitch.

    The long-input arguments (``decode_long``):

    - ``root`` (``{"words", "score" [S, B], "c", "h" [L, S*B, H]}``): the
      position-0 beam carried from a previous chunk (single-root chaining)
      in place of ``<eos>`` from a zero state; ``chain`` also returns that
      beam at the last position (``chain``) and walks every beam slot;
    - ``seed`` (``{"score" [S, M, B], "c", "h" [S, M, B, L, H]}``) with
      ``seed_m = M = max_word_len``: multi-root overlap-save, local
      positions 1..M carry the previous chunk's beams, their candidate
      rows scored from the seeds' top hidden states by the forward's
      ``score_hidden`` hook; the frames run from M + 1 and walks stop at a
      seeded row;
    - ``export_rings``: the last M positions' beams (scores without
      ``<eos>``, states in fp32) as ``rings``, the next chunk's seed.
    """
    S, T_max, N = packed.shape
    B, C = config.beam_pad, config.max_lookahead
    L, H = config.num_layers, config.hidden_size
    R = _RING
    if config.max_word_len >= R:
        raise ValueError(f"max_word_len={config.max_word_len} must be < ring size {R}")
    if seed_m and (seed is None or seed_m != config.max_word_len):
        raise ValueError("seed_m needs a seed and must equal config.max_word_len")
    dev = packed.device
    word, start, cidx, mask, look_w, look_m = _unpack_lattice(packed, config)
    word, start, cidx = word.long(), start.long(), cidx.long()
    prepare = getattr(forward_fn, "prepare", None)
    payload = (prepare(params, look_w) if prepare is not None
               else look_w.long().transpose(0, 1))
    cache_dtype = getattr(forward_fn, "compute_dtype", torch.float32)

    def state_to_cache(x):  # [L, S*B, H] -> [S, B, L, H]
        return x.reshape(L, S, B, H).permute(1, 2, 0, 3).to(cache_dtype)

    def cache_to_state(g):  # [S, B, L, H] -> [L, S*B, H]
        return g.permute(2, 0, 1, 3).reshape(L, S * B, H).contiguous()

    score = torch.full((S, R, B), NEG, device=dev)
    cand_cache = torch.zeros((S, R, B, C), device=dev)
    c_cache = torch.zeros((S, R, B, L, H), dtype=cache_dtype, device=dev)
    h_cache = torch.zeros((S, R, B, L, H), dtype=cache_dtype, device=dev)
    last_words = None
    if seed_m == 0:
        # --- position-0 root beam: path 0 alive, fed <eos> from zero state,
        # or the beam carried from the previous chunk ---
        if root is None:
            c0 = h0 = torch.zeros((L, S * B, H), dtype=torch.float32, device=dev)
            words0 = torch.full((S, B), EOS_ID, dtype=torch.long, device=dev)
            score0 = torch.full((S, B), NEG, device=dev)
            score0[:, 0] = 0.0
        else:
            c0, h0, words0, score0 = root["c"], root["h"], root["words"], root["score"]
        cand0, _, (c1, h1) = forward_fn(params, words0, (c0, h0), _at(payload, 0))
        cand0 = torch.where(look_m[:, 0][:, None, :], cand0, NEG)
        cand0 = torch.where(score0[:, :, None] > NEG / 2, cand0, NEG)
        score[:, 0] = score0
        cand_cache[:, 0] = cand0
        c_cache[:, 0] = state_to_cache(c1)
        h_cache[:, 0] = state_to_cache(h1)
        last_words = words0
    else:
        # --- multi-root seeding: local positions 1..M hold the previous
        # chunk's beams at its last M positions; their candidate rows are
        # scored for THIS window's lookahead, so a word may start in the
        # overlap and end past the cut ---
        M = seed_m
        htop = seed["h"][..., L - 1, :].reshape(S * M, B, H)  # [S, M, B, H] flat
        # the payload is time-major: [M, S, ...] -> [S, M, ...] -> [S*M, ...]
        pay = {k: v[1:M + 1].transpose(0, 1).reshape((S * M,) + v.shape[2:]).contiguous()
               for k, v in payload.items()} if isinstance(payload, dict) else \
            payload[1:M + 1].transpose(0, 1).reshape(S * M, -1)
        cand_seed = forward_fn.score_hidden(params, htop, pay).reshape(S, M, B, C)
        cand_seed = torch.where(look_m[:, 1:M + 1][:, :, None, :], cand_seed, NEG)
        cand_seed = torch.where(seed["score"][..., None] > NEG / 2, cand_seed, NEG)
        score[:, 1:M + 1] = seed["score"]
        cand_cache[:, 1:M + 1] = cand_seed
        c_cache[:, 1:M + 1] = seed["c"].to(cache_dtype)
        h_cache[:, 1:M + 1] = seed["h"].to(cache_dtype)
    final = torch.full((S, B), NEG, device=dev)

    lengths = lengths.long()
    beam = torch.arange(B, device=dev)
    beam_live = beam < config.beam_width
    s_idx = torch.arange(S, device=dev)[:, None]
    bp_src, bp_p, bp_n = [], [], []
    for pos in range(seed_m + 1, T_max + 1):
        words_t, starts_t = word[:, pos - 1], start[:, pos - 1]
        mask_t, cidx_t = mask[:, pos - 1], cidx[:, pos - 1]
        ring_t = starts_t & (R - 1)  # [S, N] ring row of each node's start

        # extension scores [S, N, B]: ONE flat gather of the cached logp of
        # each node's word from every path of its start position's beam
        flat_idx = (ring_t[:, :, None] * (B * C) + beam[None, None, :] * C
                    + cidx_t[:, :, None])
        ext_logp = cand_cache.reshape(S, R * B * C).gather(
            1, flat_idx.reshape(S, N * B)).reshape(S, N, B)
        ext = score.gather(1, ring_t[:, :, None].expand(S, N, B)) + ext_logp
        ext = torch.where(mask_t[:, :, None], ext, NEG)

        # stable top-k over (node-major, path-minor); padding slots beyond
        # beam_width stay dead so the beam is exactly the reference's width
        top_scores, top_idx = topk_stable(ext.reshape(S, N * B), B)
        top_scores = torch.where(beam_live, top_scores, NEG)
        sel_n, sel_p = top_idx // B, top_idx % B
        src_pos = starts_t.gather(1, sel_n)  # [S, B]
        new_words = words_t.gather(1, sel_n)

        flat2 = (src_pos & (R - 1)) * B + sel_p  # [S, B] ring row * B + path
        csel = c_cache.reshape(S, R * B, L, H)[s_idx, flat2]
        hsel = h_cache.reshape(S, R * B, L, H)[s_idx, flat2]
        cand_new, eos_new, (c_new, h_new) = forward_fn(
            params, new_words, (cache_to_state(csel), cache_to_state(hsel)),
            _at(payload, pos),
        )
        cand_new = torch.where(look_m[:, pos][:, None, :], cand_new, NEG)
        cand_new = torch.where((top_scores > NEG / 2)[:, :, None], cand_new, NEG)
        # final <eos> rescoring at each sentence's true length
        final = torch.where((lengths == pos)[:, None], top_scores + eos_new, final)

        ring_w = pos & (R - 1)
        score[:, ring_w] = top_scores
        cand_cache[:, ring_w] = cand_new
        c_cache[:, ring_w] = state_to_cache(c_new)
        h_cache[:, ring_w] = state_to_cache(h_new)
        bp_src.append(src_pos)
        bp_p.append(sel_p)
        bp_n.append(sel_n)
        last_words = new_words

    T_scan = T_max - seed_m
    bp_src, bp_p, bp_n = (torch.stack(b, dim=1) for b in (bp_src, bp_p, bp_n))
    out: Dict[str, Any] = {}
    if walk:
        # --- device backtrack of the top-K final beams (chain mode: every
        # beam slot; the host learns which matter from later chunks); a
        # walk stops at a seeded row, whose own chunk's backpointers go on ---
        if chain:
            K, top_vals = B, final
            top_beams = beam[None, :].expand(S, B)
        else:
            K = min(config.n_best_max, B)
            top_vals, top_beams = topk_stable(final, K)  # [S, K]
        pos, bi = lengths[:, None].expand(S, K), top_beams
        steps = []
        for _ in range(T_scan):
            p = (pos - 1 - seed_m).clamp(min=0)
            valid = pos > seed_m

            def gather_bp(bp):  # [S, T_scan, B] -> [S, K]
                return bp.gather(1, p[:, :, None].expand(S, K, B)).gather(
                    2, bi[:, :, None])[..., 0]

            node = gather_bp(bp_n)
            steps.append(torch.where(valid[..., None], torch.stack([pos, node], dim=-1), 0))
            pos, bi = (torch.where(valid, gather_bp(bp_src), pos),
                       torch.where(valid, gather_bp(bp_p), bi))
        paths = torch.stack(steps, dim=2).int()  # [S, K, T_scan, 2], end-to-start
        out.update({
            "final_topk": top_vals, "paths": paths, "root_pos": pos, "root_beam": bi,
            "blob": torch.cat([
                top_vals.contiguous().view(torch.int32)[:, :, None],
                bi.int()[:, :, None],
                pos.int()[:, :, None],
                paths.reshape(S, K, 2 * T_scan),
            ], dim=2).reshape(S, K * (3 + 2 * T_scan)),
        })
    else:
        out["bp"] = tuple(b.int() for b in (bp_src, bp_p, bp_n))
    if export_rings:
        # the last M positions' beams, resident in the ring (M < R: no
        # two of them share a row)
        M = config.max_word_len
        rows = [(T_max - M + 1 + i) & (R - 1) for i in range(M)]
        out["rings"] = {"score": score[:, rows],
                        "c": c_cache[:, rows].float(), "h": h_cache[:, rows].float()}
    if chain:
        ring_T = T_max & (R - 1)
        out["chain"] = {"words": last_words, "score": score[:, ring_T],
                        "c": cache_to_state(c_cache[:, ring_T]).float(),
                        "h": cache_to_state(h_cache[:, ring_T]).float()}
    return out


class BeamDecoder:
    """Host wrapper: lattice build + pack -> one device search -> surfaces.

    ``device`` defaults to the card; asking for ``"cuda"`` without a GPU
    raises.  Without ``forward_fn``,
    ``precision="default"`` selects the kernel forward in bf16 (int8 heads
    per ``config.int8_mxu``) and ``"highest"`` the fp32 full-softmax parity
    forward.  A forward with a ``prepare`` hook (e.g.
    ``make_kernel_forward(config, torch.float32)``) gets the decode-side
    head prep in its ``compute_dtype``.  A sharded forward runs on its
    mesh's device (a ``device`` naming another raises) and keeps what its
    ``place_params`` returns of ``params`` (the full tree, or one already
    sharded): this rank's head columns.
    """

    def __init__(
        self,
        params,
        lexicon: Lexicon,
        vocab: Vocab,
        config: Config,
        forward_fn: Optional[ForwardFn] = None,
        precision: str = "highest",
        use_native: Optional[bool] = None,
        *,
        device="cuda",
    ):
        self._mesh = getattr(forward_fn, "mesh", None)
        if self._mesh is not None:
            from jlm_tpu_torch.parallel.mesh import mesh_device

            device = mesh_device(self._mesh, device)
        self.device = resolve_device(device)
        self.params = params_to_torch(params, self.device)
        self.lexicon = lexicon
        self.vocab = vocab
        self.config = config
        self._native = None
        if use_native is not False:
            from jlm_tpu_torch import native as _native_mod

            if _native_mod.available():
                self._native = _native_mod.NativeLatticeBuilder(lexicon, config)
            elif use_native is True:
                raise RuntimeError("native lattice builder requested but unavailable")
        if forward_fn is not None:
            self._fwd = forward_fn
        elif precision == "default":
            self._fwd = make_kernel_forward(config, compute_dtype=torch.bfloat16)
        elif precision == "highest":
            self._fwd = make_full_softmax_forward(config)
        else:
            raise ValueError(f"precision must be 'default' or 'highest', not {precision!r}")
        # sharded forwards: S a multiple of data x vocab; this rank's params
        self._min_batch = int(getattr(self._fwd, "min_batch", 1))
        place = getattr(self._fwd, "place_params", None)
        if place is not None:
            self.params = place(self.params)
        if getattr(self._fwd, "prepare", None) is not None and "_decode" not in self.params:
            self.params["_decode"] = build_decode_head(
                self.params, config, self._fwd.compute_dtype)

    @staticmethod
    def _bucket(n: int) -> int:
        """Pad batch sizes to power-of-two buckets (bounded shape count)."""
        b = 1
        while b < n:
            b *= 2
        return b

    def _t_bucket(self, n: int) -> int:
        """Pad frame counts to ``config.t_bucket_multiple`` (min 4)."""
        m = max(1, self.config.t_bucket_multiple)
        return max(4, -(-n // m) * m)

    def _pack(self, kanas: List[str]):
        """Build lattices (native if available), time-bucket, and bucket-pad
        (to a multiple of ``min_batch``) with copies of the last row, so a
        node cut from the last lattice is reported once."""
        with profiling.span("decode.pack"):
            mb = self._min_batch
            pad = -(-self._bucket(len(kanas)) // mb) * mb - len(kanas)
            if self._native is not None:
                packed, lengths = self._native.pack_batch(list(kanas))
            else:
                lattices = [build_lattice(k, self.lexicon, self.vocab, self.config)
                            for k in kanas]
                packed, lengths = pack_lattice_batch(lattices)
            t_bucket = min(self._t_bucket(int(lengths.max())), self.config.max_kana_len)
            packed = packed[:, :t_bucket]
            if pad:
                packed = np.concatenate([packed, np.repeat(packed[-1:], pad, axis=0)])
                lengths = np.concatenate([lengths, np.repeat(lengths[-1:], pad)])
            if profiling.enabled():
                _count_chunk(packed, lengths, len(kanas))
            return packed, lengths

    def decode_batch_async(self, kanas: List[str]):
        """Enqueue one chunk's search; returns (packed, device outputs)
        without waiting for the device.  Inputs longer than
        ``config.max_kana_len`` go through ``decode`` / ``decode_batch``
        (``decode_long``), not here."""
        too_long = [k for k in kanas if len(k) > self.config.max_kana_len]
        if too_long:
            raise ValueError(
                f"{len(too_long)} input(s) longer than max_kana_len="
                f"{self.config.max_kana_len}: convert them with decode or decode_batch, "
                "which chunk them (decode_long)")
        packed, lengths = self._pack(kanas)
        with profiling.span("decode.enqueue"):
            out = _decode_scan(self.params, upload(self._own(packed), self.device),
                               upload(self._own(lengths), self.device),
                               config=self.config, forward_fn=self._fwd)
        return packed, out

    def _own(self, x: np.ndarray) -> np.ndarray:
        """This rank's sentence rows of a chunk (all of them without a
        mesh): rank r scans rows ``[r*S_l, (r+1)*S_l)``, the reference's
        row sharding over (data, vocab)."""
        if self._mesh is None:
            return x
        S_l = x.shape[0] // self._mesh.world
        return x[self._mesh.rank * S_l:(self._mesh.rank + 1) * S_l]

    def _first_rank(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """Rank 0's copies of a long input's results, on every rank (one
        broadcast each): each rank scanned the same sentence, but the
        head's rows may round in the last bit differently per row."""
        if self._mesh is None:
            return tensors
        from jlm_tpu_torch.parallel import comm

        return [comm.broadcast(t.contiguous()) for t in tensors]

    def _blob(self, blob: torch.Tensor) -> np.ndarray:
        """A chunk's result blob on the host; under a mesh every rank's
        rows gathered, in row order."""
        if self._mesh is not None:
            from jlm_tpu_torch.parallel import comm

            blob = comm.all_gather(blob.contiguous()).reshape(-1, blob.shape[1])
        return blob.cpu().numpy()

    def materialize(self, kanas: List[str], packed: np.ndarray, out,
                    n_best: int = 1) -> List[List[DecodeResult]]:
        """Fetch one chunk's result blob (the only device->host copy) and
        build surfaces."""
        S, K, T_scan = len(packed), out["paths"].shape[1], out["paths"].shape[2]
        with profiling.span("decode.fetch"):
            blob = self._blob(out["blob"]).reshape(S, K, 3 + 2 * T_scan)
        with profiling.span("decode.surfaces"):
            finals = blob[:, :, 0].view(np.float32)
            paths = blob[:, :, 3:].reshape(S, K, T_scan, 2)
            return [[self._result(self._segments(kana, packed[i], paths[i, k]), finals[i, k])
                     for k in range(min(n_best, K)) if finals[i, k] > -1e29]
                    for i, kana in enumerate(kanas)]

    @staticmethod
    def _result(segs: List[Tuple[str, int]], score) -> DecodeResult:
        return DecodeResult(surface="".join(d for d, _ in segs), score=float(score),
                            segments=segs)

    def _segments(self, kana: str, packed_row: np.ndarray, path) -> List[Tuple[str, int]]:
        """One walked path ((end position, node) pairs, end to start, a
        position <= 0 ending it) as segments in reading order."""
        segs: List[Tuple[str, int]] = []
        for pos, n in path:
            if pos <= 0:
                break
            node = int(packed_row[int(pos) - 1, int(n)])
            word = node & ((1 << _WORD_BITS) - 1)
            start = (node >> _START_SHIFT) & 0x3F
            segs.append((kana[start:int(pos)] if word == UNK_ID else self.vocab.display(word),
                         word))
        segs.reverse()
        return segs

    def decode_batch(self, kanas: List[str], n_best: int = 1) -> List[List[DecodeResult]]:
        """Inputs up to ``max_kana_len`` in one batched search; longer ones
        each through ``decode_long``; results in the input order."""
        T_c = self.config.max_kana_len
        short = [k for k in kanas if len(k) <= T_c]
        if len(short) == len(kanas):
            packed, out = self.decode_batch_async(kanas)
            return self.materialize(kanas, packed, out, n_best)
        done = iter(self.materialize(short, *self.decode_batch_async(short), n_best)
                    if short else [])
        return [self.decode_long(k, n_best) if len(k) > T_c else next(done) for k in kanas]

    def decode_long(self, kana: str, n_best: int = 1) -> List[DecodeResult]:
        """Convert an input longer than ``max_kana_len`` in chunks.

        Multi-root overlap-save: consecutive chunks overlap by
        ``max_word_len`` = M positions; each chunk exports its beams at its
        last M positions (scores and states, from the ring caches) and the
        next seeds its ring with them, admitting nodes that start in the
        overlap, so words span the cuts and the search equals the unchunked
        one.  The built-in forwards carry the ``score_hidden`` hook this
        needs; a forward without it falls back to single-root chaining (a
        word boundary forced at every ``max_kana_len``-th position).  The
        seeds stay on the device between chunks.  Under a mesh every rank
        scans the same one-sentence windows (``min_batch`` copies of the
        sentence, one a rank), and every rank returns rank 0's result."""
        if getattr(self._fwd, "score_hidden", None) is not None:
            return self._decode_long_multiroot(kana, n_best)
        return self._decode_long_chain(kana, n_best)

    def _pack_window(self, window: str, mask_upto: int) -> np.ndarray:
        """One chunk window's packed lattice ``[1, len(window), N]`` (no time
        bucket), its frames up to ``mask_upto`` (the overlap the previous
        chunk searched) cleared, so their nodes are dead."""
        if self._native is not None:
            packed, _ = self._native.pack_batch([window])
        else:
            packed, _ = pack_lattice_batch(
                [build_lattice(window, self.lexicon, self.vocab, self.config)])
        packed = packed[:, :len(window)].copy()
        packed[:, :mask_upto] = 0
        return packed

    @staticmethod
    def _walk_host(bp, entry_pos: int, entry_slot: int, seed_m: int):
        """Backtrack one chunk on the host from (position, slot) down to a
        seeded row or the root.  ``bp`` = (src, path, node) ``[T_scan, B]``;
        returns the (position, node) steps end to start and where the walk
        stopped."""
        src, selp, seln = bp
        pos, b = entry_pos, entry_slot
        steps = []
        while pos > seed_m:
            row = pos - 1 - seed_m
            steps.append((pos, int(seln[row, b])))
            pos, b = int(src[row, b]), int(selp[row, b])
        return steps, pos, b

    def _decode_long_multiroot(self, kana: str, n_best: int = 1) -> List[DecodeResult]:
        cfg = self.config
        M, T_c = cfg.max_word_len, cfg.max_kana_len
        # chunk k searches global positions cut_{k-1} + 1 .. cut_k
        cuts = [T_c]
        while cuts[-1] < len(kana):
            cuts.append(min(cuts[-1] + T_c - M, len(kana)))
        kind = {"first": dict(export_rings=True, walk=False),
                "mid": dict(seed_m=M, export_rings=True, walk=False),
                "last": dict(seed_m=M)}
        chunks, seed = [], None  # (window, packed, out, seed_m)
        for k, cut in enumerate(cuts):
            seed_m = 0 if k == 0 else M
            window = kana[cuts[k - 1] - M if k else 0:cut]
            packed = self._pack_window(window, seed_m)
            lengths = np.asarray([len(window)], np.int32)
            variant = "first" if k == 0 else "last" if k == len(cuts) - 1 else "mid"
            out = _decode_scan(self.params, upload(packed, self.device),
                               upload(lengths, self.device), seed=seed, config=cfg,
                               forward_fn=self._fwd, **kind[variant])
            seed = out.get("rings")  # stays on the device
            chunks.append((window, packed, out, seed_m))

        # one fetch: the last chunk's blob and every earlier chunk's
        # backpointers (row 0 of each: S = 1)
        window_l, packed_l, out_l, _ = chunks[-1]
        K, T_scan = out_l["paths"].shape[1:3]
        host = fetch(self._first_rank([out_l["blob"]] + [b for _, _, out, _ in chunks[:-1]
                                                        for b in out["bp"]]))
        blob = host[0].reshape(K, 3 + 2 * T_scan)
        finals, root_beam, root_pos = blob[:, 0].view(np.float32), blob[:, 1], blob[:, 2]
        paths = blob[:, 3:].reshape(K, T_scan, 2)
        bps = [tuple(b[0] for b in host[1 + 3 * k:4 + 3 * k]) for k in range(len(chunks) - 1)]

        results = []
        for j in range(min(n_best, K)):
            if finals[j] <= -1e29:
                continue
            segs = self._segments(window_l, packed_l[0], paths[j])
            pos, slot = int(root_pos[j]), int(root_beam[j])
            for k in range(len(chunks) - 2, -1, -1):
                window_k, packed_k, _, seed_m_k = chunks[k]
                # a seeded row pos of chunk k + 1 is chunk k's local
                # position len(window_k) - M + pos
                steps, pos, slot = self._walk_host(bps[k], len(window_k) - M + pos, slot,
                                                   seed_m_k)
                segs = self._segments(window_k, packed_k[0], steps) + segs
            results.append(self._result(segs, finals[j]))
        return results

    def _decode_long_chain(self, kana: str, n_best: int = 1) -> List[DecodeResult]:
        """Single-root chaining, for a forward without ``score_hidden``:
        each ``max_kana_len`` part's beam at its last position roots the
        next part (a word boundary forced at every cut)."""
        T_c = self.config.max_kana_len
        parts = [kana[i:i + T_c] for i in range(0, len(kana), T_c)]
        outs, root = [], None
        for i, part in enumerate(parts):
            last = i == len(parts) - 1
            packed, lengths = self._pack([part])
            packed, lengths = self._own(packed), self._own(lengths)
            out = _decode_scan(self.params, upload(packed, self.device),
                               upload(lengths, self.device), root, config=self.config,
                               forward_fn=self._fwd, chain=not last)
            root = out.get("chain")  # stays on the device
            outs.append((part, packed, out))
        blobs = [blob.reshape(out["paths"].shape[1], -1) for (_, _, out), blob in
                 zip(outs, fetch(self._first_rank([out["blob"] for _, _, out in outs])))]
        walked = [(part, packed, blob[:, 3:].reshape(len(blob), -1, 2), blob[:, 1])
                  for (part, packed, _), blob in zip(outs, blobs)]
        finals = blobs[-1][:, 0].view(np.float32)
        results = []
        for k in range(min(n_best, len(finals))):
            if finals[k] <= -1e29:
                continue
            part, packed, paths, roots = walked[-1]
            segs = self._segments(part, packed[0], paths[k])
            rb = int(roots[k])
            for part, packed, paths, roots in reversed(walked[:-1]):
                segs = self._segments(part, packed[0], paths[rb]) + segs
                rb = int(roots[rb])
            results.append(self._result(segs, finals[k]))
        return results

    def decode_stream(self, kanas: List[str], chunk_size: int = 128, n_best: int = 1,
                      sort_by_length: bool = True) -> List[List[DecodeResult]]:
        """Pipelined conversion of a sentence stream: every chunk is
        enqueued before any result is fetched, so the device works on chunk
        k while the host builds chunk k+1.  ``sort_by_length`` groups
        similar lengths into a chunk (each chunk scans its longest length);
        results come back in the original order."""
        if sort_by_length and len(kanas) > 1:
            order = sorted(range(len(kanas)), key=lambda i: len(kanas[i]))
        else:
            order = list(range(len(kanas)))
        with profiling.span("decode.job"):
            inflight = []
            for i in range(0, len(order), chunk_size):
                idxs = order[i:i + chunk_size]
                chunk = [kanas[j] for j in idxs]
                inflight.append((chunk, idxs, *self.decode_batch_async(chunk)))
            results: List[Optional[List[DecodeResult]]] = [None] * len(kanas)
            for chunk, idxs, packed, out in inflight:
                for i, r in zip(idxs, self.materialize(chunk, packed, out, n_best)):
                    results[i] = r
        return results

    def decode(self, kana: str, n_best: int = 1) -> List[DecodeResult]:
        if len(kana) > self.config.max_kana_len:
            return self.decode_long(kana, n_best)
        return self.decode_batch([kana], n_best)[0]
