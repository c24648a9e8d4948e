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
``BeamDecoder``'s ``precision``: ``make_full_softmax_forward`` is the fp32
parity forward, ``make_kernel_forward`` the speed forward through the
three hand-written kernels.  A forward may carry ``prepare(params, look_w
[S, T1, C]) -> payload``, run once per chunk; every payload leaf is
TIME-MAJOR (``[T1, S, ...]``) so a frame's slice is contiguous.

Not ported yet (ROADMAP.md): ``decode_long`` and its chain/seed/export
variants, the D-softmax head, sharded forwards.
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
from jlm_tpu_torch.models.lstm import DSOFTMAX_TODO, _w, embed, step_logp
from jlm_tpu_torch.models.params import params_to_torch, resolve_device
from jlm_tpu_torch.ops.cand_dot import cand_dot
from jlm_tpu_torch.ops.lstm_cell import lstm_cell_step
from jlm_tpu_torch.ops.project import project_lse

ForwardFn = Callable[..., Tuple[torch.Tensor, torch.Tensor, Any]]

# bit-packing layout for the lattice upload (see pack_lattice_batch); the
# same layout as jlm_tpu.decoder.engine, pinned bit-equal by the tests
_WORD_BITS = 17  # vocab ids < 131072
_START_SHIFT = 17  # start position: 6 bits (T_max <= 63)
_CIDX_SHIFT = 23  # lookahead column: 6 bits (C_max <= 64)
_MASK_SHIFT = 29

_RING = 8  # ring rows of the per-position caches (> max_word_len)
NEG = -1e30  # dead score; liveness is tested as > NEG / 2

LONG_TODO = "decode_long not ported yet (ROADMAP.md queue 1, item 6)"


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
    """The fp32 parity forward (plain torch, TF32 off)."""
    _set_fp32_matmuls()

    def forward(params, words, state, cand_words):
        return full_softmax_forward(params, config, words, state, cand_words)

    forward.compute_dtype = torch.float32
    return forward


def build_decode_head(params, config: Config, compute_dtype=torch.float32):
    """One-time decode-side head prep, stashed under ``params["_decode"]``:

    - ``head_T [V, H]``: every word's output column as a row, dequantized,
      in ``compute_dtype`` — the candidate rows ``prepare`` gathers;
    - ``bias [V]`` fp32;
    - ``head_c``: the projection head for ``project_lse`` — int8 dicts pass
      through, fp weights are cast to ``compute_dtype`` — plus ``"WT"``,
      the ``[V, H]`` transposed weight the kernel reads (the int8 ``q``
      transposed, or ``head_T`` itself for fp heads);
    - ``lstm_c``: per layer the dequantized cell weight in ``compute_dtype``
      and its fp32 bias.
    """
    head = params["head"]
    if "blocks" in head:
        raise NotImplementedError(DSOFTMAX_TODO)
    lstm_c = [
        {"W": _w(layer["W"]).to(compute_dtype).contiguous(),
         "b": layer["b"].float().contiguous()}
        for layer in params["lstm"]
    ]
    W = head["W"]
    head_T = _w(W).t().to(compute_dtype).contiguous()
    if isinstance(W, dict):
        head_c = {"W": W, "b": head["b"], "WT": W["q"].t().contiguous()}
    else:
        head_c = {"W": W.to(compute_dtype), "b": head["b"], "WT": head_T}
    return {"head_T": head_T, "bias": head["b"].float(), "head_c": head_c,
            "lstm_c": lstm_c}


def make_kernel_forward(config: Config, compute_dtype=torch.bfloat16) -> ForwardFn:
    """Batched forward through the three kernels (counterpart of
    ``make_pallas_forward``): fused cell per layer, the vocab-tiled
    normalizer ``project_lse`` (int8 heads per ``config.int8_mxu``), and
    ``cand_dot`` over candidate head rows pre-gathered once per chunk by
    ``prepare`` (EOS as the last column)."""

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
                          int8_mxu=config.int8_mxu)  # [S*B, 1]
        raw = cand_dot(x.reshape(S, B, -1), payload["cols"], payload["bias"])
        logp = raw - lse.reshape(S, B, 1)
        return logp[:, :, :-1], logp[:, :, -1], (torch.stack(new_c), torch.stack(new_h))

    forward.prepare = prepare
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


def _decode_scan(params, packed: torch.Tensor, lengths: torch.Tensor, *,
                 config: Config, forward_fn: ForwardFn) -> Dict[str, torch.Tensor]:
    """Search one chunk on the device; returns the walked top-K ``paths``
    (``[S, K, T, 2]``: (end position, node) per step, end to start) and the
    packed result ``blob`` (``[S, K*(3 + 2*T)]`` int32: final score bits,
    root beam, root position, paths)."""
    S, T_max, N = packed.shape
    B, C = config.beam_pad, config.max_lookahead
    L, H = config.num_layers, config.hidden_size
    R = _RING
    if config.max_word_len >= R:
        raise ValueError(f"max_word_len={config.max_word_len} must be < ring size {R}")
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

    # --- position-0 root beam: path 0 alive, fed <eos> from zero state ---
    zeros = torch.zeros((L, S * B, H), dtype=torch.float32, device=dev)
    words0 = torch.full((S, B), EOS_ID, dtype=torch.long, device=dev)
    score0 = torch.full((S, B), NEG, device=dev)
    score0[:, 0] = 0.0
    cand0, _, (c1, h1) = forward_fn(params, words0, (zeros, zeros), _at(payload, 0))
    cand0 = torch.where(look_m[:, 0][:, None, :], cand0, NEG)
    cand0 = torch.where(score0[:, :, None] > NEG / 2, cand0, NEG)

    score = torch.full((S, R, B), NEG, device=dev)
    score[:, 0] = score0
    cand_cache = torch.zeros((S, R, B, C), device=dev)
    cand_cache[:, 0] = cand0
    c_cache = torch.zeros((S, R, B, L, H), dtype=cache_dtype, device=dev)
    h_cache = torch.zeros((S, R, B, L, H), dtype=cache_dtype, device=dev)
    c_cache[:, 0] = state_to_cache(c1)
    h_cache[:, 0] = state_to_cache(h1)
    final = torch.full((S, B), NEG, device=dev)

    lengths = lengths.long()
    beam = torch.arange(B, device=dev)
    beam_live = beam < config.beam_width
    s_idx = torch.arange(S, device=dev)[:, None]
    bp_src, bp_p, bp_n = [], [], []
    for pos in range(1, T_max + 1):
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

    # --- device backtrack of the top-K final beams ---
    bp_src, bp_p, bp_n = (torch.stack(b, dim=1) for b in (bp_src, bp_p, bp_n))
    K = min(config.n_best_max, B)
    top_vals, top_beams = topk_stable(final, K)  # [S, K]
    pos, bi = lengths[:, None].expand(S, K), top_beams
    steps = []
    for _ in range(T_max):
        p = (pos - 1).clamp(min=0)
        valid = pos > 0

        def gather_bp(bp):  # [S, T, B] -> [S, K]
            return bp.gather(1, p[:, :, None].expand(S, K, B)).gather(2, bi[:, :, None])[..., 0]

        node = gather_bp(bp_n)
        steps.append(torch.where(valid[..., None], torch.stack([pos, node], dim=-1), 0))
        pos, bi = (torch.where(valid, gather_bp(bp_src), pos),
                   torch.where(valid, gather_bp(bp_p), bi))
    paths = torch.stack(steps, dim=2).int()  # [S, K, T, 2], end-to-start
    blob = torch.cat([
        top_vals.contiguous().view(torch.int32)[:, :, None],
        bi.int()[:, :, None],
        pos.int()[:, :, None],
        paths.reshape(S, K, 2 * T_max),
    ], dim=2).reshape(S, K * (3 + 2 * T_max))
    return {"paths": paths, "blob": blob}


class BeamDecoder:
    """Host wrapper: lattice build + pack -> one device search -> surfaces.

    ``device`` is required; asking for ``"cuda"`` without a GPU raises.
    ``precision="default"`` selects the kernel forward in bf16 (int8 heads
    use the native int8 x int8 product); ``"highest"`` the fp32
    full-softmax parity forward.
    """

    def __init__(
        self,
        params,
        lexicon: Lexicon,
        vocab: Vocab,
        config: Config,
        precision: str = "highest",
        use_native: Optional[bool] = None,
        *,
        device,
    ):
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
        if precision == "default":
            self._fwd = make_kernel_forward(config, compute_dtype=torch.bfloat16)
            self.params["_decode"] = build_decode_head(
                self.params, config, self._fwd.compute_dtype)
        elif precision == "highest":
            self._fwd = make_full_softmax_forward(config)
        else:
            raise ValueError(f"precision must be 'default' or 'highest', not {precision!r}")

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
        """Bucket-pad, build lattices (native if available), time-bucket."""
        pad = self._bucket(len(kanas)) - len(kanas)
        kanas_padded = list(kanas) + [kanas[-1]] * pad
        if self._native is not None:
            packed, lengths = self._native.pack_batch(kanas_padded)
        else:
            lattices = [build_lattice(k, self.lexicon, self.vocab, self.config)
                        for k in kanas_padded]
            packed, lengths = pack_lattice_batch(lattices)
        t_bucket = min(self._t_bucket(int(lengths.max())), self.config.max_kana_len)
        return packed[:, :t_bucket], lengths

    def _upload(self, x: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(x))
        if self.device.type == "cuda":  # pinned, so the copy does not block
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def decode_batch_async(self, kanas: List[str]):
        """Enqueue one chunk's search; returns (packed, device outputs)
        without waiting for the device."""
        if any(len(k) > self.config.max_kana_len for k in kanas):
            raise NotImplementedError(LONG_TODO)
        packed, lengths = self._pack(kanas)
        out = _decode_scan(self.params, self._upload(packed), self._upload(lengths),
                           config=self.config, forward_fn=self._fwd)
        return packed, out

    def materialize(self, kanas: List[str], packed: np.ndarray, out,
                    n_best: int = 1) -> List[List[DecodeResult]]:
        """Fetch one chunk's result blob (the only device->host copy) and
        build surfaces."""
        S, K, T_scan, _ = out["paths"].shape
        blob = out["blob"].cpu().numpy().reshape(S, K, 3 + 2 * T_scan)
        finals = blob[:, :, 0].view(np.float32)
        paths = blob[:, :, 3:].reshape(S, K, T_scan, 2)
        n = len(kanas)
        pos = paths[:n, :, :, 0]
        nodes = paths[:n, :, :, 1]
        node_vals = packed[np.arange(n)[:, None, None], np.maximum(pos - 1, 0), nodes]
        words = node_vals & ((1 << _WORD_BITS) - 1)
        starts = (node_vals >> _START_SHIFT) & 0x3F
        valid = pos > 0
        display = self.vocab.display
        results: List[List[DecodeResult]] = []
        for i in range(n):
            res_i: List[DecodeResult] = []
            for k in range(min(n_best, K)):
                if finals[i, k] <= -1e29:
                    continue
                segs: List[Tuple[str, int]] = []
                for t in range(T_scan):
                    if not valid[i, k, t]:
                        break
                    w = int(words[i, k, t])
                    segs.append((
                        kanas[i][starts[i, k, t]:pos[i, k, t]] if w == UNK_ID else display(w),
                        w,
                    ))
                segs.reverse()
                res_i.append(DecodeResult(
                    surface="".join(d for d, _ in segs),
                    score=float(finals[i, k]),
                    segments=segs,
                ))
            results.append(res_i)
        return results

    def decode_batch(self, kanas: List[str], n_best: int = 1) -> List[List[DecodeResult]]:
        packed, out = self.decode_batch_async(kanas)
        return self.materialize(kanas, packed, out, n_best)

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
        return self.decode_batch([kana], n_best)[0]
