"""Incremental per-keystroke decoding (BASELINE config 4).

Counterpart of :mod:`jlm_tpu.decoder.incremental`.  After keystroke
``T+1`` only the new frame is processed: beams ``0..T`` and their cached
LSTM states are reused, so a keystroke costs one LM forward over the beam
rows instead of decoding the lattice again.

Every position caches ``(score, lse, eos, c, h, h_top)`` per beam slot; a
keystroke scores its frame's nodes lazily with
:func:`jlm_tpu_torch.models.lstm.node_logits` (the needed output columns
only) — ``logp(w | path) = logit_w(h) - lse`` — which is exactly the batch
engine's number.  ``pop()`` (backspace) is host bookkeeping: positions past
the cursor are overwritten by later keystrokes.

The normalizer of each step, in kernel mode, is ``project_lse`` on the head
that ``build_decode_head`` prepared once (each block with its ``"WT"``), so
a keystroke launches the head kernel once per head block at ``beam_pad``
rows and never forms ``[rows, V]`` logits; ``<eos>`` is priced as one
candidate column.  The parity mode forms the fp32 logits row.

One packed int32 tensor per keystroke travels to the host.  With
speculation, the payload of the call dispatched at keystroke ``k`` is
copied ``non_blocking`` into pinned memory behind a CUDA event, so the
copy overlaps the user's think time and is waited for at keystroke
``k+1``.
"""

from __future__ import annotations

import functools
import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from jlm_tpu_torch.config import Config, EOS_ID
from jlm_tpu_torch.data.corpus import Vocab
from jlm_tpu_torch.data.lexicon import Lexicon
from jlm_tpu_torch.decoder.engine import (
    NEG, _set_fp32_matmuls, build_decode_head, lstm_only, topk_stable, upload)
from jlm_tpu_torch.decoder.lattice import Node, handle_node_overflow
from jlm_tpu_torch.models.lstm import (
    candidate_logits, embed, head_logits, initial_state, lstm_step, node_logits)
from jlm_tpu_torch.models.params import params_to_torch, resolve_device
from jlm_tpu_torch.oracle.decoder import DecodeResult
from jlm_tpu_torch.ops.project import project_lse

Caches = Tuple[torch.Tensor, ...]  # score, lse, eos [T1, B]; c, h [T1, L, B, H]; htop [T1, B, H]


def kernel_head(config: Config, precision: str) -> Dict[str, Any]:
    """``project_lse``'s mode for a decoder's ``precision``: speed mode
    computes in bf16 with the int8 product per ``config.int8_mxu``; the
    parity mode (``"highest"``) in exact fp32, int8 weights dequantized."""
    if precision == "default":
        return {"compute_dtype": torch.bfloat16, "int8_mxu": config.int8_mxu}
    if precision == "highest":
        return {"compute_dtype": torch.float32, "int8_mxu": False}
    raise ValueError(f"precision must be 'default' or 'highest', not {precision!r}")


def prepare_params(params, config: Config, precision: str, use_kernel: Optional[bool],
                   device: torch.device):
    """Weights on ``device`` and the step's kernel mode (``None``: the plain
    logits row).  ``use_kernel=None`` is on for the card in speed mode; the
    kernel head is prepared once here, never per keystroke."""
    params = params_to_torch(params, device)
    kernel = kernel_head(config, precision)  # validates precision
    if precision == "highest":
        _set_fp32_matmuls()
    if use_kernel is None:
        use_kernel = device.type == "cuda" and precision == "default"
    if not use_kernel:
        return params, None
    params["_decode"] = build_decode_head(params, config, kernel["compute_dtype"])
    return params, kernel


def _forward_with_lse(params, config: Config, words: torch.Tensor, state, kernel=None):
    """One LM step: ``(state', h_top, lse, eos_logp)``.

    ``kernel=None`` forms the full fp32 logits row and reduces it
    (max-subtracted).  A ``kernel_head`` dict instead runs the normalizer
    through ``project_lse`` on ``params["_decode"]["head_c"]`` and prices
    ``<eos>`` as one candidate column."""
    h_top, state = lstm_step(params, config, embed(params, words), state)
    if kernel is not None:
        lse = project_lse(h_top, params["_decode"]["head_c"], config, **kernel)[:, 0]
        eos_id = torch.full((1,), EOS_ID, dtype=torch.long, device=h_top.device)
        eos_logit = candidate_logits(params, config, h_top, eos_id)[:, 0].float()
        return state, h_top, lse, eos_logit - lse
    logits = head_logits(params, config, h_top).float()
    m = logits.amax(dim=-1)
    lse = m + torch.log(torch.exp(logits - m[:, None]).sum(dim=-1))
    return state, h_top, lse, logits[:, EOS_ID] - lse


def _root_init(params, config: Config, device, kernel=None):
    """Position 0 of a session: ``<eos>`` fed from the zero state to every
    beam slot; ``(c, h [L, B, H], h_top, lse, eos)``."""
    B = config.beam_pad
    words = torch.full((B,), EOS_ID, dtype=torch.long, device=device)
    (c, h), h_top, lse, eos = _forward_with_lse(
        params, config, words, initial_state(config, B, device), kernel)
    return c, h, h_top, lse, eos


def _frame_rows(params, caches: Caches, node_word, node_start, node_mask, pos,
                probe_pos, probe_wid, probe_mask, *, config: Config, kernel=None, sid=None):
    """G frames' beam extensions without cache writes: ``node_* [G, N]``,
    ``probe_* [G, Q]``, each frame ending at ``pos`` (an int, or ``[G, 1]``).
    ``sid=None`` reads one session's caches (``Caches``); a ``[G]`` tensor
    reads frame g from session ``sid[g]`` of caches with a leading session
    axis (the server's).  Returns the new cache rows ``(score, lse, eos
    [G, B], c, h [G, L, B, H], h_top [G, B, H])`` and the packed host
    payload ``[G, 4B + Q]`` int32 (source position, source path and node
    of each slot, the finals' and the probe scores' bits).  One LM forward
    runs over all ``G * B`` rows.

    Each probe is a (start position, continuation word) pair scored as the
    best beam extension of that word against the caches as if this frame
    were committed (probes at ``pos`` read the fresh rows): the LM's
    next-kana predictor rides the same payload."""
    score_c, lse_c, _, c_c, h_c, htop_c = caches
    B, L, H = config.beam_pad, config.num_layers, config.hidden_size
    G, N = node_word.shape
    dev = node_word.device
    nw, ns = node_word.long(), node_start.long()
    se = () if sid is None else (sid.long()[:, None],)  # the session of each frame

    logits = node_logits(params, config, htop_c[se + (ns,)], nw)  # [G, N, B]
    ext = score_c[se + (ns,)] + logits - lse_c[se + (ns,)]
    ext = torch.where(node_mask[:, :, None], ext, NEG)
    top_scores, top_idx = topk_stable(ext.reshape(G, N * B), B)
    top_scores = torch.where(torch.arange(B, device=dev) < config.beam_width, top_scores, NEG)
    sel_n, sel_p = top_idx // B, top_idx % B
    src_pos, new_words = ns.gather(1, sel_n), nw.gather(1, sel_n)

    def state_of(cache):  # [.., T1, L, B, H] at (src_pos, sel_p) -> [L, G*B, H]
        return cache[se + (src_pos, slice(None), sel_p)].permute(2, 0, 1, 3).reshape(L, G * B, H)

    (c2, h2), h_top, lse, eos = _forward_with_lse(
        params, config, new_words.reshape(G * B), (state_of(c_c), state_of(h_c)), kernel)
    lse, eos, h_top = lse.reshape(G, B), eos.reshape(G, B), h_top.reshape(G, B, H)
    finals = top_scores + eos

    Q = probe_wid.shape[1]
    if Q:
        pp = probe_pos.long()
        at_new = (pp == pos)[:, :, None]  # [G, Q, 1]
        sc = torch.where(at_new, top_scores[:, None, :], score_c[se + (pp,)])
        ls = torch.where(at_new, lse[:, None, :], lse_c[se + (pp,)])
        ht = torch.where(at_new[..., None], h_top[:, None], htop_c[se + (pp,)])  # [G, Q, B, H]
        p_best = (sc + node_logits(params, config, ht, probe_wid.long()) - ls).amax(dim=2)
        p_best = torch.where(probe_mask, p_best, NEG)
    else:
        p_best = torch.zeros((G, 0), dtype=torch.float32, device=dev)

    packed = torch.cat([src_pos.int(), sel_p.int(), sel_n.int(),
                        finals.view(torch.int32), p_best.view(torch.int32)], dim=1)

    def per_frame(x):  # [L, G*B, H] -> [G, L, B, H]
        return x.reshape(L, G, B, H).transpose(0, 1)

    return (top_scores, lse, eos, per_frame(c2), per_frame(h2), h_top), packed


def frame_nodes(lexicon: Lexicon, vocab: Vocab, config: Config, kana: str, pos: int,
                where: str) -> List[Node]:
    """Nodes ending at ``pos`` of the window ``kana``, in ``build_lattice``'s
    canonical order (start ascending, dictionary order within a start):
    tie for tie the batch engine's.  ``where`` names the frame in an
    overflow report."""
    M = min(config.max_word_len, lexicon.max_reading_len)
    nodes: List[Node] = []
    for start in range(max(0, pos - M), pos):
        for wid, disp in lexicon.candidates(kana[start:pos]):
            display = disp if disp is not None else vocab.display(wid)
            nodes.append(Node(wid, start, pos, display))
    nodes.sort(key=lambda n: n.start)
    handle_node_overflow(len(nodes) - config.max_nodes_per_frame, config, where)
    return nodes[: config.max_nodes_per_frame]


def walk(frames, bp, pos: int, beam: int) -> Tuple[List[Tuple[str, int]], int]:
    """Backtrack beam ``beam`` from window position ``pos`` to the root
    through a session's ``frames`` and back pointers ``bp``; returns
    (segments, root beam slot)."""
    segs: List[Tuple[str, int]] = []
    bi = beam
    while pos > 0:
        src, selp, seln = bp[pos]
        node = frames[pos][int(seln[bi])]
        segs.append((node.display, node.word_id))
        pos, bi = int(src[bi]), int(selp[bi])
    segs.reverse()
    return segs, bi


def rolled(frames, bp, committed, T_w: int):
    """Each beam slot's committed segments after a window roll at ``T_w``:
    its window segments joined to its root's history."""
    return [committed[rb] + segs
            for segs, rb in (walk(frames, bp, T_w, b) for b in range(len(committed)))]


def nbest(frames, bp, finals, committed, T: int, n_best: int) -> List[DecodeResult]:
    """A session's n-best at window position ``T`` (``[]`` before any kana),
    best first, ties to the lower slot; committed history prepended."""
    if T == 0:
        return []
    fin = finals[T]
    out = []
    for b in np.argsort(-fin, kind="stable")[:n_best]:
        if fin[b] <= -1e29:
            continue
        segs, root = walk(frames, bp, T, int(b))
        segs = committed[root] + segs
        out.append(DecodeResult(surface="".join(d for d, _ in segs),
                                score=float(fin[b]), segments=segs))
    return out


def build_probe_arrays(lexicon: Lexicon, config: Config, Q: int, window: str,
                       lm_probes: bool = True):
    """``(pos, wid, mask, per-probe chars)`` ranking continuations of
    ``window``, for the probe scorer that rides the keystroke step.

    For every start position within ``max_word_len`` of the frontier the
    lexicon's prefix index lists which characters extend the typed suffix
    into a real word, and which words witness each; longest suffix first.
    Shared by the single-session decoder and the multi-session server."""
    T = len(window)
    M = min(config.max_word_len, lexicon.max_reading_len)
    trie = lexicon.prefix_next()
    probes: List[Tuple[int, int, str]] = []  # (pos, wid, char)
    if lm_probes:
        for p in range(max(0, T - M + 1), T + 1):
            for ch, wids in trie.get(window[p:T], {}).items():
                for w in wids[:2]:
                    if len(probes) < Q:
                        probes.append((p, w, ch))
    pos = np.zeros(Q, np.int32)
    wid = np.full(Q, EOS_ID, np.int32)
    msk = np.zeros(Q, bool)
    for k, (p, w, _ch) in enumerate(probes):
        pos[k], wid[k], msk[k] = p, w, True
    return pos, wid, msk, [ch for _p, _w, ch in probes]


def _commit_rows(caches: Caches, pos: int, rows) -> None:
    """Write one frame's row values (``G == 1``) into the caches at ``pos``."""
    for cache, row in zip(caches, rows):
        cache[pos] = row[0]


class _Blob:
    """Static slices of one uploaded int32 blob, in order."""

    def __init__(self, blob: torch.Tensor):
        self.blob, self.o = blob, 0

    def cut(self, n: int, shape=None, kind=None) -> torch.Tensor:
        a = self.blob[self.o:self.o + n]
        self.o += n
        if shape is not None:
            a = a.reshape(shape)
        if kind is bool:
            return a != 0
        if kind is float:
            return a.view(torch.float32)
        return a


def _keystroke_step(params, caches: Caches, pos: int, blob: torch.Tensor, *, N: int, Q: int,
                    config: Config, kernel=None) -> torch.Tensor:
    """The typed frame (``blob`` = nw | ns | nm | pp | pw | pm, one upload)
    committed into ``caches``; returns its payload ``[4B + Q]``."""
    b = _Blob(blob)
    nodes = (b.cut(N, (1, N)), b.cut(N, (1, N)), b.cut(N, (1, N), bool))
    probes = (b.cut(Q, (1, Q)), b.cut(Q, (1, Q)), b.cut(Q, (1, Q), bool))
    rows, packed = _frame_rows(params, caches, *nodes, pos, *probes, config=config,
                               kernel=kernel)
    _commit_rows(caches, pos, rows)
    return packed[0]


def _prime_step(params, caches: Caches, pos: int, blob: torch.Tensor, *, K: int, N: int,
                Q: int, config: Config, kernel=None) -> torch.Tensor:
    """Speculation with no typed frame: the frames of ``K`` hypothetical
    next kana at ``pos`` (``blob`` = nw | ns | nm [K, N] | pp | pw | pm
    [K, Q]) in one forward; returns their payloads ``[K, 4B + Q]``.
    Seeds a fresh, rolled, popped or resumed session so its first
    keystroke can hit; the ranking is the host's."""
    b = _Blob(blob)
    nodes = (b.cut(K * N, (K, N)), b.cut(K * N, (K, N)), b.cut(K * N, (K, N), bool))
    probes = (b.cut(K * Q, (K, Q)), b.cut(K * Q, (K, Q)), b.cut(K * Q, (K, Q), bool))
    return _frame_rows(params, caches, *nodes, pos, *probes, config=config, kernel=kernel)[1]


def pack_unified_blob(N, Q, A, nw, ns, nm, pp, pw, pm, probe_char,
                      spec_nw, spec_ns, spec_nm, spec_pp, spec_pw, spec_pm,
                      spec_ok, char_prior) -> np.ndarray:
    """Host side: the unified step's 15 small tensors as ONE int32 upload
    (layout as the reference's ``pack_unified_blob``)."""
    return np.concatenate([
        nw.ravel(), ns.ravel(), nm.astype(np.int32).ravel(),
        pp.ravel(), pw.ravel(), pm.astype(np.int32).ravel(),
        probe_char.ravel(),
        spec_nw.ravel(), spec_ns.ravel(), spec_nm.astype(np.int32).ravel(),
        spec_pp.ravel(), spec_pw.ravel(), spec_pm.astype(np.int32).ravel(),
        spec_ok.astype(np.int32).ravel(),
        char_prior.astype(np.float32).view(np.int32).ravel(),
    ]).astype(np.int32)


def _unified_step(params, caches: Caches, pos: int, blob: torch.Tensor, *, K: int, N: int,
                  Q: int, A: int, config: Config, kernel=None) -> torch.Tensor:
    """One dispatch per keystroke: commit, predict, speculate.

    1. the typed frame's extension, committed into ``caches``;
    2. its continuation probes;
    3. the next-kana ranking on the device: each candidate char's best probe
       score (``probe_char`` maps probes to the ``A`` candidate rows), the
       host prior as the floor, the top ``K`` (ties: the lower row);
    4. the chosen K candidates' frames at ``pos + 1`` against the
       committed caches, in one forward over ``K * B`` rows: the next
       keystroke's payload, computed before it is typed.

    Returns typed payload | top-K rows | K payloads, flat int32."""
    B = config.beam_pad
    b = _Blob(blob)
    nodes = (b.cut(N, (1, N)), b.cut(N, (1, N)), b.cut(N, (1, N), bool))
    probes = (b.cut(Q, (1, Q)), b.cut(Q, (1, Q)), b.cut(Q, (1, Q), bool))
    probe_char = b.cut(Q)
    spec = [b.cut(A * N, (A, N)), b.cut(A * N, (A, N)), b.cut(A * N, (A, N), bool),
            b.cut(A * Q, (A, Q)), b.cut(A * Q, (A, Q)), b.cut(A * Q, (A, Q), bool)]
    spec_ok = b.cut(A, kind=bool)
    char_prior = b.cut(A, kind=float)

    rows, packed_t = _frame_rows(params, caches, *nodes, pos, *probes, config=config,
                                 kernel=kernel)
    _commit_rows(caches, pos, rows)
    packed_t = packed_t[0]

    p_best = packed_t[4 * B:].view(torch.float32)
    onehot = probe_char[:, None] == torch.arange(A, device=blob.device)[None, :]  # [Q, A]
    char_scores = torch.where(onehot, p_best[:, None], NEG).amax(dim=0)
    char_scores = torch.where(spec_ok, torch.maximum(char_scores, char_prior), NEG)
    topk_idx = topk_stable(char_scores[None], K)[1][0]

    chosen = [t.index_select(0, topk_idx) for t in spec]
    spec_packed = _frame_rows(params, caches, *chosen[:3], pos + 1, *chosen[3:], config=config,
                              kernel=kernel)[1]
    return torch.cat([packed_t, topk_idx.int(), spec_packed.reshape(-1)])


def _start_fetch(t: torch.Tensor):
    """Start the copy of ``t`` to the host without waiting: ``(host tensor,
    CUDA event or None)``; :func:`_finish_fetch` waits for it."""
    if not t.is_cuda:
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def _finish_fetch(host: torch.Tensor, event) -> np.ndarray:
    if event is not None:
        event.synchronize()
    return host.numpy()


class IncrementalDecoder:
    """Per-keystroke conversion session.

    ``push(kana_char)`` appends one kana and returns the current n-best;
    ``pop()`` removes the last kana (backspace); ``reset()`` starts over.

    ``device`` defaults to the card (raises without a GPU).  ``use_kernel``
    (default: on for the card in speed mode) runs each step's normalizer
    through ``project_lse``: bf16 compute with the int8 product per
    ``config.int8_mxu`` in speed mode (``precision="default"``), the exact
    fp32 / dequant-fp32 head with ``precision="highest"``.

    ``speculate=K`` issues one dispatch per keystroke that commits the typed
    frame, ranks the next kana on the device and computes the K most
    likely next keystrokes' payloads; a predicted keystroke ("hit") is
    answered from the previous dispatch's payload.  Next-kana predictor:
    ``None`` — LM probes scored on the device (default); ``"static"`` —
    the corpus-frequency kana prior; a callable ``predict(kana_prefix) ->
    [chars]``.
    """

    def __init__(
        self,
        params,
        lexicon: Lexicon,
        vocab: Vocab,
        config: Config,
        precision: str = "highest",
        speculate: int = 0,
        next_char_predictor=None,
        use_kernel: Optional[bool] = None,
        *,
        device="cuda",
    ):
        lstm_only("IncrementalDecoder", config=config)
        self.device = resolve_device(device)
        self.params, kernel = prepare_params(params, config, precision, use_kernel,
                                             self.device)
        self.lexicon = lexicon
        self.vocab = vocab
        self.config = config
        self._Q = 96  # padded (position, word) probe count per step
        self._A = 16  # padded candidate-char rows of the unified spec table
        N = config.max_nodes_per_frame
        self._root = _root_init(self.params, config, self.device, kernel)
        self._step = functools.partial(_keystroke_step, N=N, Q=self._Q, config=config,
                                       kernel=kernel)
        self.speculate = int(speculate)
        self._static_rank = self._default_predictor()
        self._lm_probes = next_char_predictor is None
        self._custom_predict = next_char_predictor if callable(next_char_predictor) else None
        if self.speculate > 0:
            if self.speculate > self._A:
                raise ValueError(f"speculate={speculate} exceeds {self._A} candidate rows")
            self._unified = functools.partial(
                _unified_step, K=self.speculate, N=N, Q=self._Q, A=self._A, config=config,
                kernel=kernel)
            self._prime_step = functools.partial(_prime_step, K=self.speculate, N=N,
                                                 Q=self._Q, config=config, kernel=kernel)
        self.spec_hits = 0
        self.spec_misses = 0
        self.reset()

    def _default_predictor(self):
        """Static kana prior: every kana of a vocab reading, ranked by the
        total corpus count of the tokens that contain it."""
        weight: dict = {}
        for tok, cnt in zip(self.vocab.tokens, np.asarray(self.vocab.counts)):
            for ch in tok.reading:
                weight[ch] = weight.get(ch, 0) + int(cnt)
        ranked = [c for c, _ in sorted(weight.items(), key=lambda kv: -kv[1])]

        def predict(_prefix: str):
            return ranked

        return predict

    def _build_probes(self, window: str):
        return build_probe_arrays(self.lexicon, self.config, self._Q, window,
                                  lm_probes=self._lm_probes)

    def _rank_chars(self, probe_chars: List[str],
                    probe_scores: Optional[np.ndarray]) -> List[str]:
        """Merge the device's probe scores into a ranked next-kana list."""
        if self._custom_predict is not None:
            return list(self._custom_predict(self.kana))
        ranked: List[str] = []
        if probe_scores is not None and probe_chars:
            char_score: dict = {}
            for k, ch in enumerate(probe_chars):
                s = float(probe_scores[k])
                if s > char_score.get(ch, -1e31):
                    char_score[ch] = s
            ranked = [c for c, _ in sorted(char_score.items(), key=lambda kv: -kv[1])]
        seen = set(ranked)
        for c in self._static_rank(self.kana):  # fill the tail
            if c not in seen:
                ranked.append(c)
        return ranked

    @property
    def _caches(self) -> Caches:
        return self._score, self._lse, self._eos, self._c, self._h, self._htop

    def reset(self) -> None:
        cfg = self.config
        B, L, H = cfg.beam_pad, cfg.num_layers, cfg.hidden_size
        T1 = cfg.max_kana_len + 1
        c, h, h_top, lse, eos = self._root
        zeros = functools.partial(torch.zeros, dtype=torch.float32, device=self.device)
        self._score = torch.full((T1, B), NEG, device=self.device)
        self._score[0, 0] = 0.0
        self._lse, self._eos = zeros((T1, B)), zeros((T1, B))
        self._c, self._h, self._htop = zeros((T1, L, B, H)), zeros((T1, L, B, H)), zeros((T1, B, H))
        for cache, row in zip((self._lse, self._eos, self._c, self._h, self._htop),
                              (lse, eos, c, h, h_top)):
            cache[0] = row
        self.kana = ""
        # positions are relative to self._base, the kana committed by rolls
        self._base = 0
        self._committed: List[List[Tuple[str, int]]] = [[] for _ in range(B)]
        self._frames: List[List[Node]] = [[]]  # frames[j] = nodes ending at j
        self._bp: List[Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]] = [None]
        self._finals: List[Optional[np.ndarray]] = [None]
        self._ranked_next: Optional[List[str]] = None
        self._pending = None
        self._prefetched: dict = {}
        self._prime()

    def _roll(self) -> None:
        """Commit the full window and keep typing past the bound: the cache
        row at the window's end (scores without ``<eos>``) becomes the new
        root row and each beam's window segments join its committed
        history.  ``pop()`` cannot cross a roll."""
        T_w = len(self.kana) - self._base
        self._committed = rolled(self._frames, self._bp, self._committed, T_w)
        for cache in self._caches:
            cache[0] = cache[T_w]
        self._base += T_w
        self._frames = [[]]
        self._bp = [None]
        self._finals = [None]
        self._ranked_next = None
        self._prime()

    def _frame_nodes(self, pos: int, kana: Optional[str] = None) -> List[Node]:
        """Nodes ending at ``pos`` for a kana prefix (default: the current
        window)."""
        kana = self.kana[self._base:] if kana is None else kana
        return frame_nodes(self.lexicon, self.vocab, self.config, kana, pos, f"pos={pos}")

    def _nodes_tensor(self, nodes: List[Node]):
        N = self.config.max_nodes_per_frame
        nw = np.full(N, EOS_ID, np.int32)
        ns = np.zeros(N, np.int32)
        nm = np.zeros(N, bool)
        for k, n in enumerate(nodes):
            nw[k], ns[k], nm[k] = n.word_id, n.start, True
        return nw, ns, nm

    def _candidate_chars(self, window_next: str) -> List[str]:
        """Candidate next-kana rows of the unified spec table: in LM mode
        every char the lexicon's continuation index admits after
        ``window_next`` (the device ranks them), then the static prior;
        otherwise the predictor's own order."""
        A = self._A
        if not self._lm_probes:
            return list((self._custom_predict or self._static_rank)(self.kana))[:A]
        T = len(window_next)
        M = min(self.config.max_word_len, self.lexicon.max_reading_len)
        trie = self.lexicon.prefix_next()
        chars: List[str] = []
        seen = set()
        for p in range(max(0, T - M + 1), T + 1):
            for ch in trie.get(window_next[p:T], {}):
                if ch not in seen and len(chars) < A:
                    seen.add(ch)
                    chars.append(ch)
        for ch in self._static_rank(self.kana):  # fill the remaining rows
            if ch not in seen and len(chars) < A:
                seen.add(ch)
                chars.append(ch)
        return chars

    def _spec_table(self, window_next: str, chars: Optional[List[str]] = None,
                    rows: Optional[int] = None):
        """Host tensors of candidate next kana (the device picks K): frames
        at ``len(window_next) + 1``, all rows invalid when the window is
        full (the next push rolls first).  ``chars`` defaults to every
        admissible continuation, ``rows`` to the table width A."""
        cfg = self.config
        pos1 = len(window_next) + 1
        A = self._A if rows is None else rows
        N, Q = cfg.max_nodes_per_frame, self._Q
        nw = np.full((A, N), EOS_ID, np.int32)
        ns = np.zeros((A, N), np.int32)
        nm = np.zeros((A, N), bool)
        pp = np.zeros((A, Q), np.int32)
        pw = np.full((A, Q), EOS_ID, np.int32)
        pm = np.zeros((A, Q), bool)
        ok = np.zeros(A, bool)
        # fallback prior far below any probe log-prob, descending in row
        # order: the predictor's order, and a tie-break for chars no probe
        # witnessed
        prior = np.full(A, -1e30, np.float32)
        meta: List[Optional[Tuple[str, List[Node], tuple]]] = [None] * A
        if pos1 <= cfg.max_kana_len:
            if chars is None:
                chars = self._candidate_chars(window_next)
            for a, ch in enumerate(chars[:A]):
                nodes = self._frame_nodes(pos1, window_next + ch)
                probes = self._build_probes(window_next + ch)
                nw[a], ns[a], nm[a] = self._nodes_tensor(nodes)
                pp[a], pw[a], pm[a] = probes[0], probes[1], probes[2]
                ok[a] = True
                prior[a] = -1e20 - a
                meta[a] = (ch, nodes, probes)
        return {"arrays": (nw, ns, nm, pp, pw, pm, ok, prior), "meta": meta}

    def _prime(self) -> None:
        """Speculate the next frame with no typed frame to commit, so the
        first keystroke of a fresh, rolled, popped or resumed session can
        hit.  Host-ranked: no probe scores exist yet."""
        self._pending = None
        self._prefetched = {}
        if self.speculate <= 0:
            return
        window = self.kana[self._base:]
        if len(window) + 1 > self.config.max_kana_len:
            return
        ranked = self._ranked_next
        if ranked is None:
            ranked = self._rank_chars([], None)
        table = self._spec_table(window, chars=ranked, rows=self.speculate)
        if not any(m is not None for m in table["meta"]):
            return
        blob = np.concatenate([a.astype(np.int32).ravel() for a in table["arrays"][:6]])
        packed = self._prime_step(self.params, self._caches, len(window) + 1,
                                  upload(blob, self.device))
        self._pending = {"fetch": _start_fetch(packed), "meta": table["meta"], "kind": "prime"}

    def _dispatch_unified(self, pos: int, nodes: List[Node], probes: tuple) -> None:
        """Issue the one unified device call of a committed keystroke."""
        table = self._spec_table(self.kana[self._base:])
        chars = [m[0] if m else None for m in table["meta"]]
        # each typed-frame probe's candidate-char row (A: none)
        probe_char = np.full(self._Q, self._A, np.int32)
        for q, ch in enumerate(probes[3]):
            if ch in chars:
                probe_char[q] = chars.index(ch)
        nw, ns, nm = self._nodes_tensor(nodes)
        blob = pack_unified_blob(
            self.config.max_nodes_per_frame, self._Q, self._A, nw, ns, nm,
            np.asarray(probes[0]), np.asarray(probes[1]), np.asarray(probes[2]),
            probe_char, *table["arrays"])
        packed = self._unified(self.params, self._caches, pos, upload(blob, self.device))
        self._pending = {"fetch": _start_fetch(packed), "meta": table["meta"],
                         "kind": "unified"}

    def _fetch_pending(self) -> Optional[np.ndarray]:
        """Wait for the last dispatched call's payload and unpack its
        hypotheses into ``_prefetched``; returns the payload."""
        if self._pending is None:
            return None
        B, K = self.config.beam_pad, self.speculate
        stride = 4 * B + self._Q
        out = _finish_fetch(*self._pending["fetch"])
        meta, kind = self._pending["meta"], self._pending["kind"]
        self._pending = None
        if kind == "prime":  # [K, stride]; row k is hypothesis meta[k]
            topk, payloads = np.arange(out.shape[0]), out
        else:  # flat: typed stride | top-K rows | K payloads
            topk = out[stride:stride + K]
            payloads = out[stride + K:].reshape(K, stride)
        self._prefetched = {}
        for k, a in enumerate(topk):
            m = meta[int(a)] if 0 <= int(a) < len(meta) else None
            if m is None:
                continue
            ch, nodes, probes = m
            pay = payloads[k]
            self._prefetched[ch] = {
                "bp": (pay[:B], pay[B:2 * B], pay[2 * B:3 * B]),
                "finals": pay[3 * B:4 * B].view(np.float32),
                "probe_scores": pay[4 * B:].view(np.float32),
                "nodes": nodes,
                "probes": probes,
            }
        return out

    def push(self, kana_char: str, n_best: int = 1) -> List[DecodeResult]:
        if len(kana_char) != 1:
            raise ValueError("push one kana at a time")
        cfg = self.config
        B = cfg.beam_pad
        if len(self.kana) - self._base >= cfg.max_kana_len:
            self._roll()  # commit the full window and keep typing
        pos = len(self.kana) - self._base + 1
        self.kana += kana_char

        if self.speculate > 0:
            self._fetch_pending()
            hit = self._prefetched.pop(kana_char, None)
            self._prefetched = {}  # the other hypotheses are stale now
            if hit is not None:
                # a predicted keystroke: its results are the previous
                # call's payload, no device work on the critical path
                self.spec_hits += 1
                nodes, typed_probes = hit["nodes"], hit["probes"]
                bp, finals = hit["bp"], hit["finals"]
                probe_scores, probe_chars = hit["probe_scores"], typed_probes[3]
            else:
                self.spec_misses += 1
                nodes = self._frame_nodes(pos)
                typed_probes = self._build_probes(self.kana[self._base:])
                probe_chars = typed_probes[3]
            self._dispatch_unified(pos, nodes, typed_probes)
            if hit is None:  # a miss waits for this call's typed payload
                out = self._fetch_pending()
                bp = (out[:B], out[B:2 * B], out[2 * B:3 * B])
                finals = out[3 * B:4 * B].view(np.float32)
                probe_scores = out[4 * B:4 * B + self._Q].view(np.float32)
        else:
            nodes = self._frame_nodes(pos)
            nw, ns, nm = self._nodes_tensor(nodes)
            pp, pw, pm, probe_chars = self._build_probes(self.kana[self._base:])
            blob = np.concatenate([nw, ns, nm.astype(np.int32), pp, pw,
                                   pm.astype(np.int32)]).astype(np.int32)
            packed = self._step(self.params, self._caches, pos, upload(blob, self.device))
            out = packed.cpu().numpy()  # one fetch a keystroke
            bp = (out[:B], out[B:2 * B], out[2 * B:3 * B])
            finals = out[3 * B:4 * B].view(np.float32)
            probe_scores = out[4 * B:].view(np.float32) if self._lm_probes else None

        if len(self._frames) <= pos:
            self._frames.append(nodes)
            self._bp.append(None)
            self._finals.append(None)
        self._frames[pos] = nodes
        self._bp[pos] = bp
        self._finals[pos] = finals
        res = self.results(n_best)
        self._ranked_next = self._rank_chars(probe_chars, probe_scores)
        return res

    def pop(self) -> None:
        """Backspace: drop the last kana; the cached prefix stays valid.
        Cannot cross a window roll (its frames were released)."""
        if not self.kana:
            raise ValueError("nothing to pop")
        if len(self.kana) <= self._base:
            raise ValueError("cannot backspace across a committed window boundary")
        self.kana = self.kana[:-1]
        # speculation in flight was for the longer prefix
        self._ranked_next = None
        self._prime()

    # --- session checkpoint and resume: the (c, h) caches and the beams ---
    def save_session(self, path: str) -> None:
        """Snapshot the typing session to one ``.npz`` (the reference's keys
        and ``meta`` JSON, so either package resumes the other's)."""
        names = ("score", "lse", "eos", "c", "h", "htop")
        arrays = {k: v.cpu().numpy() for k, v in zip(names, self._caches)}
        T = len(self.kana) - self._base
        for pos in range(1, T + 1):
            arrays[f"bp{pos}"] = np.stack(self._bp[pos])
            arrays[f"fin{pos}"] = self._finals[pos]
        meta = {
            "kana": self.kana,
            "base": self._base,
            "committed": self._committed,
            # every cached array has beam_pad rows: resuming under another
            # beam_pad must fail loudly instead of mis-indexing
            "beam_pad": self.config.beam_pad,
            "beam_width": self.config.beam_width,
            "frames": [[(n.word_id, n.start, n.end, n.display) for n in fr]
                       for fr in self._frames[: T + 1]],
        }
        np.savez(path, meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8), **arrays)

    def load_session(self, path: str) -> None:
        """Resume a snapshot saved by :meth:`save_session`."""
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta"]).decode())
            saved_pad = meta.get("beam_pad")
            if saved_pad is not None and saved_pad != self.config.beam_pad:
                raise ValueError(
                    f"session snapshot was saved with beam_pad={saved_pad} "
                    f"(beam_width={meta.get('beam_width')}); this decoder uses "
                    f"beam_pad={self.config.beam_pad}: cache and payload shapes are "
                    "incompatible, re-type the session")
            self.kana = meta["kana"]
            self._base = meta.get("base", 0)
            self._committed = [
                [tuple(seg) for seg in beam]
                for beam in meta.get("committed", [[] for _ in range(self.config.beam_pad)])]
            self._frames = [[Node(w, s, e, d) for (w, s, e, d) in fr] for fr in meta["frames"]]
            (self._score, self._lse, self._eos, self._c, self._h, self._htop) = (
                torch.from_numpy(np.asarray(z[k], np.float32)).to(self.device)
                for k in ("score", "lse", "eos", "c", "h", "htop"))
            T = len(self.kana) - self._base
            self._bp = [None] * (T + 1)
            self._finals = [None] * (T + 1)
            for pos in range(1, T + 1):
                bp = z[f"bp{pos}"]
                self._bp[pos] = (bp[0], bp[1], bp[2])
                self._finals[pos] = z[f"fin{pos}"]
        self._ranked_next = None
        self._prime()

    def results(self, n_best: int = 1) -> List[DecodeResult]:
        return nbest(self._frames, self._bp, self._finals, self._committed,
                     len(self.kana) - self._base, n_best)
