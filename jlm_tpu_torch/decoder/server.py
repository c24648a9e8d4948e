"""Multi-session IME serving: batched per-keystroke steps.

Counterpart of :mod:`jlm_tpu.decoder.server`.  ``SessionServer`` holds
``max_sessions`` sessions' caches in device tensors with a leading session
axis and advances a batch of ``(session, kana_char)`` events per step:

- each event's frame nodes are built on the host (the lattice builder's
  canonical rules: parity with single-session decoding is exact);
- the step gathers each event's beams and caches by session, scores the
  extensions lazily (cached per-path logsumexp and candidate-column
  logits, as :mod:`jlm_tpu_torch.decoder.incremental` does), prunes, runs
  ONE LM forward over every event's beams (one ``project_lse`` launch per
  head block in kernel mode) and scatters the rows back;
- event batches pad to power-of-two buckets; padding events write only the
  reserved session row ``Smax - 1``.

Session lifecycle: ``open() -> sid``, ``push(events)``, ``results(sid)``,
``backspace(sid)``, ``close(sid)``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from jlm_tpu_torch.config import Config, EOS_ID
from jlm_tpu_torch.data.corpus import Vocab
from jlm_tpu_torch.data.lexicon import Lexicon
from jlm_tpu_torch.decoder.engine import NEG, lstm_only, upload
from jlm_tpu_torch.decoder.incremental import (
    _forward_with_lse, _frame_rows, build_probe_arrays, frame_nodes, nbest, prepare_params,
    rolled)
from jlm_tpu_torch.decoder.lattice import Node
from jlm_tpu_torch.models.lstm import initial_state
from jlm_tpu_torch.models.params import resolve_device
from jlm_tpu_torch.oracle.decoder import DecodeResult


def _batch_keystroke_step(
    params,
    caches,  # score, lse, eos [Smax, T1, B]; c, h [Smax, T1, L, B, H]; htop [Smax, T1, B, H]
    sid,  # [E] session of each event
    pos,  # [E] new end position of each event (1-based)
    node_word,  # [E, N]
    node_start,  # [E, N]
    node_mask,  # bool [E, N]
    ev_mask,  # bool [E]: a real event, not padding
    probe_pos,  # [E, Q] next-kana probes (Q = 0: none)
    probe_wid,  # [E, Q]
    probe_mask,  # bool [E, Q]
    *,
    config: Config,
    kernel=None,
) -> torch.Tensor:
    """One batched keystroke step, committed into ``caches`` in place;
    returns the packed payload ``[E, 4B + Q]`` int32.  Each event is one
    frame of :func:`~jlm_tpu_torch.decoder.incremental._frame_rows` on its
    session's caches; its rows are written back at (sid, pos), padding
    events' at the reserved row ``Smax - 1``, position 0, never a live
    session's."""
    rows, packed = _frame_rows(params, caches, node_word, node_start, node_mask,
                               pos.long()[:, None], probe_pos, probe_wid, probe_mask,
                               config=config, kernel=kernel, sid=sid)
    Smax = caches[0].shape[0]
    sid_w = torch.where(ev_mask, sid.long(), Smax - 1)
    pos_w = torch.where(ev_mask, pos.long(), 0)
    for cache, row in zip(caches, rows):
        cache[sid_w, pos_w] = row
    return packed


class SessionServer:
    """Batched per-keystroke serving of up to ``max_sessions`` sessions.

    ``probes=False`` leaves the next-kana probe scoring out of the step
    (``suggest_next`` then returns []).  ``use_kernel`` (default: on for the
    card in speed mode) runs the step's normalizer through ``project_lse``,
    as :class:`~jlm_tpu_torch.decoder.incremental.IncrementalDecoder` does.
    ``device`` defaults to the card (raises without a GPU)."""

    def __init__(
        self,
        params,
        lexicon: Lexicon,
        vocab: Vocab,
        config: Config,
        max_sessions: int = 64,
        precision: str = "highest",
        probes: bool = True,
        use_kernel: Optional[bool] = None,
        *,
        device="cuda",
    ):
        lstm_only("SessionServer", config=config)
        self.device = resolve_device(device)
        self.params, kernel = prepare_params(params, config, precision, use_kernel,
                                             self.device)
        self.lexicon = lexicon
        self.vocab = vocab
        self.config = config
        self._kernel = kernel
        # one extra reserved row absorbs the padding events' writes
        self.Smax = max_sessions + 1
        B, L, H = config.beam_pad, config.num_layers, config.hidden_size
        T1 = config.max_kana_len + 1
        zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32,  # noqa: E731
                                           device=self.device)
        self._score = torch.full((self.Smax, T1, B), NEG, device=self.device)
        self._lse, self._eos = zeros(self.Smax, T1, B), zeros(self.Smax, T1, B)
        self._c, self._h = zeros(self.Smax, T1, L, B, H), zeros(self.Smax, T1, L, B, H)
        self._htop = zeros(self.Smax, T1, B, H)
        self._root: Optional[Tuple] = None
        self._free = list(range(max_sessions))
        self._kana: Dict[int, str] = {}
        self._frames: Dict[int, List[List[Node]]] = {}
        self._bp: Dict[int, List] = {}
        self._finals: Dict[int, List] = {}
        # window rolls: _base[sid] = kana committed by rolls; _committed[sid][b]
        # = beam slot b's committed segments
        self._base: Dict[int, int] = {}
        self._committed: Dict[int, List[List[Tuple[str, int]]]] = {}
        self._Q = 96 if probes else 0  # next-kana probes a step (0: none)
        self._probe_chars: Dict[int, List[str]] = {}
        self._probe_scores: Dict[int, Optional[np.ndarray]] = {}

    @property
    def _caches(self):
        return self._score, self._lse, self._eos, self._c, self._h, self._htop

    def _step(self, *arrays) -> torch.Tensor:
        """One batched step on uploaded event tensors."""
        return _batch_keystroke_step(self.params, self._caches, *arrays, config=self.config,
                                     kernel=self._kernel)

    # --- session lifecycle ---
    def open(self) -> int:
        if not self._free:
            raise RuntimeError("session pool exhausted")
        sid = self._free.pop()
        if self._root is None:
            self._root = self._compute_root()
        self._score[sid] = NEG
        self._score[sid, 0, 0] = 0.0
        for cache, row in zip(self._caches[1:], self._root):
            cache[sid, 0] = row
        self._kana[sid] = ""
        self._frames[sid] = [[]]
        self._bp[sid] = [None]
        self._finals[sid] = [None]
        self._base[sid] = 0
        self._committed[sid] = [[] for _ in range(self.config.beam_pad)]
        self._probe_chars[sid] = []
        self._probe_scores[sid] = None
        return sid

    def _compute_root(self):
        """The session root row ``(lse, eos, c, h [L, B, H], h_top)``,
        computed once through the plain logits row, as the reference does."""
        B = self.config.beam_pad
        words = torch.full((B,), EOS_ID, dtype=torch.long, device=self.device)
        (c, h), h_top, lse, eos = _forward_with_lse(
            self.params, self.config, words, initial_state(self.config, B, self.device))
        return lse, eos, c, h, h_top

    def close(self, sid: int) -> None:
        for d in (self._kana, self._frames, self._bp, self._finals, self._base,
                  self._committed, self._probe_chars, self._probe_scores):
            d.pop(sid, None)
        self._free.append(sid)

    def backspace(self, sid: int) -> None:
        if not self._kana[sid]:
            raise ValueError("nothing to delete")
        if len(self._kana[sid]) <= self._base[sid]:
            raise ValueError("cannot backspace across a committed window boundary")
        self._kana[sid] = self._kana[sid][:-1]

    def _roll(self, sid: int) -> None:
        """Commit a full window and keep typing, as
        ``IncrementalDecoder._roll``: the window-end cache row becomes the
        session's root row; each beam's window segments join its history."""
        T_w = len(self._kana[sid]) - self._base[sid]
        self._committed[sid] = rolled(self._frames[sid], self._bp[sid], self._committed[sid], T_w)
        for cache in self._caches:
            cache[sid, 0] = cache[sid, T_w]
        self._base[sid] += T_w
        self._frames[sid] = [[]]
        self._bp[sid] = [None]
        self._finals[sid] = [None]

    # --- batched keystrokes ---
    def _frame_nodes(self, sid: int, pos: int) -> List[Node]:
        return frame_nodes(self.lexicon, self.vocab, self.config,
                           self._kana[sid][self._base[sid]:], pos, f"sid={sid} pos={pos}")

    @staticmethod
    def _bucket(n: int) -> int:
        b = 1
        while b < n:
            b *= 2
        return b

    def push(self, events: Sequence[Tuple[int, str]]) -> None:
        """Advance a batch of sessions by one kana each (one device step).

        ``events`` = [(sid, kana_char)]; a session appears at most once a
        batch."""
        cfg = self.config
        E_real = len(events)
        if E_real == 0:
            raise ValueError("no events")
        if len({s for s, _ in events}) != E_real:
            raise ValueError("duplicate session in one batch")
        for sid, _ in events:  # roll full windows before batching
            if len(self._kana[sid]) - self._base[sid] >= cfg.max_kana_len:
                self._roll(sid)
        E = self._bucket(E_real)
        N, Q = cfg.max_nodes_per_frame, self._Q

        sid_a = np.zeros(E, np.int32)
        pos_a = np.zeros(E, np.int32)
        nw = np.full((E, N), EOS_ID, np.int32)
        ns = np.zeros((E, N), np.int32)
        nm = np.zeros((E, N), np.int32)
        ev = np.zeros(E, np.int32)
        pp = np.zeros((E, Q), np.int32)
        pw = np.full((E, Q), EOS_ID, np.int32)
        pm = np.zeros((E, Q), np.int32)
        frames_new: List[List[Node]] = []
        for i, (sid, ch) in enumerate(events):
            if len(ch) != 1:
                raise ValueError("one kana per event")
            pos = len(self._kana[sid]) - self._base[sid] + 1
            self._kana[sid] += ch
            nodes = self._frame_nodes(sid, pos)
            frames_new.append(nodes)
            sid_a[i], pos_a[i], ev[i] = sid, pos, 1
            for k, n in enumerate(nodes):
                nw[i, k], ns[i, k], nm[i, k] = n.word_id, n.start, 1
            probes = build_probe_arrays(self.lexicon, cfg, Q,
                                        self._kana[sid][self._base[sid]:])
            pp[i], pw[i], pm[i] = probes[0], probes[1], probes[2]
            self._probe_chars[sid] = probes[3]

        # one upload: sid | pos | ev | nw | ns | nm | pp | pw | pm
        blob = upload(np.concatenate([sid_a, pos_a, ev, nw.ravel(), ns.ravel(), nm.ravel(),
                                      pp.ravel(), pw.ravel(), pm.ravel()]), self.device)
        cut = np.cumsum([0, E, E, E, E * N, E * N, E * N, E * Q, E * Q, E * Q])
        t = [blob[a:b] for a, b in zip(cut[:-1], cut[1:])]
        packed = self._step(t[0], t[1], t[3].reshape(E, N), t[4].reshape(E, N),
                            t[5].reshape(E, N) != 0, t[2] != 0, t[6].reshape(E, Q),
                            t[7].reshape(E, Q), t[8].reshape(E, Q) != 0)
        out = packed.cpu().numpy()  # one fetch for the whole batch
        B = cfg.beam_pad
        for i, (sid, _) in enumerate(events):
            pos = int(pos_a[i])
            while len(self._frames[sid]) <= pos:
                self._frames[sid].append([])
                self._bp[sid].append(None)
                self._finals[sid].append(None)
            self._frames[sid][pos] = frames_new[i]
            self._bp[sid][pos] = (out[i, :B], out[i, B:2 * B], out[i, 2 * B:3 * B])
            self._finals[sid][pos] = out[i, 3 * B:4 * B].view(np.float32)
            self._probe_scores[sid] = out[i, 4 * B:].view(np.float32)

    def suggest_next(self, sid: int, k: int = 8) -> List[str]:
        """The LM-ranked likely next kana of a session, from the probe
        scores that rode its last push's payload."""
        scores = self._probe_scores.get(sid)
        chars = self._probe_chars.get(sid, [])
        if scores is None or not chars:
            return []
        best: Dict[str, float] = {}
        for q, ch in enumerate(chars):
            s = float(scores[q])
            if s > best.get(ch, -1e31):
                best[ch] = s
        return [c for c, _ in sorted(best.items(), key=lambda kv: -kv[1])][:k]

    def results(self, sid: int, n_best: int = 1) -> List[DecodeResult]:
        return nbest(self._frames[sid], self._bp[sid], self._finals[sid], self._committed[sid],
                     len(self._kana[sid]) - self._base[sid], n_best)
