"""Reference lattice beam search and path rescoring over a model family's
reference LM.

A frozen copy of the oracle's algorithm (``jlm_tpu_torch/oracle/decoder.py``,
``decoder/lattice.py``), written against the raw lexicon: every lexicon word
whose reading is ``kana[i:j]`` (``j - i <= max_word_len``) is a node ending
at ``j``, an unmatched single kana an ``<unk>`` node; a frame keeps its
nodes by start position (then frequency), truncated to ``max_nodes``.  The
beam at position 0 is ``<eos>`` from the LM's initial state; a frame enumerates
extensions node-major, path-minor, keeps the best ``beam`` (stable), and
feeds each kept path's word; the final score adds ``log p(<eos>)``.  The LM
steps of all sentences run batched, one per position; the search itself is
plain Python.

The LM is the family's (``reference_lm``); its state is opaque here.  It
gives ``initial_state(rows, device)``, ``step(words, state) -> (logp [R, V],
state)`` and ``select(states, pos, rows)``: the state whose row k is row
``rows[k]`` of ``states[pos[k]]``.  The search keeps each position's state as
the LM returned it and moves rows only through ``select``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from benchmark.data.lexicon import EOS_ID, UNK_ID, RawLexicon

Node = Tuple[int, int]  # (word id, start)


def lattice(kana: str, by_reading: Dict[str, List[int]], max_word_len: int,
            max_nodes: int) -> List[List[Node]]:
    """``frames[j]``: the nodes ending at position ``j`` (``frames[0]`` empty)."""
    T = len(kana)
    M = min(max_word_len, max(len(r) for r in by_reading))
    frames: List[List[Node]] = [[] for _ in range(T + 1)]
    for i in range(T):
        for j in range(i + 1, min(i + M, T) + 1):
            wids = by_reading.get(kana[i:j])
            if wids:
                frames[j].extend((w, i) for w in wids)
            elif j == i + 1:
                frames[j].append((UNK_ID, i))
    for j in range(1, T + 1):
        frames[j].sort(key=lambda n: n[1])
        del frames[j][max_nodes:]
    return frames


def beam_search(lm: Any, kanas: Sequence[str], lex: RawLexicon, beam: int,
                max_word_len: int, max_nodes: int, device) -> List[Tuple[float, List[Node]]]:
    """Best final path of each sentence: ``(score, [(word, start), ...])``."""
    by_reading = lex.by_reading()
    S, B = len(kanas), beam
    frames = [lattice(k, by_reading, max_word_len, max_nodes) for k in kanas]
    T = max(len(k) for k in kanas)
    states: List[Any] = []  # after each position's forward: rows s * B + path
    # per position: each sentence's needed columns (words starting there + <eos>)
    cols: List[List[List[int]]] = []
    for p in range(T + 1):
        per = []
        for s in range(S):
            ws = sorted({w for j in range(p + 1, len(kanas[s]) + 1)
                         for w, st in frames[s][j] if st == p}) if p < len(kanas[s]) else []
            per.append(ws + [EOS_ID])
        cols.append(per)
    # beams[s][p]: list of (score, back (src position, path), node)
    beams: List[List[list]] = [[[] for _ in range(len(k) + 1)] for k in kanas]
    logp_at: List[List[Optional[np.ndarray]]] = [[None] * (T + 1) for _ in range(S)]
    col_of: List[List[Dict[int, int]]] = [[{} for _ in range(T + 1)] for _ in range(S)]

    def forward(words: torch.Tensor, state) -> None:
        p = len(states)
        logp, state = lm.step(words, state)
        states.append(state)
        width = max(len(cols[p][s]) for s in range(S))
        idx = torch.zeros((S, width), dtype=torch.long)
        for s in range(S):
            idx[s, :len(cols[p][s])] = torch.tensor(cols[p][s])
            col_of[s][p] = {w: i for i, w in enumerate(cols[p][s])}
        got = logp.view(S, B, -1).gather(2, idx.to(device)[:, None, :].expand(S, B, width))
        got = got.cpu().numpy()
        for s in range(S):
            logp_at[s][p] = got[s]

    for s in range(S):
        beams[s][0] = [(0.0, None, None)]
    words = torch.full((S * B,), EOS_ID, dtype=torch.long, device=device)
    forward(words, lm.initial_state(S * B, device))
    for p in range(1, T + 1):
        words = torch.full((S * B,), EOS_ID, dtype=torch.long)
        pos = torch.zeros(S * B, dtype=torch.long)  # (position, row) of each row's state
        rows = torch.zeros(S * B, dtype=torch.long)
        for s in range(S):
            if p > len(kanas[s]):
                continue
            exts = []
            for node in frames[s][p]:
                w, st = node
                for pi, path in enumerate(beams[s][st]):
                    exts.append((path[0] + float(logp_at[s][st][pi, col_of[s][st][w]]),
                                 (st, pi), node))
            order = np.argsort(-np.asarray([e[0] for e in exts], np.float32),
                               kind="stable")[:B]
            beams[s][p] = [exts[i] for i in order]
            for k, (_, (st, pi), (w, _)) in enumerate(beams[s][p]):
                words[s * B + k] = w
                pos[s * B + k], rows[s * B + k] = st, s * B + pi
        forward(words.to(device), lm.select(states, pos.to(device), rows.to(device)))

    out = []
    for s, kana in enumerate(kanas):
        Ts = len(kana)
        finals = [path[0] + float(logp_at[s][Ts][pi, col_of[s][Ts][EOS_ID]])
                  for pi, path in enumerate(beams[s][Ts])]
        best = int(np.argsort(-np.asarray(finals, np.float32), kind="stable")[0])
        nodes, p, pi = [], Ts, best
        while p > 0:
            _, (st, spi), node = beams[s][p][pi]
            nodes.append(node)
            p, pi = st, spi
        out.append((finals[best], nodes[::-1]))
    return out


def rescore(lm: Any, paths: Sequence[Sequence[int]], device) -> List[float]:
    """Each word sequence's score: ``sum log p(w_k | w_<k) + log p(<eos> | w)``
    from ``<eos>`` at the LM's initial state, the sequences batched."""
    S = len(paths)
    n = max(len(p) for p in paths)
    feed = torch.full((n + 1, S), EOS_ID, dtype=torch.long)
    target = torch.full((n + 1, S), EOS_ID, dtype=torch.long)
    for s, p in enumerate(paths):
        feed[1:len(p) + 1, s] = torch.tensor(list(p), dtype=torch.long)
        target[:len(p), s] = torch.tensor(list(p), dtype=torch.long)
    feed, target = feed.to(device), target.to(device)
    state = lm.initial_state(S, device)
    total = torch.zeros(S, dtype=torch.float64, device=device)
    lengths = torch.tensor([len(p) for p in paths], device=device)
    for t in range(n + 1):
        logp, state = lm.step(feed[t], state)
        got = logp.gather(1, target[t][:, None])[:, 0].double()
        total += torch.where(t <= lengths, got, torch.zeros_like(got))
    return total.cpu().tolist()


def path_readings(segments: Sequence[Tuple[str, int]], lex: RawLexicon) -> List[str]:
    """The reading of each served segment ``(display, word id)``: the word's
    reading, or for ``<unk>`` the kana it spans (its display)."""
    return [disp if wid == UNK_ID else lex.words[wid][1] for disp, wid in segments]


def valid_path(kana: str, segments: Sequence[Tuple[str, int]], lex: RawLexicon,
               by_reading: Dict[str, List[int]], max_word_len: int) -> bool:
    """A served path is a segmentation of ``kana`` into lexicon words (an
    ``<unk>`` only for a single kana that no word reads)."""
    if not segments:
        return False
    for (disp, wid), r in zip(segments, path_readings(segments, lex)):
        if not 0 < len(r) <= max_word_len:
            return False
        if wid == UNK_ID:
            if len(r) != 1 or r in by_reading:
                return False
        elif not (0 <= wid < len(lex)) or wid not in by_reading.get(r, ()):
            return False
    return "".join(path_readings(segments, lex)) == kana
