"""The lattice search's path state for an attention LM: a latent path cache.

A transformer's state is its path's whole history of words, and the
search's paths fork along the backpointers: every kept extension at
position ``pos`` is the child of one row at an earlier position.  Nothing
is copied when a path forks.  The chunk keeps one store of every
position's rows' per-layer latents (for MLA, ``c_kv`` after its norm and
the rotated ``k_pe``: ``width`` values a word and layer), written once
where a row is fed, and each row keeps an ancestor table: the flat store
index (``pos * S*B + row``) of each word of its path, the root's
``<eos>`` first, and its depth (the words after the root, = the row's
RoPE position).  A child's table is its parent's with its own index at
``depth + 1``.  The tables live in ring caches of ``_RING`` rows beside the
search's scores, as the LSTM's ``(c, h)`` do: a parent lies at most
``max_word_len < _RING`` positions back.  The store spans the chunk's
``T_max + 1`` positions.

Slots of a table past its depth hold indices of written entries (the
root's, or an older path's), so a gather never reads unwritten memory;
the attention masks them.

While the tracer is on, the chunk's device counters ride here as well:
``mla.ancestors`` (the ancestors attended, summed over rows and frames) and
the routed rows of each expert of each layer, whose largest and smallest
sums over the chunk are ``moe.expert_rows_max`` and ``moe.expert_rows_min``;
the engine fetches them with the chunk's blob.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch

from jlm_tpu_torch.decoder.engine import _RING


class PathRows:
    """The rows fed at ``pos``: ``table [S*B, pos + 1]`` (the store indices of
    each row's path, slots past ``depth`` masked), ``depth [S*B]``, ``own``
    (each row's store index at ``pos``), and the store and counters they
    read and write.  What the forward takes as its state and returns."""

    def __init__(self, cache: "LatentPaths", pos: int, table: torch.Tensor,
                 depth: torch.Tensor):
        self.cache, self.pos, self.depth = cache, pos, depth
        self.full_table = table  # [S, B, T1]
        SB = cache.S * cache.B
        self.table = table.reshape(SB, -1)[:, :pos + 1]
        self.own = cache.rows + pos * SB
        if cache.counters is not None:
            cache.counters["mla.ancestors"] += (depth + 1).sum()

    @functools.cached_property
    def masked(self) -> torch.Tensor:
        """``[S*B, pos + 1]``: the slots a row does not attend (past its path
        and itself); made once a frame, every layer reads it."""
        slot = torch.arange(self.pos + 1, device=self.depth.device)
        return slot[None, :] > self.depth.reshape(-1, 1)

    def write(self, layer: int, latent: torch.Tensor) -> None:
        """Store the rows' latents ``[S*B, width]`` of ``layer`` at ``pos``."""
        self.cache.store[layer, self.own] = latent.to(self.cache.store.dtype)

    def gather(self, layer: int) -> torch.Tensor:
        """``[S*B, pos + 1, width]``: each row's path's latents of ``layer``."""
        return self.cache.store[layer][self.table]

    def count_experts(self, moe_layer: int, idx: torch.Tensor, n_experts: int) -> None:
        """Add the routed rows ``idx [R, k]`` to the chunk's expert histogram."""
        hist = self.cache.expert_rows
        if hist is not None:
            hist[moe_layer] += torch.bincount(idx.reshape(-1), minlength=n_experts).to(hist.dtype)


class LatentPaths:
    """A chunk's latent store ``[layers, (T_max + 1) * S*B, width]`` in
    ``dtype`` and the rows' ancestor tables and depths in ring caches.
    ``root``, ``select``, ``write``: the engine's path-state hooks."""

    def __init__(self, S: int, B: int, T_max: int, layers: int, width: int, dtype, device,
                 moe_layers: int = 0, n_experts: int = 0, counting: bool = False):
        self.S, self.B, self.T1 = S, B, T_max + 1
        self.device = device
        self.store = torch.empty((layers, self.T1 * S * B, width), dtype=dtype, device=device)
        self.table = torch.zeros((S, _RING, B, self.T1), dtype=torch.long, device=device)
        self.depth = torch.zeros((S, _RING, B), dtype=torch.long, device=device)
        self.rows = torch.arange(S * B, device=device)
        self.counters: Optional[Dict[str, torch.Tensor]] = None
        self.expert_rows: Optional[torch.Tensor] = None
        if counting:
            self.counters = {"mla.ancestors": torch.zeros((), dtype=torch.int32, device=device)}
            if moe_layers:
                self.expert_rows = torch.zeros((moe_layers, n_experts), dtype=torch.int32,
                                               device=device)
        self._s_idx = torch.arange(S, device=device)[:, None]

    def root(self) -> PathRows:
        """Position 0: each row's path is its ``<eos>`` alone (depth 0)."""
        table = torch.zeros((self.S, self.B, self.T1), dtype=torch.long, device=self.device)
        table[..., 0] = self.rows.reshape(self.S, self.B)
        return PathRows(self, 0, table, torch.zeros((self.S, self.B), dtype=torch.long,
                                                    device=self.device))

    def select(self, pos: int, src_pos: torch.Tensor, sel_p: torch.Tensor) -> PathRows:
        """The kept extensions at ``pos``: row ``(s, b)`` extends row
        ``sel_p[s, b]`` of position ``src_pos[s, b]``."""
        S, B = self.S, self.B
        flat = (src_pos & (_RING - 1)) * B + sel_p  # [S, B] ring row * B + path
        table = self.table.reshape(S, _RING * B, self.T1)[self._s_idx, flat]
        depth = self.depth.reshape(S, _RING * B)[self._s_idx, flat] + 1
        own = (self.rows + pos * S * B).reshape(S, B, 1)
        table = table.scatter(2, depth[..., None], own)
        return PathRows(self, pos, table, depth)

    def write(self, pos: int, rows: PathRows) -> None:
        """Keep the rows' tables and depths for the frames that extend them
        (their latents are in the store already)."""
        self.table[:, pos & (_RING - 1)] = rows.full_table
        self.depth[:, pos & (_RING - 1)] = rows.depth

    def stats(self) -> Optional[Dict[str, torch.Tensor]]:
        """The chunk's device counters (int32), or None while not counting."""
        if self.counters is None:
            return None
        out = dict(self.counters)
        if self.expert_rows is not None:
            out["moe.expert_rows_max"] = self.expert_rows.amax().reshape(())
            out["moe.expert_rows_min"] = self.expert_rows.amin().reshape(())
        return out
