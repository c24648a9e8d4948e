"""Next-word prediction: the LM as a suggestion engine.

Counterpart of :mod:`jlm_tpu.decoder.suggest` on one device: ``Suggester``
feeds ``<eos>`` and the committed context through the LSTM and returns the
top-k next words of the log-softmax at the last real position.  With
``mesh=`` (a ``parallel.Mesh``; every rank of the vocab group calls
``suggest`` alike) each rank keeps its own head columns, normalizes them
by the global logsumexp (one MAX and one SUM over the vocab group) and
``sharded_topk`` picks the top k: the same ids as the unsharded
``topk_stable``, ties included.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from jlm_tpu_torch.config import Config, EOS_ID
from jlm_tpu_torch.data.corpus import Vocab
from jlm_tpu_torch.decoder.engine import _set_fp32_matmuls, lstm_only, topk_stable
from jlm_tpu_torch.models.lstm import embed, head_logits, initial_state, log_softmax, lstm_step
from jlm_tpu_torch.models.params import params_to_torch, resolve_device


class Suggester:
    """Top-k next words of a committed context.  ``device`` defaults to the
    card (raises without a GPU); with ``mesh`` it runs on the mesh's device
    (a ``device`` naming another raises).  ``precision="highest"`` keeps
    the products in true fp32."""

    def __init__(self, params, vocab: Vocab, config: Config, mesh=None,
                 precision: str = "highest", *, device="cuda"):
        lstm_only("Suggester", config=config)
        self.mesh = mesh if mesh is not None and mesh.vocab > 1 else None
        if mesh is not None:
            from jlm_tpu_torch.parallel.mesh import mesh_device

            device = mesh_device(mesh, device)
        self.device = resolve_device(device)
        self.params = params_to_torch(params, self.device)
        if self.mesh:
            from jlm_tpu_torch.parallel.sharded_head import local_ids, shard_params

            self.params = shard_params(self.params, config, self.mesh)
            self._ids = local_ids(config, self.mesh).to(self.device)
        self.vocab = vocab
        self.config = config
        if precision == "highest":
            _set_fp32_matmuls()

    @staticmethod
    def _bucket(n: int) -> int:
        """Context lengths pad to power-of-two buckets (min 4), as the
        reference's compiled scan does."""
        b = 4
        while b < n:
            b *= 2
        return b

    def _logp(self, ids: torch.Tensor, n_real: int) -> torch.Tensor:
        """``<eos>`` then the padded context through the LSTM; the log-probs
        ``[V]`` at position ``n_real`` (the padding steps run, unread);
        under a mesh those of this rank's columns ``[V_l]``."""
        seq = torch.cat([torch.full((1,), EOS_ID, dtype=torch.long, device=self.device), ids])
        state = initial_state(self.config, 1, self.device)
        xs = embed(self.params, seq)
        for t in range(seq.shape[0]):
            h_top, state = lstm_step(self.params, self.config, xs[t:t + 1], state)
            if t == n_real:
                h_last = h_top
        logits = head_logits(self.params, self.config, h_last)
        if self.mesh:
            from jlm_tpu_torch.parallel.sharded_head import merge_lse

            return (logits - merge_lse(logits, None, self.mesh.vocab_group)[:, None])[0]
        return log_softmax(logits)[0]

    def top_k(self, context_ids: Sequence[int], k: int = 5) -> Tuple[List[int], List[float]]:
        """The ids and log-probs of the top-k next words of the context,
        ties in the lower id first."""
        ids = list(context_ids)
        n = len(ids)
        ids += [EOS_ID] * (self._bucket(max(n, 1)) - n)
        logp = self._logp(torch.tensor(ids, dtype=torch.long, device=self.device), n)
        if self.mesh:
            from jlm_tpu_torch.parallel import sharded_topk

            vals, idx = sharded_topk(self.mesh, logp[None], k, self._ids)
        else:
            vals, idx = topk_stable(logp[None], k)
        return idx[0].tolist(), vals[0].tolist()

    def suggest(self, context_ids: Sequence[int], k: int = 5) -> List[Tuple[str, float]]:
        """Top-k ``(display, logp)`` continuations of the committed context."""
        ids, vals = self.top_k(context_ids, k)
        nv = len(self.vocab)  # the model's vocab may be padded past the token list
        return [(self.vocab.display(i) if i < nv else "<pad>", v) for i, v in zip(ids, vals)]
