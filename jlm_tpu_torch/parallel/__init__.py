"""Parallelism on ``torch.distributed``: the ``(data, vocab)`` mesh of
ranks, vocab (tensor) and data parallelism, one process per rank.

Counterpart of :mod:`jlm_tpu.parallel`:

- ``vocab`` axis — the output head's columns split over ranks (every
  D-softmax block column-sharded); per-rank logsumexp partials and
  candidate logits exchanged so every rank's beam stays globally
  consistent;
- ``data`` axis — independent lattice streams / training batch rows.

``mesh`` (layout and bootstrap), ``comm`` (the collectives, all built on
``all_reduce``, and :func:`~jlm_tpu_torch.parallel.comm.spawn`),
``sharded_head`` (sharded decode forwards, ``sharded_topk``,
``vocab_parallel_nll``), ``train_step`` (the sharded training step),
``comms_model`` (the analytic traffic model), ``seq_pipeline`` (the
time-block pipeline over a ``('seq',)`` mesh: the BPTT window's time axis
over the ranks, carries handed to the next rank).
"""

from jlm_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    SeqMesh,
    make_mesh,
    make_seq_mesh,
    multihost_init,
)
from jlm_tpu_torch.parallel.sharded_head import (  # noqa: F401
    make_sharded_forward,
    shard_params,
    sharded_topk,
    vocab_parallel_nll,
)
