"""jlm_tpu_torch — the PyTorch/CUDA port of :mod:`jlm_tpu` for one NVIDIA H100.

The port imports nothing of ``jlm_tpu``: it keeps its own copies of the
host modules it needs (``config``, ``data``, ``decoder.lattice``, the
``native`` lattice builder, ``oracle``, ``ops.quant``, ``init_params`` in
``models.params``, ``eval``, ``utils.logging`` and
``train.import_reference``), at the paths of the originals.  Module names follow
the JAX package so each counterpart is easy to find.  Importing the package builds and loads no
kernel: ``ops/_build.py`` compiles ``csrc/*.cu`` on the first launch.

Layer map (serving: streaming batched beam-10 conversion; training:
truncated BPTT, on one device or a mesh of ranks):

- ``decoder.engine`` — ``BeamDecoder`` (``decode``, ``decode_batch``,
  ``decode_stream``): host lattice build and pack, one device search per
  chunk (a Python frame loop with no host sync), device backtrack, one
  result fetch per chunk; ``decode_long`` for inputs past
  ``max_kana_len`` (overlap-save chunks seeded on the device).
- ``scripts``        — the conversion, evaluation and export CLIs
  (``python -m jlm_tpu_torch.scripts.<name>``).
- ``parallel``       — vocab and data parallelism on ``torch.distributed``,
  one process per rank: the ``(data, vocab)`` mesh, the collectives, the
  sharded decode forwards, ``sharded_topk``, the vocab-parallel CE and
  the sharded training step.
- ``train``          — ``Trainer`` / ``train_lm`` (``python -m
  jlm_tpu_torch.train``): BPTT loop, optimizer chain (``train.optim``),
  checkpoints in the reference's format (``train.checkpoint``).
- ``models.lstm``    — the plain LSTM LM functions (embed, cell step, full
  and D-softmax head, log-softmax, ``forward_hidden``): the fp32 parity
  forward, the training forward and every kernel's reference.
- ``models.heads``   — training losses: full softmax (fused or plain) and
  sampled softmax.
- ``models.params``  — numpy parameter pytree / npz checkpoint -> tensors.
- ``ops``            — the hand-written Hopper kernels, each beside its plain
  version: ``project`` (head normalizer with online logsumexp, and
  candidate extraction), ``lstm_cell`` (fused cell step), ``cand_dot``
  (per-sentence candidate dots), ``frame_step`` (fused cell + candidate
  dots), ``softmax_ce`` (fused softmax cross-entropy forward and
  backward), ``lstm_scan`` (the LSTM over a BPTT window).
"""
