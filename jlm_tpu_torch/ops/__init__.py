"""Hand-written CUDA kernels for Hopper (``csrc/``), each with its plain
PyTorch version: a CPU tensor runs the plain version, a CUDA tensor the
kernel.  Every TPU kernel of the JAX package has its counterpart here:
``project`` (the head's online logsumexp and candidate extraction, every
weight mode, full or D-softmax head), ``lstm_cell`` (fused cell step),
``cand_dot`` (per-sentence candidate dots), ``frame_step`` (the fused cell
+ candidate dots of one frame), ``softmax_ce`` (fused softmax
cross-entropy forward and backward, bf16 or fp32 compute) and
``lstm_scan`` (the LSTM over a BPTT window, forward and backward).
``adam`` replaces no TPU kernel: the optimizer's global norm and its fused
clip + Adam update over every leaf, for ``train.optim``."""
