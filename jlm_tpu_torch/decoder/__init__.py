"""Batched beam-Viterbi search on the device (``engine``)."""
