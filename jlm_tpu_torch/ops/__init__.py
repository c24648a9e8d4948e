"""Hand-written CUDA kernels for Hopper (``csrc/``), each with its plain
PyTorch version: a CPU tensor runs the plain version, a CUDA tensor the
kernel."""
