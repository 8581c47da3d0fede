"""Hand-written CUDA kernels (``csrc/``), their build, their wrappers, and
their plain PyTorch versions (``ref``)."""
