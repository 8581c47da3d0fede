"""repro_torch: the gain-cell memory compiler on PyTorch and CUDA.

A port of the JAX package ``repro`` that imports neither ``jax`` nor
``repro``. This slice covers the nominal compiler flow: physics
(``core``) -> ``characterize_batch`` -> ``api.DesignTable`` ->
``api.explore`` (the paper's Table 2), with the retention transient running
in the hand-written CUDA kernel of ``kernels/csrc/retention.cu``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (see ``repro_torch.device``).
"""
